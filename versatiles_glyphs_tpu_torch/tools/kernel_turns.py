"""Launch shapes of one render kernel against each other on the card, in
turns.

    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_tiles_pts [--font synth_heavy] --variant r1,r=1 --variant r2,r=2
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_grid_flat --variant t64,threads=64 --variant t128,threads=128

``csrc/sdf_tiles_pts.cu`` is compiled for one and two pixels a thread
and ``csrc/sdf_grid_flat.cu`` takes any block of whole warps up to
`sdf_cuda.GRID_THREADS_MAX`; the launchers keep the shape that was
fastest on both synthesized fonts. This tool measures that choice again,
on the same card in the same process. A variant is a label and an
option: ``r=`` pixels a thread of the tile kernel, ``threads=`` block
size of the grid kernel; without an option, and with no variant at all,
the launcher's own shape. Each runs on a synthesized font's first render
group (the tile kernel on the wire the renderer uses, the grid kernel on
`pack_flat`'s padded grid with TP = min(1024, P_pad)), is held byte for
byte against the kernel's plain version, and is timed in turns: the
variants in order, then in reverse order (CUDA events over many
launches). It prints what ptxas reported of the kernel (registers,
spills) and, with ``cuobjdump`` at hand, its f32 instruction counts and
the instruction mix of each of its loops over staged segments. JSON
lines. It runs on the first CUDA device and raises without one. `main`
returns the measurements as a dictionary.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..constants import CUTOFF, SDF_RADIUS
from ..device import cuda_device
from .roofline import (
    FONTS, REPS, TP, emit, first_group, font_preps, group_work, nvidia_smi_line, sass_counts,
    sass_loops, time_ms,
)

KERNELS = ("sdf_tiles_pts", "sdf_grid_flat")


def parse_variant(spec: str) -> dict:
    """``label[,r=N][,threads=N]`` as a dictionary."""
    label, *opts = spec.split(",")
    out = {"label": label, "r": None, "threads": None}
    for opt in opts:
        key, _, value = opt.partition("=")
        if key not in ("r", "threads") or not value.isdigit():
            raise ValueError(f"variant {spec!r}: unknown option {opt!r}")
        out[key] = int(value)
    if not label:
        raise ValueError(f"variant {spec!r}: no label")
    return out


def _launcher(kernel: str, variant: dict, inputs):
    """A call that launches ``kernel`` at the variant's shape: the
    package's launcher where the variant names none, else the kernel's C
    entry point with the shape in the launcher's place."""
    from ..ops import legacy, sdf_cuda

    scale = 256.0 / SDF_RADIUS
    if kernel == "sdf_tiles_pts":
        pts, words, tmeta = inputs
        if variant["r"] is None:
            return lambda: sdf_cuda.launch_tiles_pts(pts, words, tmeta, TP)
        shape, args = (tmeta.shape[1], TP), (
            pts.data_ptr(), pts.shape[1], words.data_ptr(), tmeta.data_ptr(), tmeta.shape[1], TP,
            variant["r"])
    else:
        flat, meta, P, tp = inputs
        if variant["threads"] is None:
            return lambda: legacy.launch_grid_flat(flat, meta, P, tp)
        shape, args = (meta.shape[0], P), (
            flat.data_ptr(), flat.shape[1], meta.data_ptr(), meta.shape[0], P, tp,
            legacy.grid_launch_shape(meta.shape[0], P, variant["threads"])[0])

    def launch():
        out = torch.empty(shape, dtype=torch.uint8, device=inputs[0].device)
        sdf_cuda._launch(kernel, out.device, *args, scale, CUTOFF, out.data_ptr())
        return out

    return launch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.kernel_turns",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="sdf_tiles_pts")
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL[,OPTION...]")
    args = ap.parse_args(argv)
    variants = [parse_variant(v) for v in args.variant] or [parse_variant("shipped")]

    dev = cuda_device()
    from ..ops import _build, sdf_torch
    from ..render.batch import pack_flat, wire_to_device

    group = first_group(font_preps(args.font))
    if args.kernel == "sdf_tiles_pts":
        q16 = all(p.q16_ok for p in group)
        w = group_work(group, dtype=np.int16 if q16 else np.float32, arena_tag="_turns")
        pts, words, tmeta = wire_to_device((w["pts"], w["words"], w["tmeta"]), dev)
        if q16:
            pts = sdf_torch.dequantize(pts)
        inputs = (pts, words, tmeta)
        shape = {"wire": "i16" if q16 else "f32", "tiles": w["tiles"], "TP": TP, "pairs": w["pairs"]}
        want = sdf_torch.render_tiles_pts(pts, words, tmeta, TP)
    else:
        flat, meta, P = pack_flat(group)
        flat, meta = wire_to_device((flat, meta[: len(group)]), dev)
        tp = min(1024, P)
        inputs = (flat, meta, P, tp)
        shape = {"P": P, "TP": tp, "lanes": int(flat.shape[1])}
        want = sdf_torch.render_grid_flat(flat, meta, P, tp)

    so = _build.build(args.kernel)
    emit({"tool": "kernel_turns", "kernel": args.kernel, "so": os.path.basename(so),
          "ptxas": _build.ptxas_report(so), "sass": sass_counts(so)[0],
          "sass_loops": sass_loops(so)[0]})
    runs = []
    for v in variants:
        fn = _launcher(args.kernel, v, inputs)
        got = fn()
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        emit({"tool": "kernel_turns", "kernel": args.kernel, "variant": v["label"],
              "options": {k: v[k] for k in ("r", "threads") if v[k]},
              "bytes_differ_from_plain": differ})
        if differ:
            raise AssertionError(f"{args.kernel} ({v['label']}) differs from the plain version "
                                 f"on {differ} bytes")
        runs.append((v["label"], fn))

    order = runs + runs[::-1]
    turns = [(label, time_ms(fn, REPS)) for label, fn in order]
    ms = {label: (turns[i][1] + turns[len(order) - 1 - i][1]) / 2 for i, (label, _) in enumerate(runs)}
    res = {"kernel": args.kernel, "font": args.font, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line(), "glyphs": len(group), **shape,
           "nonzero_bytes": int((want > 0).sum()),
           "turns_ms": [[label, t] for label, t in turns], "ms": ms}
    emit({"tool": "kernel_turns", **res})
    return res


if __name__ == "__main__":
    main()
