"""Launch shapes of one redesigned kernel against each other on the
card, in turns.

    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_tiles_pts [--font synth_heavy] --variant r1,r=1 --variant r2,r=2
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_grid_flat --variant t64,threads=64 --variant t128,threads=128
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_min_field_padded --variant a,threads=256,r=4 --variant b,threads=128,r=2

``csrc/sdf_tiles_pts.cu`` and ``csrc/sdf_tiles_flat.cu`` are compiled
for one and two pixels a thread, ``csrc/sdf_grid_flat.cu`` takes any
block of whole warps up to `sdf_cuda.GRID_THREADS_MAX`, and
``csrc/sdf_min_field_padded.cu`` any up to `sdf_cuda.PADDED_THREADS_MAX`
with one to four pixels a thread; the launchers keep the shape that was
fastest. This tool measures that choice again, on the same card in the
same process. A variant is a label and options: ``r=`` pixels a thread
(the tile kernels, the padded min field), ``threads=`` block size (the
grid kernel) or the most threads a block (the padded min field, through
`sdf_cuda.padded_launch_shape`); without an option, and with no variant
at all, the launcher's own shape. Each runs on a synthesized font: the
render kernels on its first render group (the point-chain kernel on the
wire the renderer uses, the flat tile kernel on `pack_flat`'s soup and
its tile table, the grid kernel on `pack_flat`'s padded grid with TP =
min(1024, P_pad)), the padded min field on the font's whole fit batch
at depth 3 from a perturbed start. Each is held against the kernel's
plain version (bytes, or d² bits, winding and argmin) and is timed in
turns: the variants in order, then in reverse order (CUDA events over
many launches). It prints what ptxas reported of the kernel (registers,
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

# kernel -> the options its variants take
KERNELS = {
    "sdf_tiles_pts": ("r",),
    "sdf_grid_flat": ("threads",),
    "sdf_tiles_flat": ("r",),
    "sdf_min_field_padded": ("threads", "r"),
}
FIT_DEPTH = 3
FIT_PERTURB = 0.35  # pixels


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


def _inputs(kernel: str, font: str, dev):
    """(the kernel's inputs on the card, what to print of their shape,
    the plain version's outputs as a tuple) for ``font``."""
    from ..ops import sdf_torch
    from ..render.batch import pack_flat, plan_tiles, tile_starts, wire_to_device

    if kernel == "sdf_min_field_padded":
        from ..models.glyph_model import curves_to_segments
        from ..utils.synth_font import synth_fit_batch

        n, first_cp, seed, quads = FONTS[font]
        batch = synth_fit_batch(n, first_cp, seed=seed, quads=quads, depth=FIT_DEPTH,
                                perturb=FIT_PERTURB)
        segs = curves_to_segments(torch.as_tensor(batch.curves0, device=dev), FIT_DEPTH).contiguous()
        mask = torch.as_tensor(np.repeat(batch.curve_mask, 2 ** FIT_DEPTH, axis=1), device=dev).float()
        meta = torch.as_tensor(batch.meta, dtype=torch.int32, device=dev)
        P = batch.target.shape[1]
        shape = {"glyphs": int(segs.shape[0]), "segments": int(segs.shape[1]), "P": P,
                 "pairs": P * int((mask != 0).sum())}
        return (segs, mask, meta, P), shape, sdf_torch.min_field_padded(segs, mask, meta, P)

    group = first_group(font_preps(font))
    if kernel == "sdf_tiles_pts":
        q16 = all(p.q16_ok for p in group)
        w = group_work(group, dtype=np.int16 if q16 else np.float32, arena_tag="_turns")
        pts, words, tmeta = wire_to_device((w["pts"], w["words"], w["tmeta"]), dev)
        if q16:
            pts = sdf_torch.dequantize(pts)
        shape = {"wire": "i16" if q16 else "f32", "tiles": w["tiles"], "TP": TP, "pairs": w["pairs"]}
        return (pts, words, tmeta), shape, (sdf_torch.render_tiles_pts(pts, words, tmeta, TP),)
    flat, meta, P = pack_flat(group)
    shape = {"glyphs": len(group), "lanes": int(flat.shape[1])}
    if kernel == "sdf_tiles_flat":
        T = tile_starts(meta, len(group), TP)[1]
        tmeta = plan_tiles(group, meta, TP, T_pad=T)[0].T
        flat, tmeta = wire_to_device((flat, tmeta), dev)
        shape |= {"tiles": T, "TP": TP}
        return (flat, tmeta), shape, (sdf_torch.render_tiles_flat(flat, tmeta, TP),)
    flat, meta = wire_to_device((flat, meta[: len(group)]), dev)
    tp = min(1024, P)
    shape |= {"P": P, "TP": tp}
    return (flat, meta, P, tp), shape, (sdf_torch.render_grid_flat(flat, meta, P, tp),)


def _launcher(kernel: str, variant: dict, inputs):
    """A call that launches ``kernel`` at the variant's shape and returns
    its outputs as a tuple: the package's launcher where the variant
    names none, else the kernel's C entry point with the shape in the
    launcher's place."""
    from ..ops import legacy, sdf_cuda

    shaped = any(variant[key] is not None for key in KERNELS[kernel])
    if kernel == "sdf_min_field_padded":
        segs, mask, meta, P = inputs
        if not shaped:
            return lambda: sdf_cuda.launch_min_field_padded(segs, mask, meta, P)
        nt, r, _ = sdf_cuda.padded_launch_shape(
            P, variant["threads"] or sdf_cuda.PADDED_THREADS,
            variant["r"] or sdf_cuda.PADDED_PIXELS_PER_THREAD)

        def launch_fields():
            d2 = torch.empty((segs.shape[0], P), dtype=torch.float32, device=segs.device)
            wn, am = (torch.empty_like(d2, dtype=torch.int32) for _ in range(2))
            sdf_cuda._launch(kernel, segs.device, segs.data_ptr(), mask.data_ptr(), *segs.shape[:2],
                             meta.data_ptr(), P, nt, r, d2.data_ptr(), wn.data_ptr(), am.data_ptr())
            return d2, wn, am

        return launch_fields

    if kernel == "sdf_tiles_pts":
        pts, words, tmeta = inputs
        if not shaped:
            return lambda: (sdf_cuda.launch_tiles_pts(pts, words, tmeta, TP),)
        shape, args = (tmeta.shape[1], TP), (
            pts.data_ptr(), pts.shape[1], words.data_ptr(), tmeta.data_ptr(), tmeta.shape[1], TP,
            variant["r"])
    elif kernel == "sdf_tiles_flat":
        flat, tmeta = inputs
        if not shaped:
            return lambda: (legacy.launch_tiles_flat(flat, tmeta, TP),)
        shape, args = (tmeta.shape[1], TP), (
            flat.data_ptr(), flat.shape[1], tmeta.data_ptr(), tmeta.shape[1], TP, variant["r"])
    else:
        flat, meta, P, tp = inputs
        if not shaped:
            return lambda: (legacy.launch_grid_flat(flat, meta, P, tp),)
        shape, args = (meta.shape[0], P), (
            flat.data_ptr(), flat.shape[1], meta.data_ptr(), meta.shape[0], P, tp,
            legacy.grid_launch_shape(meta.shape[0], P, variant["threads"])[0])

    def launch_bytes():
        out = torch.empty(shape, dtype=torch.uint8, device=inputs[0].device)
        sdf_cuda._launch(kernel, out.device, *args, 256.0 / SDF_RADIUS, CUTOFF, out.data_ptr())
        return (out,)

    return launch_bytes


def values_differ(got, want) -> int:
    """Elements of the output tuples that differ, floats by their bits."""
    if len(got) != len(want) or any(g.shape != w.shape or g.dtype != w.dtype
                                    for g, w in zip(got, want)):
        raise AssertionError("kernel and plain version differ in shape or dtype")
    bits = {torch.float32: torch.int32}
    return sum(int((g.view(bits.get(g.dtype, g.dtype)) != w.view(bits.get(w.dtype, w.dtype))).sum())
               for g, w in zip(got, want))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.kernel_turns",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="sdf_tiles_pts")
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL[,OPTION...]")
    args = ap.parse_args(argv)
    variants = [parse_variant(v) for v in args.variant] or [parse_variant("shipped")]
    for v in variants:
        for key in ("r", "threads"):
            if v[key] is not None and key not in KERNELS[args.kernel]:
                raise ValueError(f"variant {v['label']!r}: {args.kernel} takes no {key}=")

    dev = cuda_device()
    from ..ops import _build

    inputs, shape, want = _inputs(args.kernel, args.font, dev)
    so = _build.build(args.kernel)
    emit({"tool": "kernel_turns", "kernel": args.kernel, "so": os.path.basename(so),
          "ptxas": _build.ptxas_report(so), "sass": sass_counts(so)[0],
          "sass_loops": sass_loops(so)[0]})
    runs = []
    for v in variants:
        fn = _launcher(args.kernel, v, inputs)
        got = fn()
        torch.cuda.synchronize()
        differ = values_differ(got, want)
        emit({"tool": "kernel_turns", "kernel": args.kernel, "variant": v["label"],
              "options": {k: v[k] for k in ("r", "threads") if v[k]},
              "values_differ_from_plain": differ})
        if differ:
            raise AssertionError(f"{args.kernel} ({v['label']}) differs from the plain version "
                                 f"on {differ} values")
        runs.append((v["label"], fn))

    order = runs + runs[::-1]
    turns = [(label, time_ms(fn, REPS)) for label, fn in order]
    ms = {label: (turns[i][1] + turns[len(order) - 1 - i][1]) / 2 for i, (label, _) in enumerate(runs)}
    res = {"kernel": args.kernel, "font": args.font, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line(), **shape,
           "nonzero_values": int((want[0] > 0).sum()),
           "turns_ms": [[label, t] for label, t in turns], "ms": ms}
    emit({"tool": "kernel_turns", **res})
    return res


if __name__ == "__main__":
    main()
