"""Launch shapes of one redesigned kernel against each other on the
card, in turns.

    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_tiles_pts [--font synth_heavy] --variant r1,r=1 --variant r2,r=2
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_grid_flat --variant t64,threads=64 --variant t128,threads=128
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_min_field_padded --variant a,threads=256,r=4 --variant b,threads=128,r=2
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_min_field_pts --variant r1,r=1 --variant r4,r=4
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_min_field_padded_bwd --variant a,threads=128 --variant b,warps=2
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_min_field_bwd --variant t128,threads=128 --parent build/parent
    python -m versatiles_glyphs_tpu_torch.tools.kernel_turns \\
        --kernel sdf_tiles_pts_acc --variant l2,split=2 --variant l4,split=4

``csrc/sdf_tiles_pts.cu`` and ``csrc/sdf_tiles_flat.cu`` are compiled
for one and two pixels a thread, ``csrc/sdf_min_field_pts.cu`` for one,
two and four, ``csrc/sdf_grid_flat.cu`` takes any block of whole warps
up to `sdf_cuda.GRID_THREADS_MAX`, ``csrc/sdf_min_field_padded.cu`` any
up to `sdf_cuda.PADDED_THREADS_MAX` with one to four pixels a thread,
``csrc/sdf_min_field_padded_bwd.cu`` any block of whole warps with
any number of them a glyph that divides the block's,
``csrc/sdf_min_field_bwd.cu`` any block of whole warps, and
``csrc/sdf_tiles_pts_acc.cu`` 1 to 32 threads a pixel (a power of two,
at most 1,024 threads a block); the launchers keep the shape that was
fastest. This tool measures that choice again, on the same card in the
same process. A variant is a label and options: ``r=`` pixels a thread
(the tile kernels, the min fields), ``threads=`` block size (the grid
kernel, both backwards) or the most threads a block (the padded min
field, through `sdf_cuda.padded_launch_shape`), ``warps=`` warps a glyph
(the padded backward, through `sdf_cuda.padded_bwd_launch_shape`),
``split=`` threads a pixel (the split tile kernel), ``lanes=`` segment
lanes a pass (the flat backward, through
`sdf_cuda.flat_bwd_launch_shape`); without an option, and with no
variant at all, the launcher's own shape. ``--parent DIR`` adds a
variant ``parent``: the package of another checkout unpacked at DIR
(``git archive``), imported under another name, its kernel built from
its own sources into DIR's ``build/`` and launched by its own launcher,
so that a redesign is timed against the body it replaces in one process.
Each runs on a synthesized font: the render kernels on its
first render group (the point-chain kernel and its split variant on the
wire the renderer uses, the flat tile kernel on `pack_flat`'s soup and
its tile table, the grid kernel on `pack_flat`'s padded grid with TP =
min(1024, P_pad)), the fitting kernels on the font's whole fit batch at
depth 3 from a perturbed start (the flat min field on the flat
backend's plan, the flat backward on that plan with the flat min
field's argmin, the padded backward on the padded min field's argmin;
both backwards with a seeded cotangent that is not masked past w·h).
Each is held against the kernel's plain version: bytes, or d² bits,
winding and argmin; a backward within 1e-4 of the largest gradient (the
plain version's ``index_add_`` sums in no fixed order on the card),
bit-identical on a second launch and bit-identical to the sum in pixel
order (`sdf_torch.min_field_bwd_pts_ordered` always,
`sdf_torch.min_field_padded_bwd_ordered` with one warp a glyph). Each
is timed in turns: the variants in order, then in reverse order (CUDA
events over many launches, ``ms``; and the same launches replayed from a
CUDA graph, ``graph_ms``, the card's time where the host cannot enqueue
launches as fast as the card runs them). It prints what ptxas reported
of the kernel (registers, spills) and, with ``cuobjdump`` at hand, its
f32 instruction counts and the instruction mix of each of its loops.
JSON lines. It runs on the first CUDA device and raises without one.
`main` returns the measurements as a dictionary.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

import numpy as np
import torch

from ..constants import CUTOFF, SDF_RADIUS
from ..device import cuda_device
from . import work
from .roofline import (
    FONTS, REPS, TP, emit, first_group, font_preps, graph_ms, group_work, nvidia_smi_line,
    sass_counts, sass_loops, time_ms,
)

# kernel -> the options its variants take
KERNELS = {
    "sdf_tiles_pts": ("r",),
    "sdf_grid_flat": ("threads",),
    "sdf_tiles_flat": ("r",),
    "sdf_min_field_padded": ("threads", "r"),
    "sdf_min_field_pts": ("r",),
    "sdf_min_field_padded_bwd": ("threads", "warps"),
    "sdf_min_field_bwd": ("threads", "lanes"),
    "sdf_tiles_pts_acc": ("split",),
}
OPTIONS = ("r", "threads", "warps", "split", "lanes")
FIT_DEPTH = 3
FIT_PERTURB = 0.35  # pixels


def parse_variant(spec: str) -> dict:
    """``label[,r=N][,threads=N][,warps=N][,split=N][,lanes=N]`` as a
    dictionary."""
    label, *opts = spec.split(",")
    out = {"label": label, **dict.fromkeys(OPTIONS)}
    for opt in opts:
        key, _, value = opt.partition("=")
        if key not in OPTIONS or not value.isdigit():
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

    if kernel in ("sdf_min_field_padded", "sdf_min_field_pts", "sdf_min_field_padded_bwd",
                  "sdf_min_field_bwd"):
        from ..models import fitting
        from ..models.glyph_model import curves_to_segments
        from ..utils.synth_font import synth_fit_batch

        n, first_cp, seed, quads = FONTS[font]
        batch = synth_fit_batch(n, first_cp, seed=seed, quads=quads, depth=FIT_DEPTH,
                                perturb=FIT_PERTURB)
    if kernel in ("sdf_min_field_pts", "sdf_min_field_bwd"):
        fitter = fitting.FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
        params, _, db = fitter.init(batch)
        with torch.no_grad():
            pts = fitting.flat_chain_points(params["curves"], params["translate"], FIT_DEPTH,
                                            db["chunk_map"]).contiguous()
        words, tmeta = db["plan_words"], db["plan_tmeta"]
        shape = {"glyphs": n, "lanes": int(pts.shape[1]), "tiles": int(tmeta.shape[1]), "TP": TP,
                 "pairs": work.live_pairs(tmeta.cpu().numpy(), words.cpu().numpy(), TP)}
        if kernel == "sdf_min_field_pts":
            return (pts, words, tmeta), shape, sdf_torch.min_field_pts(pts, words, tmeta, TP)
        from ..ops import sdf_cuda

        am = sdf_cuda.launch_min_field_pts(pts, words, tmeta, TP)[2]  # the forward kernel's
        ct = torch.randn(am.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        i = tmeta[6][:, None] + torch.arange(TP, device=dev)[None, :]
        shape["argmin_pixels"] = int(((i < (tmeta[2] * tmeta[3])[:, None])
                                      & (am != sdf_torch._BIGI)).sum())
        return (pts, am, ct, tmeta), shape, (sdf_torch.min_field_bwd_pts(pts, am, ct, tmeta, TP),)
    if kernel in ("sdf_min_field_padded", "sdf_min_field_padded_bwd"):
        segs = curves_to_segments(torch.as_tensor(batch.curves0, device=dev), FIT_DEPTH).contiguous()
        mask = torch.as_tensor(np.repeat(batch.curve_mask, 2 ** FIT_DEPTH, axis=1), device=dev).float()
        meta = torch.as_tensor(batch.meta, dtype=torch.int32, device=dev)
        P = batch.target.shape[1]
        shape = {"glyphs": int(segs.shape[0]), "segments": int(segs.shape[1]), "P": P,
                 "pairs": P * int((mask != 0).sum())}
        if kernel == "sdf_min_field_padded":
            return (segs, mask, meta, P), shape, sdf_torch.min_field_padded(segs, mask, meta, P)
        from ..ops import sdf_cuda

        am = sdf_cuda.min_field_cuda_padded(segs, mask, meta, P)[2]  # the forward kernel's
        ct = torch.randn(am.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        shape["argmin_pixels"] = int((am != sdf_torch._BIGI).sum())
        return (segs, meta, am, ct), shape, (sdf_torch.min_field_padded_bwd(segs, meta, am, ct),)

    group = first_group(font_preps(font))
    if kernel in ("sdf_tiles_pts", "sdf_tiles_pts_acc"):
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


def import_parent(root: str, name: str = "vg_parent"):
    """The package of another checkout unpacked at ``root``, imported
    under the module name ``name`` (its kernels and native library build
    from its own sources into ``root/build/``)."""
    pkg_dir = os.path.join(os.path.abspath(root), "versatiles_glyphs_tpu_torch")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"),
            submodule_search_locations=[pkg_dir])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def parent_ops(root: str):
    """The ``ops.sdf_cuda`` and ``ops.legacy`` modules of `import_parent`."""
    import_parent(root)
    return (importlib.import_module("vg_parent.ops.sdf_cuda"),
            importlib.import_module("vg_parent.ops.legacy"))


def _launcher(kernel: str, variant: dict, inputs, ops=None):
    """A call that launches ``kernel`` at the variant's shape and returns
    its outputs as a tuple: the launcher of ``ops`` (this package's
    ``sdf_cuda`` and ``legacy`` modules, or `parent_ops`) where the
    variant names none, else the kernel's C entry point with the shape
    in the launcher's place."""
    if ops is None:
        from ..ops import legacy, sdf_cuda
    else:
        sdf_cuda, legacy = ops

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

    if kernel == "sdf_min_field_pts":
        pts, words, tmeta = inputs
        return lambda: sdf_cuda.launch_min_field_pts(pts, words, tmeta, TP, variant["r"])

    if kernel == "sdf_min_field_bwd":
        pts, am, ct, tmeta = inputs
        if not shaped:
            return lambda: (sdf_cuda.launch_min_field_bwd(pts, am, ct, tmeta, TP),)
        shape = sdf_cuda.flat_bwd_launch_shape(
            variant["threads"] or sdf_cuda.FLAT_BWD_THREADS, variant["lanes"])
        return lambda: (sdf_cuda.launch_min_field_bwd(pts, am, ct, tmeta, TP, shape),)

    if kernel == "sdf_tiles_pts_acc":
        pts, words, tmeta = inputs
        split = variant["split"] or sdf_cuda.ACC_SPLIT
        return lambda: (sdf_cuda.launch_tiles_pts_acc(pts, words, tmeta, TP, split),)

    if kernel == "sdf_min_field_padded_bwd":
        segs, meta, am, ct = inputs
        shape = sdf_cuda.padded_bwd_launch_shape(
            segs.shape[1], am.shape[1], variant["threads"] or sdf_cuda.PADDED_BWD_THREADS,
            variant["warps"])
        return lambda: (sdf_cuda.launch_min_field_padded_bwd(segs, meta, am, ct, shape),)

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


def backward_differs(kernel, fn, got, want, inputs, variant) -> dict:
    """A backward's checks of one variant: the largest difference from
    the plain version against 1e-4 of its largest magnitude, the
    elements whose bits differ on a second launch, and the elements
    whose bits differ from the sum in pixel order
    (`sdf_torch.min_field_bwd_pts_ordered`, or
    `sdf_torch.min_field_padded_bwd_ordered`, where 0 is asked of one
    warp a glyph only)."""
    from ..ops import sdf_cuda, sdf_torch

    err, scale = float((got[0] - want[0]).abs().max()), float(want[0].abs().max())
    rec = {"max_abs_err": err, "max_abs_plain": scale, "within_tolerance": err <= 1e-4 * scale,
           "bits_differ_on_rerun": values_differ(fn(), got), "warps_a_glyph": 1}
    if kernel == "sdf_min_field_bwd":
        ordered = (sdf_torch.min_field_bwd_pts_ordered(*inputs, TP),)
    else:
        segs, meta, am, ct = inputs
        rec["warps_a_glyph"] = sdf_cuda.padded_bwd_launch_shape(
            segs.shape[1], am.shape[1], variant["threads"] or sdf_cuda.PADDED_BWD_THREADS,
            variant["warps"])[1]
        ordered = (sdf_torch.min_field_padded_bwd_ordered(segs, meta, am, ct),)
    return rec | {"bits_differ_from_pixel_order": values_differ(got, ordered)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.kernel_turns",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="sdf_tiles_pts")
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL[,OPTION...]")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="also time the launcher of the checkout unpacked at DIR")
    args = ap.parse_args(argv)
    variants = [parse_variant(v) for v in args.variant] or [parse_variant("shipped")]
    for v in variants:
        for key in OPTIONS:
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
    plan = [(v, None) for v in variants]
    if args.parent:
        ops = parent_ops(args.parent)
        so_parent = ops[0]._build.build(args.kernel)
        emit({"tool": "kernel_turns", "kernel": args.kernel, "parent": args.parent,
              "so": os.path.basename(so_parent), "ptxas": _build.ptxas_report(so_parent)})
        plan.append((parse_variant("parent"), ops))
    for v, ops in plan:
        fn = _launcher(args.kernel, v, inputs, ops)
        got = fn()
        torch.cuda.synchronize()
        rec = {"tool": "kernel_turns", "kernel": args.kernel, "variant": v["label"],
               "options": {k: v[k] for k in OPTIONS if v[k]}}
        if args.kernel in ("sdf_min_field_padded_bwd", "sdf_min_field_bwd"):
            rec |= backward_differs(args.kernel, fn, got, want, inputs, v)
            differ = (not rec["within_tolerance"]) + rec["bits_differ_on_rerun"] + (
                rec["bits_differ_from_pixel_order"] if rec["warps_a_glyph"] == 1 else 0)
        else:
            differ = rec["values_differ_from_plain"] = values_differ(got, want)
        emit(rec)
        if differ:
            raise AssertionError(f"{args.kernel} ({v['label']}) differs from the plain version: {rec}")
        runs.append((v["label"], fn))

    order = runs + runs[::-1]

    def mean_of_turns(timer):
        turns = [(label, timer(fn, REPS)) for label, fn in order]
        return turns, {label: (turns[i][1] + turns[len(order) - 1 - i][1]) / 2
                       for i, (label, _) in enumerate(runs)}

    turns, ms = mean_of_turns(time_ms)
    graph_turns, graph = mean_of_turns(graph_ms)
    res = {"kernel": args.kernel, "font": args.font, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line(), **shape,
           "nonzero_values": int((want[0] != 0).sum()),
           "turns_ms": [[label, t] for label, t in turns], "ms": ms,
           "graph_turns_ms": [[label, t] for label, t in graph_turns], "graph_ms": graph}
    emit({"tool": "kernel_turns", **res})
    return res


if __name__ == "__main__":
    main()
