"""The render tile kernel against its split variant on the card
(counterpart of the JAX package's ``scripts/kernel_ab.py``).

    python -m versatiles_glyphs_tpu_torch.tools.kernel_ab [--font synth_heavy] [--split 4]

``csrc/sdf_tiles_pts.cu``, the production kernel, gives a thread two
pixels of a tile, stages only a chunk's live segments as packed
records and takes the winding from a list of crossings for each bitmap
row of the tile; ``csrc/sdf_tiles_pts_acc.cu`` keeps the plain loop (a
validity test and a crossing test a pair) and gives a pixel to
``split`` threads that each walk every ``split``-th segment and reduce
once a tile. The variant is the independent implementation the
production kernel is held against, not a candidate to replace it
(`tools.kernel_turns` compares its launch shapes). On a
synthesized font's first render group, on the q16 wire the render
session uses, the tool prints as JSON lines whether the two outputs are
byte-equal and both times, taken in turns (production, variant,
variant, production; CUDA events over many launches). It runs on the
first CUDA device and raises without one. `main` returns the
measurements as a dictionary.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import cuda_device
from .roofline import FONTS, REPS, TP, emit, first_group, font_preps, group_work, nvidia_smi_line, time_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.kernel_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    ap.add_argument("--split", type=int, default=None, help="threads a pixel of the variant")
    args = ap.parse_args(argv)

    dev = cuda_device()
    from ..ops import sdf_cuda, sdf_torch
    from ..render.batch import wire_to_device

    split = args.split or sdf_cuda.ACC_SPLIT
    group = first_group(font_preps(args.font))
    q16 = all(p.q16_ok for p in group)
    w = group_work(group, dtype=np.int16 if q16 else np.float32, arena_tag="_ab")
    pts, words, tmeta = wire_to_device((w.pop("pts"), w.pop("words"), w.pop("tmeta")), dev)
    if q16:
        pts = sdf_torch.dequantize(pts)

    want = sdf_cuda.render_bitmaps_cuda_pts(pts, words, tmeta, TP)
    got = sdf_cuda.render_bitmaps_cuda_pts_acc(pts, words, tmeta, TP, split)
    torch.cuda.synchronize()
    differ = int((want != got).sum())

    def prod():
        return sdf_cuda.launch_tiles_pts(pts, words, tmeta, TP)

    def variant():
        return sdf_cuda.launch_tiles_pts_acc(pts, words, tmeta, TP, split)

    turns = [time_ms(f, REPS) for f in (prod, variant, variant, prod)]
    prod_ms = (turns[0] + turns[3]) / 2
    var_ms = (turns[1] + turns[2]) / 2
    res = {"font": args.font, "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi_line(), "wire": "i16" if q16 else "f32",
           "glyphs": w["glyphs"], "tiles": w["tiles"], "pairs": w["pairs"], "split": split,
           "byte_equal": differ == 0, "bytes_differ": differ,
           "nonzero_bytes": int((got > 0).sum()),
           "turns_ms": turns, "production_ms": prod_ms, "variant_ms": var_ms,
           "production_Mpix_per_s": w["npix"] / prod_ms / 1e3,
           "variant_Mpix_per_s": w["npix"] / var_ms / 1e3,
           "variant_speedup": prod_ms / var_ms}
    emit({"tool": "kernel_ab", **res})
    if differ:
        raise AssertionError(f"the split variant differs from the tile kernel on {differ} bytes")
    return res


if __name__ == "__main__":
    main()
