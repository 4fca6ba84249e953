"""Frozen copy of the work counts of the port's `tools/work.py`: the
f32 operations of the least known count for the SDF function, and the
published peaks of one NVIDIA H100 SXM.

Counted here from each glyph's own segments and bitmap size, never
from a layout of the port's (its lanes, tiles or packing), so that a
redesign of the packing leaves the yardstick where it was:

- a (pixel, segment) pair: the 16 distance operations (the crossing
  test shared by the pixels of a bitmap row);
- a (bitmap row, segment): the 2 compares of the crossing test;
- a crossing a row finds: 4 operations, and 1 compare for each pixel of
  the row;
- a pixel: 8 operations of the byte (square root, scale, cutoff,
  255 − v, clamp, + 0.5, floor), or 25 of the fit's backward where it
  has a nearest segment.

A render reads each glyph's points once (8 bytes a point) and writes
each pixel's byte once; a min field reads its chain's points and
writes d², winding and argmin (12 bytes a pixel); its backward reads
argmin and cotangent (8 bytes a pixel) and writes the points' gradient.
"""

from __future__ import annotations

import numpy as np

ROW_SHARED_PAIR_F32_OPS = 16
ROW_TEST_F32_OPS = 2
CROSSING_F32_OPS = 4
CROSSING_PIXEL_F32_OPS = 1
BYTE_PIXEL_F32_OPS = 8
BWD_PIXEL_F32_OPS = 25

PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take for ``ops`` f32 operations
    and ``nbytes`` bytes at the published peaks."""
    return max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def crossed_rows(vy, wy, top_center, rows):
    """Bitmap rows q in [0, rows) whose centre line y = top_center − q
    lies in [min(vy, wy), max(vy, wy)): the rows a segment crosses."""
    lo, hi = np.minimum(vy, wy), np.maximum(vy, wy)
    q_max = np.minimum(np.floor(top_center - lo), rows - 1)
    q_min = np.maximum(np.floor(top_center - hi) + 1, 0)
    return np.maximum(q_max - q_min + 1, 0).astype(np.int64)


def field_work(segs, seg_glyph, width, height, y0) -> dict:
    """Pairs, row tests, crossings and crossing pixels of the min field
    of every glyph's segments ``segs`` [S, 4] (pixel units; ``seg_glyph``
    [S] their glyph) over its bitmap (``width``, ``height``, ``y0`` [G])."""
    width, height, y0 = (np.asarray(a, np.int64) for a in (width, height, y0))
    nseg = np.bincount(seg_glyph, minlength=len(width))
    pixels = width * height
    top = (y0 + height)[seg_glyph] - 0.5
    cross = crossed_rows(segs[:, 1], segs[:, 3], top, height[seg_glyph])
    return {"pixels": int(pixels.sum()), "segments": int(nseg.sum()),
            "pairs": int((pixels * nseg).sum()), "row_tests": int((height * nseg).sum()),
            "crossings": int(cross.sum()), "crossing_pixels": int((cross * width[seg_glyph]).sum())}


def _field_ops(w: dict) -> int:
    return (w["pairs"] * ROW_SHARED_PAIR_F32_OPS + w["row_tests"] * ROW_TEST_F32_OPS
            + w["crossings"] * CROSSING_F32_OPS + w["crossing_pixels"] * CROSSING_PIXEL_F32_OPS)


def render_work(segs, seg_glyph, width, height, y0) -> dict:
    """f32 operations and bytes of rendering every glyph's bitmap once."""
    w = field_work(segs, seg_glyph, width, height, y0)
    n_glyphs = len(np.asarray(width))
    w["f32_ops"] = _field_ops(w) + w["pixels"] * BYTE_PIXEL_F32_OPS
    # Points: a ring's segments share their ends (one more point than
    # segments a ring); at least the segments' count.
    w["bytes"] = 8 * (w["segments"] + n_glyphs) + w["pixels"]
    return w


def fit_step_work(segs, seg_glyph, width, height, y0, lanes: int) -> dict:
    """f32 operations and bytes of one fit step's min field and its
    backward: the chords ``segs`` of every glyph's chain, ``lanes``
    chain points in all."""
    w = field_work(segs, seg_glyph, width, height, y0)
    w["f32_ops"] = _field_ops(w) + w["pixels"] * BWD_PIXEL_F32_OPS
    w["bytes"] = 2 * 8 * lanes + (12 + 8) * w["pixels"]
    return w
