"""Work counts and bounds of the port's kernels: what a launch must
compute and move, from its inputs, and the least time the card could
take for it.

The operation counts are read off the sources, not assumed:

- `PAIR_F32_OPS`: one (pixel, live segment) pair of
  ``csrc/sdf_pair.cuh`` `SegChunk::d2_and_winding` and the running min
  around it. Subtractions ex, ey (2); num = ex·dx + ey·dy (3); num·l2inv
  (1); the clamp's max and min (2); qx = ex − tc·dx and qy (4); the
  crossing's three compares (3); cx = vx + (ey·dyinv)·dx (3); d² =
  qx² + qy² (3); the running ``fminf`` (1): 22. The build passes
  ``--fmad=false``, so a multiply and an add are two instructions and
  each counts as one operation. The winding's integer select and add,
  the shared-memory loads and the loop's own integer work are not f32
  operations and are left out.
- `MIN_FIELD_PAIR_F32_OPS`: the min-field kernels replace the running
  min by a compare (the argmin is an integer select): 22 all the same.
- `BYTE_PIXEL_F32_OPS`: `sdf_byte` once a pixel: square root, scale
  multiply, cutoff add, 255 − v, the clamp's two, + 0.5, floor: 8.
- `BWD_PIXEL_F32_OPS`: a backward kernel's work for one pixel with a
  live argmin: the pixel centre (4), ex and ey (2), `project` (10),
  g2 = 2·ct (1), g2·qx and g2·qy (2), the four accumulations, two of
  them with a multiply (6): 25.

The peaks are the published ones of an NVIDIA H100 SXM: 67 TFLOP/s of
f32 outside the tensor cores (a fused multiply-add counted as two) and
3.35 TB/s of device memory.
"""

from __future__ import annotations

import numpy as np

PAIR_F32_OPS = 22
MIN_FIELD_PAIR_F32_OPS = 22
BYTE_PIXEL_F32_OPS = 8
BWD_PIXEL_F32_OPS = 25

PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def live_segments(tmeta: np.ndarray, mask_words: np.ndarray | None = None) -> np.ndarray:
    """Live segments of each tile row's glyph, [T] i64: 0 for a row the
    kernels skip (pix_base ≥ w·h). ``tmeta`` is the [8, T] tile table.
    With ``mask_words`` (point-chain layout) a row's segments are the
    set mask bits among lanes [off, off + npts − 1); without (segment
    soup) they are the row's nseg."""
    tm = np.asarray(tmeta).astype(np.int64)
    live = tm[6] < tm[2] * tm[3]
    if mask_words is None:
        return np.where(live, tm[4], 0)
    bits = np.unpackbits(
        np.ascontiguousarray(np.asarray(mask_words)).view(np.uint8), bitorder="little"
    )
    cum = np.concatenate([[0], np.cumsum(bits, dtype=np.int64)])
    lo = np.clip(tm[5], 0, bits.size)
    hi = np.clip(tm[5] + np.maximum(tm[4] - 1, 0), 0, bits.size)
    return np.where(live, cum[hi] - cum[lo], 0)


def live_pairs(tmeta: np.ndarray, mask_words: np.ndarray | None, TP: int) -> int:
    """(pixel, live segment) pairs of a tile kernel's launch: TP times
    the live segments of every row that is not skipped."""
    return int(TP * live_segments(tmeta, mask_words).sum())


def live_tiles(tmeta: np.ndarray) -> int:
    tm = np.asarray(tmeta).astype(np.int64)
    return int((tm[6] < tm[2] * tm[3]).sum())


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(milliseconds, "operations" or "bytes"): the least time the card
    could take for ``ops`` f32 operations and ``nbytes`` bytes moved
    (each input read once, each output written once), the larger of the
    two at the published peaks, and which of them it is."""
    t_ops = ops / PEAK_F32_OPS_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tile_kernel_work(tmeta, mask_words, TP: int, n_lanes: int, lane_rows: int = 2,
                     out_bytes_per_pixel: int = 1,
                     pair_ops: int = PAIR_F32_OPS, pixel_ops: int = BYTE_PIXEL_F32_OPS) -> dict:
    """Pairs, f32 operations and bytes of one launch of a tile kernel.

    ``lane_rows`` f32 rows of ``n_lanes`` lanes are read (2: the point
    chain, 4: the segment soup), with the mask words where there are
    any and the tile table; ``out_bytes_per_pixel`` are written for
    every pixel of every row (1: bytes; 12: d², winding and argmin)."""
    T = int(np.asarray(tmeta).shape[1])
    pairs = live_pairs(tmeta, mask_words, TP)
    pixels = live_tiles(tmeta) * TP
    nbytes = 4 * lane_rows * n_lanes + 32 * T + out_bytes_per_pixel * T * TP
    if mask_words is not None:
        nbytes += 4 * int(np.asarray(mask_words).size)
    return {"tiles": T, "pairs": pairs, "pixels": pixels,
            "f32_ops": pairs * pair_ops + pixels * pixel_ops, "bytes": nbytes}
