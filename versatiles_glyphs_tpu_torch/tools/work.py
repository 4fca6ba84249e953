"""Work counts and bounds of the port's kernels: what a launch must
compute and move, from its inputs, and the least time the card could
take for it.

The operation counts are read off the sources, not assumed:

- `PAIR_F32_OPS`: one (pixel, live segment) pair of the per-pair
  test, `d2_and_winding` of ``csrc/sdf_tiles_pts_acc.cu`` with
  `project` of ``csrc/sdf_pair.cuh``, and the running min around it. Subtractions ex, ey (2); num = ex·dx + ey·dy (3); num·l2inv
  (1); the clamp's max and min (2); qx = ex − tc·dx and qy (4); the
  crossing's three compares (3); cx = vx + (ey·dyinv)·dx (3); d² =
  qx² + qy² (3); the running ``fminf`` (1): 22. The build passes
  ``--fmad=false``, so a multiply and an add are two instructions and
  each counts as one operation. The winding's integer select and add,
  the shared-memory loads and the loop's own integer work are not f32
  operations and are left out.
  The min-field kernels replace the running min by a compare (the
  argmin is an integer select): the same counts.
- `BYTE_PIXEL_F32_OPS`: `sdf_byte` once a pixel: square root, scale
  multiply, cutoff add, 255 − v, the clamp's two, + 0.5, floor: 8.
- `BWD_PIXEL_F32_OPS`: a backward kernel's work for one pixel with a
  live argmin: the pixel centre (4), ex and ey (2), `project` (10),
  g2 = 2·ct (1), g2·qx and g2·qy (2), the four accumulations, two of
  them with a multiply (6): 25.

- `ROW_SHARED_PAIR_F32_OPS` and the three beside it: the least count
  known for the render function (`row_shared_work`). Of the 22, the
  crossing's three compares and the three operations of cx do not
  depend on the pixel's column except for the last compare, so they
  need be done once a (bitmap row, segment) and not once a pair; the
  redesigned render kernels (``csrc/sdf_tiles_pts.cu``,
  ``csrc/sdf_grid_flat.cu``, `SegRecords` of the header) do so. A pair
  keeps the 16 distance operations (`SegRecords::pair` without its
  winding block). A (row, segment) costs the two compares of the
  crossing test, `ROW_TEST_F32_OPS`; a crossing that the test finds
  costs ey and the three of cx, `CROSSING_F32_OPS` = 4, and one compare
  ``cx <= pxc`` for every pixel of its row, `CROSSING_PIXEL_F32_OPS`.
  The bound of a render or min-field kernel's row counts these,
  whatever the kernel executes: a bound must not count more than the function needs.

The peaks are the published ones of an NVIDIA H100 SXM: 67 TFLOP/s of
f32 outside the tensor cores (a fused multiply-add counted as two) and
3.35 TB/s of device memory.

`issue_rate_ops_per_s` is the yardstick of an instruction stream that
keeps every multiply and add apart (``--fmad=false``): an SM issues at
most `F32_LANES_PER_SM` f32 lane-instructions a clock, so such a
stream runs at most at SMs × 128 × the SM clock, half the published
peak (132 × 128 × 1,980 MHz = 33.45·10¹² against 67·10¹²). The card's SM
count and top clock are read on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np

PAIR_F32_OPS = 22
BYTE_PIXEL_F32_OPS = 8
BWD_PIXEL_F32_OPS = 25
ROW_SHARED_PAIR_F32_OPS = 16
ROW_TEST_F32_OPS = 2
CROSSING_F32_OPS = 4
CROSSING_PIXEL_F32_OPS = 1

PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128  # f32 instructions an SM issues a clock, one a lane of its four schedulers


def issue_rate_ops_per_s(sms: int, clock_mhz: float) -> float:
    """The most f32 instructions a second ``sms`` SMs at ``clock_mhz``
    issue: the roof of an un-fused instruction stream."""
    return sms * F32_LANES_PER_SM * clock_mhz * 1e6


def share_of_issue_rate(ops: float, ms: float, sms: int, clock_mhz: float) -> float:
    """``ops`` f32 instructions executed in ``ms`` milliseconds over
    `issue_rate_ops_per_s`."""
    return ops / (ms * 1e-3) / issue_rate_ops_per_s(sms, clock_mhz)


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


def _crossed_rows(c, lo, hi, n_rows):
    """How many of the bitmap rows q in [0, n_rows), whose center line
    is y = c − q, cross a segment whose end y's span [lo, hi): the rows
    with lo <= c − q < hi, the kernels' test (vy <= y) != (wy <= y)."""
    q_max = np.minimum(np.floor(c - lo), n_rows - 1)
    q_min = np.maximum(np.floor(c - hi) + 1, 0)
    return np.maximum(q_max - q_min + 1, 0).astype(np.int64)


def row_shared_work(coords, tmeta, TP: int, mask_words=None,
                    out_bytes_per_pixel: int = 1, pixel_ops: int = BYTE_PIXEL_F32_OPS) -> dict:
    """Pairs, f32 operations and bytes of one launch of a render or
    min-field kernel, by the least count known for its function (the
    module's note on `ROW_SHARED_PAIR_F32_OPS`), from the launch's own
    inputs.

    ``coords`` is the point chain [2, N] with its ``mask_words``, or the
    segment soup [4, N] without; ``tmeta`` the [8, T] tile table, a
    glyph's tile rows together and in order from pix_base 0 (as
    `render.batch.plan_tiles` and `ops.sdf_torch.grid_tmeta` lay them
    out). A glyph's computed pixels are TP for each of its live tile
    rows, those past w·h included, and they fill bitmap rows of w pixels
    from the top; every live segment of the glyph is paired with each of
    them, tested against each of those rows, and where it crosses a row
    its cx is computed once and compared with the row's computed pixels.
    The bytes are `tile_kernel_work`'s. A min-field kernel writes d²,
    winding and argmin (``out_bytes_per_pixel`` 12) and no byte
    (``pixel_ops`` 0)."""
    coords = np.asarray(coords)
    tm = np.asarray(tmeta).astype(np.int64)
    chain = coords.shape[0] == 2
    T, N = tm.shape[1], coords.shape[1]
    live_row = tm[6] < tm[2] * tm[3]
    first = np.flatnonzero(tm[6] == 0)
    glyph_of_row = np.cumsum(tm[6] == 0) - 1
    pixels = TP * np.bincount(glyph_of_row[live_row & (glyph_of_row >= 0)], minlength=first.size)
    _, y0, w, h, n, off = tm[:6, first]
    w = np.maximum(w, 1)
    n = np.clip(n - 1 if chain else n, 0, None) * (pixels > 0)

    # The lanes of every rendered glyph's run, with the glyph of each.
    glyph = np.repeat(np.arange(first.size), n)
    lane = np.repeat(off, n) + np.arange(glyph.size) - np.repeat(np.cumsum(n) - n, n)
    if mask_words is not None:
        bits = np.unpackbits(
            np.ascontiguousarray(np.asarray(mask_words)).view(np.uint8), bitorder="little")
        keep = bits[lane].astype(bool)
        glyph, lane = glyph[keep], lane[keep]
    vy = coords[1, lane].astype(np.float64)
    wy = (coords[1, np.minimum(lane + 1, N - 1)] if chain else coords[3, lane]).astype(np.float64)
    lo, hi = np.minimum(vy, wy), np.maximum(vy, wy)

    segs = np.bincount(glyph, minlength=first.size)
    rows = -(-pixels // w)
    full_rows = pixels // w
    c = (y0 + h)[glyph] - 0.5
    crossings = _crossed_rows(c, lo, hi, rows[glyph])
    in_full_rows = _crossed_rows(c, lo, hi, full_rows[glyph])
    crossing_pixels = in_full_rows * w[glyph] + (crossings - in_full_rows) * (pixels - full_rows * w)[glyph]

    out = {"tiles": T, "pairs": int((pixels * segs).sum()), "pixels": int(pixels.sum()),
           "row_tests": int((rows * segs).sum()), "crossings": int(crossings.sum()),
           "crossing_pixels": int(crossing_pixels.sum())}
    out["f32_ops"] = (out["pairs"] * ROW_SHARED_PAIR_F32_OPS + out["row_tests"] * ROW_TEST_F32_OPS
                      + out["crossings"] * CROSSING_F32_OPS
                      + out["crossing_pixels"] * CROSSING_PIXEL_F32_OPS
                      + out["pixels"] * pixel_ops)
    # The same launch by 22 operations a pair, the count of the bounds
    # that were stated before the row-shared crossing test was known.
    out["f32_ops_per_pair_test"] = out["pairs"] * PAIR_F32_OPS + out["pixels"] * pixel_ops
    out["bytes"] = tile_kernel_work(tm, mask_words, TP, N, lane_rows=coords.shape[0],
                                    out_bytes_per_pixel=out_bytes_per_pixel)["bytes"]
    return out
