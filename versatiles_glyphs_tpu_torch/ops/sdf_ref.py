"""Exact float64 SDF renderer (host, NumPy) — the golden semantics.

This is the bit-exact reference implementation of the per-pixel SDF
evaluation. It reproduces, in vectorized float64 NumPy, the exact
arithmetic of the reference hot loop
(`reference/src/render/renderer_precise.rs:8-84` and
`reference/src/render/rtree_segments.rs:40-68`,
`reference/src/geometry/segment.rs:54-96`), with two deliberate
structural differences that provably do not change the output:

1. **No R-tree.** The reference queries an R-tree for segments within
   `SDF_RADIUS` of each pixel and takes the min distance over the
   candidates (∞ when none). We take the min over *all* segments. When
   the true min is ≤ 8 the candidate set contains the argmin, so the
   results agree; when it is > 8 the reference's ∞ and our true value
   both saturate to the same byte after quantization (0 outside / 255
   inside), because `255 - (8·32 + 64) < 0` already clamps.

2. **No sorted scanline sweep.** The reference sorts row crossings and
   sweeps winding left→right (`renderer_precise.rs:40-67`). The sweep's
   winding at pixel x is exactly ``-Σ sign(c) over crossings with
   c.x <= px``; we compute that masked sum directly per pixel, which is
   order-independent and embarrassingly parallel — the same formulation
   the TPU kernel uses.

Crossing conventions (must match exactly — half-open to avoid double
counting at shared vertices): upward ``s.y <= py < e.y`` → +1, downward
``e.y <= py < s.y`` → −1, crossing x = ``s.x + t·(e.x - s.x)`` with
``t = (py - s.y)/(e.y - s.y)``.

Quantization: ``byte = round(clamp(255 - (d·256/8 + 64), 0, 255))`` with
round-half-away-from-zero (Rust `f64::round`), and the bitmap stored
Y-flipped: output row 0 is the *top* (max y) row.
"""

from __future__ import annotations

import numpy as np

from ..constants import CUTOFF, SDF_RADIUS


def segment_min_dist_sq(px: np.ndarray, py: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Min squared distance from points (px, py) [...,] to any of the
    segments (S, 4), using the exact projection formula of the reference
    (`src/geometry/segment.rs:54-96`): the clamped-t endpoints are
    returned exactly (not via the interpolation formula) so IEEE results
    match bit-for-bit."""
    vx = segs[:, 0]
    vy = segs[:, 1]
    wx = segs[:, 2]
    wy = segs[:, 3]
    dx = wx - vx
    dy = wy - vy
    # squared_distance_to computes (v.x-w.x)^2 + ... — identical to
    # (w.x-v.x)^2 in IEEE.
    l2 = dx * dx + dy * dy

    p_x = px[..., None]
    p_y = py[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = ((p_x - vx) * dx + (p_y - vy) * dy) / l2
    qx = vx + t * dx
    qy = vy + t * dy
    # Exact endpoint selection for the clamped / degenerate cases.
    use_v = (t < 0.0) | (l2 == 0.0) | np.isnan(t)
    use_w = (t > 1.0) & ~use_v
    qx = np.where(use_v, vx, np.where(use_w, wx, qx))
    qy = np.where(use_v, vy, np.where(use_w, wy, qy))
    ddx = p_x - qx
    ddy = p_y - qy
    d2 = ddx * ddx + ddy * ddy
    return d2.min(axis=-1)


def winding_inside(px: np.ndarray, py: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Inside/outside per point via signed crossing count.

    ``inside = (Σ_{crossings c: c.x <= px} sign(c)) != 0`` — identical to
    the reference's sorted sweep (see module docstring)."""
    sx = segs[:, 0]
    sy = segs[:, 1]
    ex = segs[:, 2]
    ey = segs[:, 3]
    p_y = py[..., None]
    up = (sy <= p_y) & (ey > p_y)
    dn = (sy > p_y) & (ey <= p_y)
    crossing = up | dn
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (p_y - sy) / (ey - sy)
    cx = sx + t * (ex - sx)
    sign = np.where(up, 1, np.where(dn, -1, 0))
    hit = crossing & (cx <= px[..., None])
    wn = np.where(hit, sign, 0).sum(axis=-1)
    return wn != 0


def render_sdf_exact(
    segs: np.ndarray, width: int, height: int, x0: int, y0: int
) -> np.ndarray:
    """Render the quantized SDF bitmap for one glyph.

    Parameters mirror the reference's `RenderResult` going into
    `renderer_precise`: ``segs`` is the (S, 4) float64 segment soup in
    pixel units (already scaled/shifted), and the bitmap covers pixel
    centers ``(x + x0 + 0.5, y + y0 + 0.5)`` for x in [0,width),
    y in [0,height).

    Returns a (height·width,) uint8 array in the PBF's Y-flipped
    row-major order (index ``(height-1-y)·width + x``).
    """
    if width <= 0 or height <= 0:
        return np.zeros(0, dtype=np.uint8)

    xs = np.arange(width, dtype=np.float64) + (float(x0) + 0.5)
    ys = np.arange(height, dtype=np.float64) + (float(y0) + 0.5)
    # Grid of all pixel centers: shape (height, width).
    px = np.broadcast_to(xs[None, :], (height, width))
    py = np.broadcast_to(ys[:, None], (height, width))

    if segs.shape[0] == 0:
        d = np.full((height, width), np.inf)
        inside = np.zeros((height, width), dtype=bool)
    else:
        # Row-chunk to bound the (pixels × segments) temporary.
        d = np.empty((height, width), dtype=np.float64)
        inside = np.empty((height, width), dtype=bool)
        max_cells = 4_000_000
        rows_per_chunk = max(1, max_cells // max(1, width * segs.shape[0]))
        for r0 in range(0, height, rows_per_chunk):
            r1 = min(height, r0 + rows_per_chunk)
            d2 = segment_min_dist_sq(px[r0:r1], py[r0:r1], segs)
            d[r0:r1] = np.sqrt(d2)
            inside[r0:r1] = winding_inside(px[r0:r1], py[r0:r1], segs)

    d = np.where(inside, -d, d)
    v = d * (256.0 / SDF_RADIUS) + CUTOFF
    n = np.clip(255.0 - v, 0.0, 255.0)
    # Rust f64::round = round half away from zero; n >= 0 so floor(n+0.5).
    bitmap = np.floor(n + 0.5).astype(np.uint8)
    # Y flip: row y of the computation is stored at output row height-1-y.
    return bitmap[::-1, :].reshape(-1).copy()
