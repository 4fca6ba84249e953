"""Host-side outline flattening: Bezier curves → polygonal rings.

This is the host preprocessing stage of the TPU pipeline: glyph outlines
(quadratic/cubic Beziers in font units) are flattened to line-segment
rings in float64 *before* anything touches the device. Flattening is
inherently data-dependent recursion, so it stays on the host; the device
only ever sees fixed-shape segment soups (see `ops/batch.py`).

Parity contract (behavior replicated from the reference, re-derived —
not translated):

- Iterative De Casteljau subdivision with the exact flatness predicates
  of `reference/src/geometry/ring.rs:119-187`:
  quadratic: ``(s + e - 2c)² <= tol²``; cubic: ``((c2+c1)-(s+e))² <= tol²``,
  with the right half pushed first so points append in start→end order.
- Tolerance² = 0.01 font units (`src/render/ring_builder.rs:62`).
- Ring validity rules of `src/render/ring_builder.rs:33-54`: rings with
  <3 points before closing are dropped; rings are closed by appending
  the first point unless it already equals the last within f64 epsilon
  (`src/geometry/ring.rs:53-63`); rings with <4 points after closing are
  dropped.
- Curve commands arriving before any `move_to` are ignored
  (`src/render/ring_builder.rs:83-101`).
"""

from __future__ import annotations

import numpy as np

from ..constants import F64_EPSILON, FLATTEN_TOLERANCE_SQ


def flatten_quadratic(sx, sy, cx, cy, ex, ey, tol_sq, out):
    """Flatten one quadratic Bezier, appending points (excluding the start
    point) to ``out``. Explicit stack, right half pushed first."""
    stack = [(sx, sy, cx, cy, ex, ey)]
    while stack:
        sx, sy, cx, cy, ex, ey = stack.pop()
        dx = sx + ex - cx * 2.0
        dy = sy + ey - cy * 2.0
        if dx * dx + dy * dy <= tol_sq:
            out.append((ex, ey))
            continue
        m1x = (sx + cx) / 2.0
        m1y = (sy + cy) / 2.0
        m2x = (cx + ex) / 2.0
        m2y = (cy + ey) / 2.0
        mx = (m1x + m2x) / 2.0
        my = (m1y + m2y) / 2.0
        # Right half first so the left half is popped next (preserves
        # start→end point order).
        stack.append((mx, my, m2x, m2y, ex, ey))
        stack.append((sx, sy, m1x, m1y, mx, my))


def flatten_cubic(sx, sy, c1x, c1y, c2x, c2y, ex, ey, tol_sq, out):
    """Flatten one cubic Bezier, appending points (excluding the start
    point) to ``out``."""
    stack = [(sx, sy, c1x, c1y, c2x, c2y, ex, ey)]
    while stack:
        sx, sy, c1x, c1y, c2x, c2y, ex, ey = stack.pop()
        dx = (c2x + c1x) - (sx + ex)
        dy = (c2y + c1y) - (sy + ey)
        if dx * dx + dy * dy <= tol_sq:
            out.append((ex, ey))
            continue
        p01x = (sx + c1x) / 2.0
        p01y = (sy + c1y) / 2.0
        p12x = (c1x + c2x) / 2.0
        p12y = (c1y + c2y) / 2.0
        p23x = (c2x + ex) / 2.0
        p23y = (c2y + ey) / 2.0
        p012x = (p01x + p12x) / 2.0
        p012y = (p01y + p12y) / 2.0
        p123x = (p12x + p23x) / 2.0
        p123y = (p12y + p23y) / 2.0
        mx = (p012x + p123x) / 2.0
        my = (p012y + p123y) / 2.0
        stack.append((mx, my, p123x, p123y, p23x, p23y, ex, ey))
        stack.append((sx, sy, p01x, p01y, p012x, p012y, mx, my))


class RingAccumulator:
    """Accumulates outline commands into flattened rings.

    Mirrors the semantics of the reference's outline walker
    (`reference/src/render/ring_builder.rs`), exposed as plain
    move/line/quad/cubic/close methods so any font backend (we use a
    fontTools pen) can drive it.
    """

    def __init__(self, tolerance_sq: float = FLATTEN_TOLERANCE_SQ):
        self.tolerance_sq = float(tolerance_sq)
        self.rings: list[np.ndarray] = []
        self._current: list[tuple[float, float]] = []

    # -- outline commands ------------------------------------------------

    def move_to(self, x: float, y: float) -> None:
        self._save_ring()
        self._current.append((float(x), float(y)))

    def line_to(self, x: float, y: float) -> None:
        self._current.append((float(x), float(y)))

    def quad_to(self, cx: float, cy: float, x: float, y: float) -> None:
        if not self._current:
            return
        sx, sy = self._current[-1]
        flatten_quadratic(
            sx, sy, float(cx), float(cy), float(x), float(y),
            self.tolerance_sq, self._current,
        )

    def cubic_to(self, c1x, c1y, c2x, c2y, x, y) -> None:
        if not self._current:
            return
        sx, sy = self._current[-1]
        flatten_cubic(
            sx, sy, float(c1x), float(c1y), float(c2x), float(c2y),
            float(x), float(y), self.tolerance_sq, self._current,
        )

    def close_path(self) -> None:
        self._save_ring()

    # -- finalization ----------------------------------------------------

    def _save_ring(self) -> None:
        ring = self._current
        if len(ring) < 3:
            self._current = []
            return
        # Close: append first point unless last already equals it within
        # f64 epsilon on both coordinates.
        fx, fy = ring[0]
        lx, ly = ring[-1]
        if abs(fx - lx) > F64_EPSILON or abs(fy - ly) > F64_EPSILON:
            ring.append((fx, fy))
        if len(ring) < 4:
            self._current = []
            return
        self.rings.append(np.asarray(ring, dtype=np.float64))
        self._current = []

    def finish(self) -> list[np.ndarray]:
        """Finalize any in-progress ring and return all rings as (N, 2)
        float64 arrays (each closed: last point == first point)."""
        self._save_ring()
        return self.rings


def rings_to_segments(rings: list[np.ndarray]) -> np.ndarray:
    """Concatenate consecutive-point segments of every ring into one
    (S, 4) float64 array of rows ``[vx, vy, wx, wy]``.

    Matches the segment soup of the reference
    (`reference/src/geometry/rings.rs:75-81`): segments connect
    consecutive points of each ring; rings arrive already closed.
    """
    if not rings:
        return np.zeros((0, 4), dtype=np.float64)
    parts = []
    for ring in rings:
        if len(ring) < 2:
            continue
        seg = np.concatenate([ring[:-1], ring[1:]], axis=1)
        parts.append(seg)
    if not parts:
        return np.zeros((0, 4), dtype=np.float64)
    return np.concatenate(parts, axis=0)


def rings_bbox(rings: list[np.ndarray]):
    """Return (min_x, min_y, max_x, max_y) over all ring points, or None
    if there are no points. A single-point degenerate bbox counts as
    empty via the reference's rule ``max.x<=min.x && max.y<=min.y``
    (`reference/src/geometry/bbox.rs:56`); callers apply that
    check themselves."""
    if not rings:
        return None
    pts = np.concatenate(rings, axis=0)
    if pts.size == 0:
        return None
    mn = pts.min(axis=0)
    mx = pts.max(axis=0)
    return (float(mn[0]), float(mn[1]), float(mx[0]), float(mx[1]))
