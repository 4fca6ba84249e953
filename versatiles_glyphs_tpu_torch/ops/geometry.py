"""Vectorized 2D geometry: the reference's leaf geometry API on arrays
(a copy of `versatiles_glyphs_tpu.ops.geometry`).

The reference's geometry layer (`reference/src/geometry/`) is a set of
small structs (`Point`, `Segment`, `Ring`, `Rings`, `BBox`). Here points
are array columns and rings are `(N, 2)` float64 arrays (`ops.flatten`),
so the same operations live here as vectorized functions, including the
reference's public API that its renderer does not call
(`winding_number`, `contains_point`, `BBox::round`):

- `midpoint` / `squared_distance`        — `point.rs:29,38`
- `project_point_on_segment`             — `segment.rs:54-72`
- `segment_squared_distance_to_point`    — `segment.rs:96`
- `ring_winding_number` / `cross_product`— `ring.rs:199-232`
- `rings_contain_point`                  — `rings.rs:93-99`
- `bbox_of` / `bbox_include` / `bbox_is_empty` / `bbox_round`
                                         — `bbox.rs:26-93`

All functions take and return plain NumPy values; broadcasting works on
batched inputs where noted. The hot-path equivalents (per-pixel distance
and winding over whole glyph batches) are the CUDA kernels of
`ops.sdf_cuda` and their plain versions in `ops.sdf_torch`; this module
is the host-side toolbox with the reference's semantics.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "midpoint",
    "squared_distance",
    "project_point_on_segment",
    "segment_squared_distance_to_point",
    "cross_product",
    "ring_winding_number",
    "rings_contain_point",
    "bbox_of",
    "bbox_include",
    "bbox_is_empty",
    "bbox_round",
    "EMPTY_BBOX",
]


def midpoint(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Midpoint of two points (`point.rs:29`); broadcasts."""
    return (np.asarray(p, dtype=np.float64) + np.asarray(q, dtype=np.float64)) / 2.0


def squared_distance(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Squared euclidean distance (`point.rs:38`); broadcasts over
    leading axes of (..., 2) inputs."""
    d = np.asarray(p, dtype=np.float64) - np.asarray(q, dtype=np.float64)
    return np.sum(d * d, axis=-1)


def project_point_on_segment(v, w, p) -> np.ndarray:
    """Clamped projection of point(s) `p` onto segment(s) `v→w`
    (`segment.rs:54-72`): parametric t on the infinite line, clamped to
    [0, 1]; a zero-length segment projects to its start point.
    Broadcasts over leading axes of (..., 2) inputs."""
    v = np.asarray(v, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    d = w - v
    l2 = np.sum(d * d, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.sum((p - v) * d, axis=-1) / l2
    t = np.where(l2 == 0.0, 0.0, np.clip(t, 0.0, 1.0))
    return v + t[..., None] * d


def segment_squared_distance_to_point(v, w, p) -> np.ndarray:
    """Squared distance from point(s) to segment(s) (`segment.rs:96`):
    distance to the clamped projection. This is the scalar/batch host
    twin of the kernels' inner function."""
    return squared_distance(p, project_point_on_segment(v, w, p))


def cross_product(p0, p1, p2) -> np.ndarray:
    """Cross product of vectors (p0→p1) and (p0→p2) (`ring.rs:230`)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    return (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p2[..., 0] - p0[..., 0]
    ) * (p1[..., 1] - p0[..., 1])


def ring_winding_number(ring: np.ndarray, pt) -> int:
    """Winding number of a closed ring around `pt` (`ring.rs:199-221`):
    upward crossings (`p1.y <= y < p2.y`, point strictly left of the
    edge) count +1, downward (`p2.y <= y < p1.y`, strictly right) −1.
    The ring is assumed closed (first == last point); rings with <2
    points wind 0."""
    ring = np.asarray(ring, dtype=np.float64)
    if ring.shape[0] < 2:
        return 0
    pt = np.asarray(pt, dtype=np.float64)
    p1 = ring[:-1]
    p2 = ring[1:]
    cp = cross_product(p1, p2, pt)
    up = (p1[:, 1] <= pt[1]) & (p2[:, 1] > pt[1]) & (cp > 0.0)
    dn = (p1[:, 1] > pt[1]) & (p2[:, 1] <= pt[1]) & (cp < 0.0)
    return int(up.sum()) - int(dn.sum())


def rings_contain_point(rings: list[np.ndarray], pt) -> bool:
    """Non-zero total winding over all rings (`rings.rs:93-99`). The
    renderers use a per-pixel crossing sum instead (same semantics,
    vectorized); this is the public point-query API."""
    return sum(ring_winding_number(r, pt) for r in rings) != 0


# A fresh bbox: min at +inf, max at −inf (`bbox.rs:26`), as a (2, 2)
# array [[min_x, min_y], [max_x, max_y]].
EMPTY_BBOX = np.array([[np.inf, np.inf], [-np.inf, -np.inf]], dtype=np.float64)


def bbox_of(points: np.ndarray) -> np.ndarray:
    """Bounding box of an (N, 2) point array; empty input → EMPTY_BBOX."""
    points = np.asarray(points, dtype=np.float64)
    if points.size == 0:
        return EMPTY_BBOX.copy()
    return np.stack([points.min(axis=0), points.max(axis=0)])


def bbox_include(bbox: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Expand `bbox` to include another bbox (or a point given as a
    degenerate [[p], [p]] box) — `bbox.rs:64-81`."""
    return np.stack(
        [np.minimum(bbox[0], other[0]), np.maximum(bbox[1], other[1])]
    )


def bbox_is_empty(bbox: np.ndarray) -> bool:
    """`max.x <= min.x && max.y <= min.y` (`bbox.rs:56`): a fresh or
    single-point box is empty; a 1-axis-degenerate box is NOT (the
    renderer must not silently drop it)."""
    return bool(bbox[1, 0] <= bbox[0, 0] and bbox[1, 1] <= bbox[0, 1])


def bbox_round(bbox: np.ndarray) -> np.ndarray:
    """Round all coordinates to the nearest integer, half away from
    zero as Rust's `f64::round` (`bbox.rs:87-92`; NumPy's `round` is
    half-to-even, so this uses sign-aware floor/ceil)."""
    b = np.asarray(bbox, dtype=np.float64)
    return np.where(b >= 0.0, np.floor(b + 0.5), np.ceil(b - 0.5))
