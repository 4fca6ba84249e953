"""Frozen copy of the flattening and the glyph prep the reference uses.

The port flattens outlines with `ops.flatten.RingAccumulator` (iterative
De Casteljau with the reference's flatness predicates, Bezier by
Bezier in Python) and measures glyphs with `render.metrics`
(`prepare_glyph`, vectorized as `build_cores`). This module computes
the same values from the benchmark's own outline descriptions
(`frozen.synth_font`), whole fonts at a time:

- `flatten`: every curve of a font split breadth first, level by level,
  with the same midpoint arithmetic and the same predicates as the
  depth-first original (quadratic ``(s + e - 2c)^2 <= tol^2``, cubic
  ``((c2 + c1) - (s + e))^2 <= tol^2``, tol^2 = 0.01 font units); the
  pieces that stop are put back in curve order by the dyadic parameter
  at their end, so the points are the original's, bit for bit.
- rings are closed and dropped by the original's rules (fewer than 3
  points before closing or 4 after; the first point appended unless the
  last equals it within f64 epsilon).
- `prep`: advance, sub-pixel shift, bounding box and bitmap size of each
  glyph in f64, in `render.metrics.prepare_glyph`'s operation order.

`tests/test_glyphbench_frozen.py` holds each against the port's
original on the benchmark's fonts.
"""

from __future__ import annotations

import numpy as np

from . import synth_font

GLYPH_SIZE = 24
BUFFER = 3
FLATTEN_TOLERANCE_SQ = 0.01
F64_EPSILON = 2.220446049250313e-16
_MAX_LEVEL = 48  # deeper than any curve of a font needs (a level quarters the test)


def flatten(kind: int, ctrl: np.ndarray, tol_sq: float = FLATTEN_TOLERANCE_SQ):
    """Flatten curves of one degree: ``kind`` 2 (quadratic, ``ctrl``
    [M, 3, 2]: start, control, end) or 3 (cubic, [M, 4, 2]). Returns
    (points [K, 2] f64, curve index [K] i64), each curve's points after
    its start in order, as the depth-first original appends them."""
    m = ctrl.shape[0]
    pieces = [ctrl[:, i].copy() for i in range(kind + 1)]
    curve = np.arange(m, dtype=np.int64)
    pos = np.zeros(m, dtype=np.int64)  # the piece's index at its level
    out_pts, out_curve, out_key = [], [], []
    for level in range(_MAX_LEVEL + 1):
        if not curve.size:
            break
        if kind == 2:
            s, c, e = pieces
            dx = s[:, 0] + e[:, 0] - c[:, 0] * 2.0
            dy = s[:, 1] + e[:, 1] - c[:, 1] * 2.0
        else:
            s, c1, c2, e = pieces
            dx = (c2[:, 0] + c1[:, 0]) - (s[:, 0] + e[:, 0])
            dy = (c2[:, 1] + c1[:, 1]) - (s[:, 1] + e[:, 1])
        done = dx * dx + dy * dy <= tol_sq
        if level == _MAX_LEVEL:
            done[:] = True
        out_pts.append(pieces[-1][done])
        out_curve.append(curve[done])
        out_key.append((pos[done] + 1) << (_MAX_LEVEL - level))
        go = ~done
        pieces = [p[go] for p in pieces]
        curve, pos = curve[go], pos[go]
        if kind == 2:
            s, c, e = pieces
            m1 = (s + c) / 2.0
            m2 = (c + e) / 2.0
            mid = (m1 + m2) / 2.0
            left, right = [s, m1, mid], [mid, m2, e]
        else:
            s, c1, c2, e = pieces
            p01 = (s + c1) / 2.0
            p12 = (c1 + c2) / 2.0
            p23 = (c2 + e) / 2.0
            p012 = (p01 + p12) / 2.0
            p123 = (p12 + p23) / 2.0
            mid = (p012 + p123) / 2.0
            left, right = [s, p01, p012, mid], [mid, p123, p23, e]
        pieces = [np.concatenate([a, b]) for a, b in zip(left, right)]
        curve = np.concatenate([curve, curve])
        pos = np.concatenate([2 * pos, 2 * pos + 1])
    pts = np.concatenate(out_pts) if out_pts else np.zeros((0, 2))
    cur = np.concatenate(out_curve) if out_curve else np.zeros(0, np.int64)
    key = np.concatenate(out_key) if out_key else np.zeros(0, np.int64)
    order = np.lexsort((key, cur))
    return pts[order], cur[order]


class FontRings:
    """The flattened rings of a font's glyphs: ``pts`` [N, 2] f64 font
    units, ``ring_lens`` [R], ``glyph_nrings`` [G], and ``advances``
    [G] in font units, glyph by glyph in the font's order."""

    def __init__(self, pts, ring_lens, glyph_nrings, advances, units_per_em=synth_font.UPEM):
        self.pts = pts
        self.ring_lens = np.asarray(ring_lens, np.int64)
        self.glyph_nrings = np.asarray(glyph_nrings, np.int64)
        self.advances = np.asarray(advances, np.int64)
        self.units_per_em = units_per_em

    def glyph_rings(self, g: int) -> list:
        """Glyph ``g``'s rings, each [K, 2] (for tests)."""
        r0 = int(self.glyph_nrings[:g].sum())
        p0 = int(self.ring_lens[:r0].sum())
        out = []
        for ln in self.ring_lens[r0:r0 + self.glyph_nrings[g]]:
            out.append(self.pts[p0:p0 + ln])
            p0 += ln
        return out


def _close_rings(starts: np.ndarray, pts: np.ndarray,
                 ring_of_pt: np.ndarray, n_rings: int, glyph_of_ring: np.ndarray,
                 n_glyphs: int, advances) -> FontRings:
    """Rings from their starts [R, 2] and the points after them (each
    ring's in order, ``ring_of_pt`` sorted), closed and filtered by the
    original's rules."""
    counts = np.bincount(ring_of_pt, minlength=n_rings) + 1
    first = starts
    last_idx = np.cumsum(np.bincount(ring_of_pt, minlength=n_rings)) - 1
    has = counts > 1
    last = np.where(has[:, None], pts[np.clip(last_idx, 0, None)] if len(pts) else first, first)
    need = ((np.abs(first[:, 0] - last[:, 0]) > F64_EPSILON)
            | (np.abs(first[:, 1] - last[:, 1]) > F64_EPSILON))
    keep = (counts >= 3) & (counts + need >= 4)
    lens = counts + need
    # Assemble: start, the points, and the closing start where needed.
    total = int(lens[keep].sum())
    out = np.empty((total, 2))
    ring_starts = np.concatenate([[0], np.cumsum(np.where(keep, lens, 0))[:-1]])
    pt_ring_start = np.concatenate([[0], np.cumsum(counts - 1)[:-1]])
    kr = np.flatnonzero(keep)
    out[ring_starts[kr]] = first[kr]
    kp = keep[ring_of_pt]
    local = np.arange(len(ring_of_pt)) - pt_ring_start[ring_of_pt]
    out[ring_starts[ring_of_pt[kp]] + 1 + local[kp]] = pts[kp]
    kc = kr[need[kr]]
    out[ring_starts[kc] + lens[kc] - 1] = first[kc]
    nrings = np.bincount(glyph_of_ring[kr], minlength=n_glyphs)
    return FontRings(out, lens[kr], nrings, advances)


def text_font_rings(n_glyphs: int, seed: int, quads: int) -> FontRings:
    """The flattened rings of `synth_font.build_ttf`'s glyphs (one
    quadratic contour P_j -> C_j -> P_{j+1} after another, closing on
    P_0), as a TrueType pen draws them."""
    outlines = synth_font.curved_outlines(n_glyphs, seed, quads)
    starts, glyph_of_ring, ctrl, ring_of_quad = [], [], [], []
    r = 0
    for g, (_, contours) in enumerate(outlines):
        for on, off in contours:
            n = len(on)
            on_a = np.asarray(on, np.float64)
            off_a = np.asarray(off, np.float64)
            ctrl.append(np.stack([on_a, off_a, np.roll(on_a, -1, axis=0)], axis=1))
            ring_of_quad.append(np.full(n, r))
            starts.append(on_a[0])
            glyph_of_ring.append(g)
            r += 1
    ctrl = np.concatenate(ctrl)
    ring_of_quad = np.concatenate(ring_of_quad)
    pts, quad = flatten(2, ctrl)
    return _close_rings(np.asarray(starts), pts, ring_of_quad[quad], r,
                        np.asarray(glyph_of_ring), n_glyphs, [a for a, _ in outlines])


def _contour_rings(contours) -> FontRings:
    """The flattened rings of contours ``(start, segments)`` (lines
    ``("l", p)`` and cubics ``("c", p1, p2, p3)``), one glyph each, as a
    CFF pen draws them: a move to the start, the segments, a close."""
    starts, seg_ring, seg_kind, cub = [], [], [], []
    for r, (start, segs) in enumerate(contours):
        cur = start
        for seg in segs:
            seg_kind.append(seg[0] == "c")
            cub.append((cur, *seg[1:]) if seg[0] == "c" else (cur, cur, cur, seg[1]))
            seg_ring.append(r)
            cur = seg[-1]
        starts.append(start)
    cub = np.asarray(cub, np.float64)
    kind = np.asarray(seg_kind)
    seg_ring = np.asarray(seg_ring)
    curves = np.flatnonzero(kind)
    cpts, ci = flatten(3, cub[curves])
    lines = np.flatnonzero(~kind)
    # Every segment's points, in segment order: a line its end alone.
    seg_of = np.concatenate([curves[ci], lines])
    pts = np.concatenate([cpts, cub[lines, 3]])
    order = np.argsort(seg_of, kind="stable")
    n = len(contours)
    return _close_rings(np.asarray(starts, np.float64), pts[order], seg_ring[seg_of[order]], n,
                        np.arange(n), n, np.zeros(n))


def cjk_font_rings(n_glyphs: int, seed: int) -> FontRings:
    """The flattened rings of `synth_font.build_otf_curved`'s glyphs
    (`synth_font.cjk_outlines`: each stroke contour a move to its start,
    then lines and cubics, closed back to the start), as a CFF pen draws
    them. A glyph's strokes are the library's, moved by integer offsets,
    and every point of their subdivision is a dyadic rational of a few
    dozen bits: the arithmetic is exact, so flattening each library
    stroke once at the origin and moving its points gives the points of
    flattening it in place, bit for bit."""
    lib = [((0, 0), synth_font._shape_segments(synth_font._stroke_shape(seed, i))[0])
                          for i in range(synth_font._N_SHAPES)]
    tmpl = _contour_rings(lib)
    t_len = np.zeros(len(lib), np.int64)
    t_len[tmpl.glyph_nrings > 0] = tmpl.ring_lens
    t_start = np.concatenate([[0], np.cumsum(t_len)[:-1]])
    advances, counts, shp, xs, ys, _ = synth_font._cjk_layouts(n_glyphs, seed)
    live = np.arange(shp.shape[1])[None, :] < counts[:, None]
    sh, ox, oy = shp[live], xs[live], ys[live]  # every stroke of every glyph, in order
    glyph = np.repeat(np.arange(n_glyphs), counts)
    keep = t_len[sh] > 0
    sh, ox, oy, glyph = sh[keep], ox[keep], oy[keep], glyph[keep]
    lens = t_len[sh]
    idx = np.repeat(t_start[sh] - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
    pts = tmpl.pts[idx] + np.stack([np.repeat(ox, lens), np.repeat(oy, lens)], axis=1).astype(np.float64)
    return FontRings(pts, lens, np.bincount(glyph, minlength=n_glyphs), advances)


class Prep:
    """Per glyph (arrays [G]) what `render.metrics.prepare_glyph` gives:
    ``advance``, ``dx``, ``empty``, ``x0, y0, x1, y1``, ``width``,
    ``height`` (bitmap with its buffer), the PBF's ``pbf_width``,
    ``pbf_height``, ``pbf_left``, ``pbf_top``; and the pixel-space
    points ``xy`` [N, 2] with ``pt_start`` [G] and ``npts`` [G], and the
    rings' lengths (``ring_lens``, ``glyph_nrings``)."""


def prep(rings: FontRings) -> Prep:
    """The glyphs' metrics and pixel-space points, in f64 and
    `prepare_glyph`'s operation order: scale = 24 / upem; advance =
    round half away of adv·scale·0.95; dx = (advance − that) / 2; points
    scaled, then dx added to x; bbox floor/ceil ∓ the buffer."""
    g_n = len(rings.glyph_nrings)
    scale = float(GLYPH_SIZE) / float(rings.units_per_em)
    af = rings.advances.astype(np.float64) * scale * 0.95
    adv = np.where(af >= 0.0, np.floor(af + 0.5), np.ceil(af - 0.5)).astype(np.int64)
    dx = (adv - af) / 2.0
    r_start = np.concatenate([[0], np.cumsum(rings.glyph_nrings)[:-1]])
    npts = np.zeros(g_n, np.int64)
    has = rings.glyph_nrings > 0
    if rings.ring_lens.size:
        npts[has] = np.add.reduceat(rings.ring_lens, r_start[has])
    pt_start = np.concatenate([[0], np.cumsum(npts)[:-1]])
    xy = rings.pts * scale
    if xy.shape[0]:
        xy[:, 0] += np.repeat(dx, npts)
    mn = np.zeros((g_n, 2))
    mx = np.zeros((g_n, 2))
    hp = npts > 0
    if xy.shape[0]:
        mn[hp] = np.minimum.reduceat(xy, pt_start[hp], axis=0)
        mx[hp] = np.maximum.reduceat(xy, pt_start[hp], axis=0)
    empty = (~hp) | ((mx[:, 0] <= mn[:, 0]) & (mx[:, 1] <= mn[:, 1]))
    p = Prep()
    p.advance, p.dx, p.empty = adv, dx, empty
    p.x0 = np.where(empty, 0, np.floor(mn[:, 0]).astype(np.int64) - BUFFER)
    p.y0 = np.where(empty, 0, np.floor(mn[:, 1]).astype(np.int64) - BUFFER)
    p.x1 = np.where(empty, 0, np.ceil(mx[:, 0]).astype(np.int64) + BUFFER)
    p.y1 = np.where(empty, 0, np.ceil(mx[:, 1]).astype(np.int64) + BUFFER)
    p.width, p.height = p.x1 - p.x0, p.y1 - p.y0
    p.pbf_width = np.where(empty, 0, p.width - 2 * BUFFER)
    p.pbf_height = np.where(empty, 0, p.height - 2 * BUFFER)
    p.pbf_left = np.where(empty, 0, p.x0 + BUFFER)
    p.pbf_top = np.where(empty, 0, (p.y1 - GLYPH_SIZE) - BUFFER)
    p.xy, p.pt_start, p.npts = xy, pt_start, npts
    p.ring_lens, p.glyph_nrings = rings.ring_lens, rings.glyph_nrings
    return p


def segments(p: Prep) -> tuple[np.ndarray, np.ndarray]:
    """Every glyph's segment soup in pixel units: (segs [S, 4] vx, vy,
    wx, wy of consecutive points of each ring, glyph [S] i64)."""
    ends = np.cumsum(p.ring_lens)
    last = np.zeros(len(p.xy), bool)
    last[ends - 1] = True
    v = np.flatnonzero(~last)
    glyph_of_pt = np.repeat(np.arange(len(p.npts)), p.npts)
    return np.concatenate([p.xy[v], p.xy[v + 1]], axis=1), glyph_of_pt[v]
