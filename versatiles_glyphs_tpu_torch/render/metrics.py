"""Per-glyph metric computation: scale, advance, sub-pixel shift, bbox.

Replicates, in float64 host arithmetic, the integer-metric semantics of
the reference renderer (`reference/src/render/renderer.rs:64-149`
and `src/render/result.rs:66-76`). These interact subtly — the 0.95
advance factor, the half-error dx shift, floor/ceil bbox conversion, the
`y1 -= GLYPH_SIZE` baseline rebase and the Y flip — and any deviation
shifts `left`/`top` by ±1, so everything here stays in f64 and mirrors
the reference's operation order exactly:

1. ``scale = GLYPH_SIZE / units_per_em``
2. ``advance_float = hor_advance · scale · 0.95`` (empirical fontnik
   match), ``advance = round(advance_float)`` (half away from zero)
3. points scaled by ``scale`` then translated by
   ``dx = (advance - advance_float)/2`` (≤ ±0.25 px) so the outline
   stays centered in the integer advance cell
4. ``x0 = floor(min.x) - BUFFER`` … ``y1 = ceil(max.y) + BUFFER``
5. after rendering, ``y1 -= GLYPH_SIZE`` and the PBF reports the content
   area: ``width - 2·BUFFER``, ``height - 2·BUFFER``,
   ``left = x0 + BUFFER``, ``top = y1 - BUFFER``.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import BUFFER, GLYPH_SIZE

# Fixed-point scale of the int16 point transport: 1/256 px granularity,
# ±127 px range (every 24 px-EM glyph fits with a wide margin; the rare
# oversized glyph falls back to the f32 transport per device group).
Q16_SCALE = 256.0


def _round_half_away(x: float) -> int:
    """Rust ``f64::round``: round half away from zero."""
    if x >= 0.0:
        return int(math.floor(x + 0.5))
    return int(math.ceil(x - 0.5))


class GlyphPrep:
    """Everything needed to render and pack one glyph.

    ``segments`` is the (S, 4) float64 segment soup in final pixel
    coordinates (scaled + shifted), derived lazily from ``rings_px``.
    ``width``/``height`` are the full bitmap dims *including* the
    2·BUFFER padding; the PBF content dims are ``width - 6`` /
    ``height - 6``.

    ``rings_px`` are the transformed (pixel-space f64) point chains, one
    per ring with ≥2 points; ring r's segments are consecutive point
    pairs. They are the basis of the device point-chain layout
    (`render.batch.pack_points`/`pack_points_delta`), which ships a
    fraction of the segment soup's bytes over the host↔device pipe.
    ``chain16``/``valid8``/``delta_cache`` are the cached device wire
    forms of those chains, built once per glyph (vectorized per font in
    `build_cores`, natively when csrc is available) so repeated packs
    are bulk copies; ``chain32`` (f32 transport) fills lazily.
    """

    __slots__ = (
        "codepoint", "advance", "dx", "empty", "width", "height",
        "x0", "y0", "x1", "y1",
        "_rings_px", "_pts_px", "_ring_lens",
        "_segments", "_chain32", "_chain16", "_valid8", "_npts",
        "_delta_cache", "_core", "_q16", "_nt256",
    )

    def __init__(
        self,
        codepoint: int,
        advance: int,
        dx: float = 0.0,
        empty: bool = True,
        width: int = 0,
        height: int = 0,
        x0: int = 0,
        y0: int = 0,
        x1: int = 0,
        y1: int = 0,
        segments: np.ndarray | None = None,
        rings_px: list | None = None,
    ):
        self.codepoint = codepoint
        self.advance = advance
        # Sub-pixel x shift applied to the outline (half the advance
        # rounding error, `renderer.rs:130-131`); retained for consumers
        # that re-derive placement (e.g. the fitting pipeline).
        self.dx = dx
        self.empty = empty
        self.width = width
        self.height = height
        self.x0 = x0
        self.y0 = y0
        self.x1 = x1
        self.y1 = y1
        if rings_px is None:
            if segments is not None and len(segments):
                # Constructed from a raw soup: each segment becomes its
                # own 2-point chain (no endpoint sharing assumed).
                segments = np.asarray(segments, dtype=np.float64)
                rings_px = [segments[i].reshape(2, 2) for i in range(len(segments))]
            else:
                rings_px = []
        self._rings_px = rings_px
        self._pts_px = None
        self._ring_lens = None
        self._segments = (
            None if segments is None else np.asarray(segments, dtype=np.float64)
        )
        self._chain32 = None
        self._chain16 = None
        self._valid8 = None
        self._npts = None
        self._delta_cache = None
        self._core = None
        self._q16 = None
        self._nt256 = None

    @property
    def rings_px(self) -> list:
        """Transformed pixel-space point chains, one (K, 2) f64 array per
        ring. Built lazily from the font-level flat prep arrays when the
        glyph came out of `build_cores` (views, no copies)."""
        if self._rings_px is None:
            rings = []
            o = 0
            for ln in self._ring_lens:
                rings.append(self._pts_px[o : o + ln])
                o += ln
            self._rings_px = rings
        return self._rings_px

    @property
    def segments(self) -> np.ndarray:
        """(S, 4) f64 segment soup: consecutive point pairs per chain."""
        if self._segments is None:
            segs = [
                np.concatenate([tr[:-1], tr[1:]], axis=1) for tr in self.rings_px
            ]
            self._segments = (
                np.concatenate(segs, axis=0)
                if segs
                else np.zeros((0, 4), dtype=np.float64)
            )
        return self._segments

    @property
    def npts(self) -> int:
        """Total device lanes: points over all chains."""
        if self._npts is None:
            self._npts = sum(len(r) for r in self.rings_px)
        return self._npts

    @property
    def chain32(self) -> np.ndarray:
        """(2, npts) f32 x/y rows: all chains concatenated. Computed
        lazily — the default i8 transport never touches it — and cached
        on the shared `GlyphCore` so codepoints mapping to one glyph
        still share the array."""
        if self._chain32 is None:
            core = self._core
            if core is not None and not self.empty:
                if core.chain32 is None:
                    core.chain32 = np.ascontiguousarray(
                        core.pts_px.T, dtype=np.float32
                    )
                self._chain32 = core.chain32
            elif self.rings_px:
                self._chain32 = np.ascontiguousarray(
                    np.concatenate(self.rings_px, axis=0).T, dtype=np.float32
                )
            else:
                self._chain32 = np.zeros((2, 0), dtype=np.float32)
        return self._chain32

    @property
    def chain16(self) -> np.ndarray:
        """(2, npts) int16 fixed-point (×`Q16_SCALE`) form of the
        chains: the wire format of the ``i16`` device transport, which
        halves the bytes shipped over the host↔device pipe. Rounding
        perturbs the outline by ≤ √2/(2·Q16_SCALE) ≈ 0.003 px, and the
        kernel renders the perturbed polyline *self-consistently*
        (distance and winding both come from the same quantized points),
        so output bytes move by at most 1 (SDF quantization is
        32 bytes/px: 0.003 px · 32 ≪ 1)."""
        if self._chain16 is None:
            if self.rings_px:
                self._chain16 = np.ascontiguousarray(
                    np.rint(
                        np.concatenate(self.rings_px, axis=0).T * Q16_SCALE
                    ).astype(np.int16)
                )
            else:
                self._chain16 = np.zeros((2, 0), dtype=np.int16)
        return self._chain16

    @property
    def delta_cache(self):
        """Per-glyph i8-delta wire pieces, independent of pack-time
        neighbors (`render.batch.pack_points_delta` assembles groups
        from these with bulk copies): (d8 [2, npts] i8 intra-glyph
        deltas with lane 0 and overflow lanes zeroed, anc_idx [n] i32
        LOCAL overflow lanes, anc_jump [2, n] i32 their true deltas,
        q_first [2] i32, q_last [2] i32). Lane 0 is always anchored at
        pack time (its jump depends on the preceding glyph in the
        group). Usually precomputed vectorized for the whole font
        (`build_cores`); computed here only for soup-constructed
        preps."""
        if self._delta_cache is None:
            q = self.chain16.astype(np.int32)
            k = q.shape[1]
            d8 = np.zeros((2, k), dtype=np.int8)
            if k > 1:
                d = np.diff(q, axis=1)
                over = (np.abs(d) > 127).any(axis=0)
                d8[:, 1:] = np.where(over, 0, d)
                ai = (np.flatnonzero(over) + 1).astype(np.int32)
                aj = d[:, ai - 1]
            else:
                ai = np.zeros(0, np.int32)
                aj = np.zeros((2, 0), np.int32)
            qf = q[:, 0] if k else np.zeros(2, np.int32)
            ql = q[:, -1] if k else np.zeros(2, np.int32)
            self._delta_cache = (d8, ai, aj, qf, ql)
        return self._delta_cache

    @property
    def q16_ok(self) -> bool:
        """True when every outline coordinate fits the int16 transport
        range (±127 px at Q16_SCALE=256; the bbox bounds every flattened
        point, so checking the four ints suffices). Stamped from the
        core's vectorized pass on the hot path (`make_prep`); computed
        here only for soup-constructed preps."""
        if self._q16 is None:
            lim = 32766.0 / Q16_SCALE - 1.0
            self._q16 = (
                max(abs(self.x0), abs(self.x1), abs(self.y0), abs(self.y1))
                <= lim
            )
        return self._q16

    @property
    def ntiles256(self) -> int:
        """ceil(w·h / 256) (the session's TP) — stamped vectorized on
        the core path, computed lazily otherwise."""
        if self._nt256 is None:
            self._nt256 = max(1, -(-(self.width * self.height) // 256))
        return self._nt256

    @property
    def valid8(self) -> np.ndarray:
        """(npts,) uint8 lane-validity: 1 where lane i starts a segment
        (point i+1 exists in the same chain)."""
        if self._valid8 is None:
            v = np.ones(self.npts, dtype=np.uint8)
            o = 0
            for r in self.rings_px:
                o += len(r)
                v[o - 1] = 0
            self._valid8 = v
        return self._valid8

    # -- PBF metric accessors (after the y1 -= GLYPH_SIZE rebase) -------

    @property
    def pbf_width(self) -> int:
        return 0 if self.empty else self.width - 2 * BUFFER

    @property
    def pbf_height(self) -> int:
        return 0 if self.empty else self.height - 2 * BUFFER

    @property
    def pbf_left(self) -> int:
        return 0 if self.empty else self.x0 + BUFFER

    @property
    def pbf_top(self) -> int:
        """top = (y1 - GLYPH_SIZE) - BUFFER: the rebase happens here."""
        return 0 if self.empty else (self.y1 - GLYPH_SIZE) - BUFFER


def prepare_glyph(
    codepoint: int,
    rings: list[np.ndarray],
    units_per_em: int,
    advance_units: int,
) -> GlyphPrep:
    """Compute metrics and the final pixel-space segment soup for one
    glyph. ``rings`` are closed flattened rings in font units (from
    `ops.flatten`)."""
    scale = float(GLYPH_SIZE) / float(units_per_em)
    advance_float = float(advance_units) * scale * 0.95
    advance = _round_half_away(advance_float)

    dx = (float(advance) - advance_float) / 2.0

    if not rings:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)

    pts = np.concatenate(rings, axis=0)
    # Same op order as the reference: scale each coordinate, then add dx.
    spts = pts * scale
    spts = spts + np.array([dx, 0.0])

    min_x = float(spts[:, 0].min())
    min_y = float(spts[:, 1].min())
    max_x = float(spts[:, 0].max())
    max_y = float(spts[:, 1].max())

    # BBox::is_empty — a single point (or fully degenerate box) counts
    # as empty (`src/geometry/bbox.rs:56`).
    if max_x <= min_x and max_y <= min_y:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)

    x0 = int(math.floor(min_x)) - BUFFER
    y0 = int(math.floor(min_y)) - BUFFER
    x1 = int(math.ceil(max_x)) + BUFFER
    y1 = int(math.ceil(max_y)) + BUFFER

    # Transform per ring so segment endpoints share the transformed
    # point values exactly; the soup itself is derived lazily.
    shift = np.array([dx, 0.0])
    rings_px = [ring * scale + shift for ring in rings if len(ring) >= 2]

    return GlyphPrep(
        codepoint=codepoint,
        advance=advance,
        dx=dx,
        empty=False,
        width=x1 - x0,
        height=y1 - y0,
        x0=x0,
        y0=y0,
        x1=x1,
        y1=y1,
        rings_px=rings_px,
    )


class GlyphCore:
    """Per-glyph-NAME precomputed render inputs.

    Everything `prepare_glyph` derives — metrics, transformed chains,
    device transport caches — depends only on the glyph, not the
    codepoint, so a font computes one core per glyph name (vectorized,
    `build_cores`) and every codepoint mapping to that name shares it
    (`make_prep` stamps the codepoint on a thin `GlyphPrep`)."""

    __slots__ = (
        "advance", "dx", "empty", "width", "height", "x0", "y0", "x1", "y1",
        "pts_px", "ring_lens", "chain32", "chain16", "valid8", "npts",
        "delta_cache", "q16_ok", "nt256",
    )

    def make_prep(self, codepoint: int) -> GlyphPrep:
        p = GlyphPrep(
            codepoint=codepoint, advance=self.advance, dx=self.dx,
            empty=self.empty, width=self.width, height=self.height,
            x0=self.x0, y0=self.y0, x1=self.x1, y1=self.y1,
        )
        if not self.empty:
            p._rings_px = None  # lazy: built from the shared flat views
            p._pts_px = self.pts_px
            p._ring_lens = self.ring_lens
            p._core = self  # chain32 fills lazily on the shared core
            p._chain16 = self.chain16
            p._valid8 = self.valid8
            p._npts = self.npts
            p._delta_cache = self.delta_cache
            p._q16 = self.q16_ok
            p._nt256 = self.nt256
        return p


def build_cores(
    names: list[str],
    advances: np.ndarray,
    units_per_em: int,
    pts: np.ndarray,
    ring_lens: np.ndarray,
    glyph_nrings: np.ndarray,
) -> dict:
    """Vectorized `prepare_glyph` over a whole font's glyph set.

    Inputs are the flat native-flattener output (`proto.native.
    glyf_rings`): ``pts`` [N, 2] f64 font-unit points of every supported
    glyph's rings back to back, ``ring_lens`` [R] per-ring point counts,
    ``glyph_nrings`` [n] rings per glyph (−1 marks a glyph the native
    parser rejected — it gets no core and the caller falls back to the
    per-glyph pen path). One pass of whole-font numpy replaces ~10 small
    numpy calls per glyph; the arithmetic (scale → +dx → floor/ceil
    bbox, f64 throughout, same op order as `renderer.rs:103-149`)
    is bit-identical to `prepare_glyph`.

    Returns {name: GlyphCore | None}.
    """
    n = len(names)
    nr = np.asarray(glyph_nrings, dtype=np.int64)
    ring_lens = np.asarray(ring_lens, dtype=np.int64)
    supported = nr >= 0
    nr_s = np.where(supported, nr, 0)
    rstarts = np.concatenate([[0], np.cumsum(nr_s)[:-1]])

    from ..proto import native

    nat = native.prep_cores_batch(
        pts, ring_lens, glyph_nrings, advances, units_per_em
    )
    if nat is not None:
        # Native single-pass (csrc vg_prep_cores): identical f64
        # arithmetic and rounding, ~10× the allocating numpy passes
        # below (asserted equal in tests/test_native.py).
        adv = nat["adv"]
        dx = nat["dx"]
        empty = nat["empty"].astype(bool)
        x0, y0 = nat["bbox"][:, 0], nat["bbox"][:, 1]
        x1, y1 = nat["bbox"][:, 2], nat["bbox"][:, 3]
        npts = nat["npts"]
        postarts = nat["postarts"]
        xy = nat["xy"]
        chainT16 = nat["chain16"]
        valid8 = nat["valid8"]
        d8_font = nat["d8"]
        K = nat["n_anc"]
        local = nat["anc_local"][:K]
        jumps_font = nat["anc_jumps"][:, :K]
        astarts_g = nat["anc_starts"]
    else:
        # Per-glyph ring runs → per-glyph point counts + offsets.
        npts = np.zeros(n, dtype=np.int64)
        has_rings = nr_s > 0
        if ring_lens.size:
            # reduceat over the ring-length array at each glyph's first
            # ring (only for glyphs that have rings; reduceat misbehaves
            # on empty runs).
            npts[has_rings] = np.add.reduceat(ring_lens, rstarts[has_rings])
        postarts = np.concatenate([[0], np.cumsum(npts)[:-1]])

        # Metrics (same formulas and op order as prepare_glyph).
        scale = float(GLYPH_SIZE) / float(units_per_em)
        af = np.asarray(advances, dtype=np.float64) * scale * 0.95
        adv = np.where(
            af >= 0.0, np.floor(af + 0.5), np.ceil(af - 0.5)
        ).astype(np.int64)
        dx = (adv - af) / 2.0

        # Transform every point once: scale, then add the owning
        # glyph's dx to x (identical to `pts*scale + [dx, 0]`).
        xy = pts * scale
        if xy.shape[0]:
            xy[:, 0] += np.repeat(dx, npts)

        # Per-glyph bbox (f64 min/max over each point run).
        minx = np.zeros(n)
        miny = np.zeros(n)
        maxx = np.zeros(n)
        maxy = np.zeros(n)
        hp = npts > 0
        if xy.shape[0]:
            mn = np.minimum.reduceat(xy, postarts[hp], axis=0)
            mx = np.maximum.reduceat(xy, postarts[hp], axis=0)
            minx[hp], miny[hp] = mn[:, 0], mn[:, 1]
            maxx[hp], maxy[hp] = mx[:, 0], mx[:, 1]

        empty = (~hp) | ((maxx <= minx) & (maxy <= miny))
        x0 = (np.floor(minx) - BUFFER).astype(np.int64)
        y0 = (np.floor(miny) - BUFFER).astype(np.int64)
        x1 = (np.ceil(maxx) + BUFFER).astype(np.int64)
        y1 = (np.ceil(maxy) + BUFFER).astype(np.int64)

        # Device transport caches for ALL points at once (the same
        # values GlyphPrep.chain16/valid8 compute per glyph; the f32
        # chain is lazy — only the f32 transport reads it).
        with np.errstate(invalid="ignore"):
            chainT16 = np.rint(xy.T * Q16_SCALE).astype(np.int16)
        valid8 = np.ones(xy.shape[0], dtype=np.uint8)
        if ring_lens.size:
            valid8[np.cumsum(ring_lens) - 1] = 0

        # i8-delta wire pieces for ALL glyphs at once (the same values
        # GlyphPrep.delta_cache computes per glyph): one font-wide
        # diff, with every glyph's lane 0 forced to an anchor so
        # per-glyph d8 slices are independent of pack-time neighbors.
        Nf = xy.shape[0]
        d8_font = np.zeros((2, Nf), dtype=np.int8)
        local = np.zeros(0, np.int32)
        jumps_font = np.zeros((2, 0), np.int32)
        astarts_g = np.zeros(n + 1, dtype=np.int64)
        if Nf > 1:
            # i32 diffs (i16 would overflow); fallback path only — the
            # native branch computes d8/anchors in vg_prep_cores.
            d = np.diff(chainT16.astype(np.int32), axis=1)
            over = (d > 127).any(axis=0)
            over |= (d < -127).any(axis=0)
            is_start = np.zeros(Nf, dtype=bool)
            is_start[postarts[hp]] = True
            over |= is_start[1:]  # glyph starts: anchored at pack time
            d8_font[:, 1:] = np.where(over, 0, d)
            ai_font = (np.flatnonzero(over) + 1).astype(np.int32)
            # Per-glyph local anchor runs, excluding the forced lane-0
            # entries (pack adds those with the group-dependent jump);
            # anchors are lane-sorted, so per-glyph lists are offset
            # slices of the font arrays (no np.split churn).
            ends = postarts + npts
            gi = np.searchsorted(ends, ai_font, side="right")
            keep = ai_font > postarts[gi].astype(np.int32)
            ai_font, gi = ai_font[keep], gi[keep]
            local = ai_font - postarts[gi].astype(np.int32)
            jumps_font = d[:, ai_font - 1]
            np.cumsum(np.bincount(gi, minlength=n), out=astarts_g[1:])

    # Per-glyph first/last q16 columns ([2, n] i32): all the delta
    # cache needs from the chain — materializing a full-font i32 copy
    # of chainT16 for two columns per glyph measured ~2 ms/font.
    n_lanes = chainT16.shape[1]
    if n_lanes:
        first_idx = np.clip(postarts, 0, n_lanes - 1)
        last_idx = np.clip(postarts + np.maximum(npts, 1) - 1, 0, n_lanes - 1)
        qf_all = chainT16[:, first_idx].astype(np.int32)
        ql_all = chainT16[:, last_idx].astype(np.int32)
    else:
        qf_all = ql_all = np.zeros((2, n), np.int32)

    # Scalar fields as Python lists up front: .tolist() converts whole
    # arrays in one C pass, vs one numpy-scalar __int__ per access in
    # the loop (measured ~1/3 of this loop's time on the e2e profile).
    adv_l = np.asarray(adv).tolist()
    dx_l = np.asarray(dx).tolist()
    empty_l = np.asarray(empty).tolist()
    x0_l = np.asarray(x0).tolist()
    y0_l = np.asarray(y0).tolist()
    x1_l = np.asarray(x1).tolist()
    y1_l = np.asarray(y1).tolist()
    o_l = np.asarray(postarts).tolist()
    k_l = np.asarray(npts).tolist()
    rs_l = np.asarray(rstarts).tolist()
    nrs_l = np.asarray(nr_s).tolist()
    a_l = np.asarray(astarts_g).tolist()
    lim = 32766.0 / Q16_SCALE - 1.0
    q16_l = (
        np.maximum(
            np.maximum(np.abs(x0), np.abs(x1)),
            np.maximum(np.abs(y0), np.abs(y1)),
        )
        <= lim
    ).tolist()
    wh = (np.asarray(x1) - np.asarray(x0)) * (np.asarray(y1) - np.asarray(y0))
    nt_l = np.maximum(1, -(-wh // 256)).tolist()

    cores: dict = {}
    for i, name in enumerate(names):
        if not supported[i]:
            cores[name] = None
            continue
        c = GlyphCore()
        c.advance = int(adv_l[i])
        c.dx = dx_l[i]
        if empty_l[i]:
            c.empty = True
            c.width = c.height = c.x0 = c.y0 = c.x1 = c.y1 = 0
            c.pts_px = None
            c.ring_lens = None
            c.chain32 = c.chain16 = c.valid8 = None
            c.delta_cache = None
            c.npts = 0
            c.q16_ok = True
            c.nt256 = 1
        else:
            c.empty = False
            c.x0, c.y0 = x0_l[i], y0_l[i]
            c.x1, c.y1 = x1_l[i], y1_l[i]
            c.width = c.x1 - c.x0
            c.height = c.y1 - c.y0
            c.q16_ok = q16_l[i]
            c.nt256 = nt_l[i]
            o, k = o_l[i], k_l[i]
            c.pts_px = xy[o : o + k]
            c.ring_lens = ring_lens[rs_l[i] : rs_l[i] + nrs_l[i]]
            c.chain32 = None  # lazy (GlyphPrep.chain32)
            c.chain16 = chainT16[:, o : o + k]
            c.valid8 = valid8[o : o + k]
            a0, a1 = a_l[i], a_l[i + 1]
            c.delta_cache = (
                d8_font[:, o : o + k],
                local[a0:a1],
                jumps_font[:, a0:a1],
                qf_all[:, i],
                ql_all[:, i],
            )
            c.npts = k
        cores[name] = c
    return cores
