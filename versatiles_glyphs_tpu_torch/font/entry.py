"""Font file ingestion: parsing, metadata, and outline extraction.

Host-side equivalent of the reference's `FontFileEntry` + `FontMetadata`
(`reference/src/font/file_entry.rs`, `src/font/metadata.rs`),
built on fontTools instead of ttf-parser. The Rust pinned
self-referential struct idiom is irrelevant here; we simply keep the
parsed ``TTFont`` plus derived lookup tables.

Outlines are extracted with a fontTools pen driving
`ops.flatten.RingAccumulator`; fontTools' BasePen decomposes TrueType
qCurveTo runs into single quadratics with implied on-curve midpoints —
the same decomposition ttf-parser performs — and the glyph set resolves
composite glyphs with their component transforms.
"""

from __future__ import annotations

import io
from functools import cached_property

from fontTools.pens.basePen import BasePen
from fontTools.ttLib import TTFont

from ..ops.flatten import RingAccumulator
from .names import generate_name, parse_font_name


class RingPen(BasePen):
    """fontTools pen → RingAccumulator adapter."""

    def __init__(self, glyph_set, acc: RingAccumulator):
        super().__init__(glyph_set)
        self.acc = acc

    def _moveTo(self, pt):
        self.acc.move_to(pt[0], pt[1])

    def _lineTo(self, pt):
        self.acc.line_to(pt[0], pt[1])

    def _qCurveToOne(self, c, e):
        self.acc.quad_to(c[0], c[1], e[0], e[1])

    def _curveToOne(self, c1, c2, e):
        self.acc.cubic_to(c1[0], c1[1], c2[0], c2[1], e[0], e[1])

    def _closePath(self):
        self.acc.close_path()

    def _endPath(self):
        # Open contours don't occur in glyph outlines; treat like close
        # (the accumulator closes the ring geometrically anyway).
        self.acc.close_path()


class CurvePen(BasePen):
    """Collects a glyph's outline as a cubic-curve soup [C, 4, 2]
    (float64, font units) for the differentiable model path
    (`models/glyph_model.py`): lines become cubics with collinear
    control points, quadratics are degree-elevated exactly, and every
    contour is closed with a line back to its start — so chord-
    flattening the curves reproduces the closed rings the SDF needs."""

    def __init__(self, glyph_set):
        super().__init__(glyph_set)
        self.curves: list = []
        self._start = None

    def _line_cubic(self, s, e):
        sx, sy = s
        ex, ey = e
        c1 = (sx + (ex - sx) / 3.0, sy + (ey - sy) / 3.0)
        c2 = (sx + 2.0 * (ex - sx) / 3.0, sy + 2.0 * (ey - sy) / 3.0)
        self.curves.append((s, c1, c2, e))

    def _moveTo(self, pt):
        self._start = pt

    def _lineTo(self, pt):
        self._line_cubic(self._getCurrentPoint(), pt)

    def _qCurveToOne(self, c, e):
        s = self._getCurrentPoint()
        sx, sy = s
        cx, cy = c
        ex, ey = e
        c1 = (sx + 2.0 / 3.0 * (cx - sx), sy + 2.0 / 3.0 * (cy - sy))
        c2 = (ex + 2.0 / 3.0 * (cx - ex), ey + 2.0 / 3.0 * (cy - ey))
        self.curves.append((s, c1, c2, e))

    def _curveToOne(self, c1, c2, e):
        self.curves.append((self._getCurrentPoint(), c1, c2, e))

    def _closePath(self):
        cur = self._getCurrentPoint()
        if self._start is not None and cur is not None and cur != self._start:
            self._line_cubic(cur, self._start)

    def _endPath(self):
        self._closePath()


class FontMetadata:
    """Extracted font properties: family/style/weight/width + codepoint
    coverage (union of all unicode cmap subtables, mapped codepoints
    only — `src/font/metadata.rs:103-118`)."""

    def __init__(self, font: TTFont, codepoints: list[int] | None = None):
        name_table = font["name"]
        raw_family = name_table.getDebugName(1) or ""
        ps_name = name_table.getDebugName(6) or ""
        self.name = raw_family
        self.family, self.style, self.weight, self.width = parse_font_name(
            raw_family, ps_name
        )

        if codepoints is not None:
            # Pre-computed coverage (the native cmap parser,
            # `FontFileEntry._native_index`) — skips the fontTools cmap
            # decompile on the ingest hot path.
            self.codepoints = codepoints
            return
        cmap_table = font.get("cmap")
        if cmap_table is None:
            raise ValueError("Font has no cmap table")
        cps: set[int] = set()
        for sub in cmap_table.tables:
            if sub.isUnicode():
                cps.update(sub.cmap.keys())
        self.codepoints: list[int] = sorted(cps)

    def generate_name(self) -> str:
        return generate_name(self.family, self.style, self.weight, self.width)

    def __repr__(self) -> str:
        return (
            f"FontMetadata {{ family: {self.family}, style: {self.style}, "
            f"weight: {self.weight}, width: {self.width}, "
            f"codepoints: {len(self.codepoints)} }}"
        )


class FontFileEntry:
    """One parsed font file: raw bytes + TTFont + metadata + outline
    access. Mirrors `src/font/file_entry.rs` (identity) and the outline
    path of `src/render/renderer.rs:103-116` (lookup + advance)."""

    def __init__(self, data: bytes):
        self.data = data
        self.font = TTFont(io.BytesIO(data), fontNumber=0, lazy=True)
        idx = self._native_index
        self.metadata = FontMetadata(
            self.font, None if idx is None else idx[0].tolist()
        )
        self.units_per_em: int = self.font["head"].unitsPerEm

    @cached_property
    def _native_index(self):
        """(cps u32 sorted, gids u32, advances u16 by gid) from the raw
        cmap/hmtx/hhea/maxp tables via the native parsers — the ingest
        hot path's replacement for fontTools' cmap + post decompile
        (metadata coverage, cp→glyph lookup AND advances become three
        array reads). None when the native library is unavailable or a
        cmap subtable format is uncovered (fontTools fallback; asserted
        equal in tests/test_native.py)."""
        import numpy as np

        from ..proto import native

        if not native.available():
            return None
        reader = getattr(self.font, "reader", None)
        if reader is None:
            return None
        tables = reader.tables
        if not all(k in tables for k in ("cmap", "hmtx", "hhea", "maxp")):
            return None
        for k in ("cmap", "hmtx", "hhea", "maxp"):
            e = tables[k]
            # Over-declared directory lengths (fontTools tolerates the
            # short read): take the fontTools fallback, per contract.
            if e.offset + e.length > len(self.data):
                return None

        def raw(tag):
            e = tables[tag]
            return np.frombuffer(
                self.data, np.uint8, count=e.length, offset=e.offset
            )

        res = native.cmap_union(raw("cmap"))
        if res is None:
            return None
        cps, gids = res
        hhea, maxp = raw("hhea"), raw("maxp")
        if len(hhea) < 36 or len(maxp) < 6:
            return None
        num_h = (int(hhea[34]) << 8) | int(hhea[35])
        num_g = (int(maxp[4]) << 8) | int(maxp[5])
        adv = native.hmtx_advances(raw("hmtx"), num_h, num_g)
        if adv is None:
            return None
        keep = gids < num_g  # guard malformed cmaps; fontTools would err
        if not keep.all():
            cps, gids = cps[keep], gids[keep]
        return cps, gids, adv

    @cached_property
    def _gid_map(self) -> dict:
        """cp → glyph id (native index path only)."""
        cps, gids, _ = self._native_index
        return dict(zip(cps.tolist(), gids.tolist()))

    @cached_property
    def _cmap(self) -> dict:
        """Codepoint → glyph name over the UNION of all unicode cmap
        subtables, first subtable in table order to map a codepoint
        wins — matching ttf-parser's `Face::glyph_index` subtable scan
        (the reference's lookup, `src/render/renderer.rs:104`) and the
        coverage union metadata is built from
        (`src/font/metadata.rs:103-116`). A single-subtable
        `getBestCmap()` would silently skip codepoints that only a
        non-"best" subtable maps."""
        union: dict = {}
        for sub in self.font["cmap"].tables:
            if sub.isUnicode():
                for cp, name in sub.cmap.items():
                    union.setdefault(cp, name)
        return union

    @cached_property
    def _glyph_set(self):
        return self.font.getGlyphSet()

    @cached_property
    def _hmtx(self):
        return self.font["hmtx"]

    def glyph_name(self, codepoint: int):
        """cmap lookup; None when the codepoint has no glyph (reference:
        `face.glyph_index(cp)` returning None skips the glyph)."""
        return self._cmap.get(codepoint)

    def hor_advance(self, glyph_name: str) -> int:
        try:
            return self._hmtx[glyph_name][0]
        except KeyError:
            return 0

    @cached_property
    def _glyf_raw(self):
        """(glyf bytes view, loca uint32 offsets) straight from the sfnt
        directory, or None for CFF fonts. Feeds the native parser."""
        import numpy as np

        reader = getattr(self.font, "reader", None)
        if reader is None:
            return None
        tables = reader.tables
        if "glyf" not in tables or "loca" not in tables:
            return None
        le = tables["loca"]
        raw = self.data[le.offset : le.offset + le.length]
        if self.font["head"].indexToLocFormat == 0:
            loca = np.frombuffer(raw, dtype=">u2").astype(np.uint32) * 2
        else:
            loca = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
        ge = tables["glyf"]
        glyf = np.frombuffer(
            self.data, dtype=np.uint8, count=ge.length, offset=ge.offset
        )
        return glyf, loca

    @cached_property
    def _cff_raw(self):
        """Raw 'CFF ' table bytes view, or None (TrueType / CFF2).
        Feeds the native Type 2 charstring parser."""
        import numpy as np

        reader = getattr(self.font, "reader", None)
        if reader is None or "CFF " not in reader.tables:
            return None
        e = reader.tables["CFF "]
        return np.frombuffer(
            self.data, dtype=np.uint8, count=e.length, offset=e.offset
        )

    @cached_property
    def _native_raw(self):
        """One native batch parse+flatten of every cmap-mapped glyph
        (csrc vg_glyf_rings for TrueType, vg_cff_rings for CFF/OTF —
        the host ingest hot path; ~100× the fontTools pen walk).
        Returns (names_sorted, pts [N,2] f64, ring_lens [R] i32,
        glyph_nrings [n] i32 — −1 marks a glyph the native parser
        rejected) or None when unavailable."""
        import numpy as np

        from ..constants import FLATTEN_TOLERANCE_SQ
        from ..proto import native

        glyf = self._glyf_raw
        cff = self._cff_raw if glyf is None else None
        if (glyf is None and cff is None) or not native.available():
            return None
        names = sorted(set(self._cmap.values()))
        gid_of = self.font.getReverseGlyphMap()
        gids = np.array([gid_of[n] for n in names], dtype=np.uint32)
        if glyf is not None:
            res = native.glyf_rings(glyf[0], glyf[1], gids, FLATTEN_TOLERANCE_SQ)
        else:
            res = native.cff_rings(cff, gids, FLATTEN_TOLERANCE_SQ)
        if res is None:
            return None
        return (names, *res)

    @cached_property
    def _native_rings(self):
        """name → list of (K, 2) f64 rings (font units) for every
        cmap-mapped glyph, sliced from `_native_raw`. None when
        unavailable; per-glyph None values mark glyphs the native parser
        rejected (pen fallback)."""
        raw = self._native_raw
        if raw is None:
            return None
        names, pts, ring_lens, glyph_nrings = raw
        out: dict = {}
        p = 0
        r = 0
        for i, name in enumerate(names):
            k = int(glyph_nrings[i])
            if k < 0:
                out[name] = None  # unsupported → pen fallback
                continue
            rings = []
            for _ in range(k):
                ln = int(ring_lens[r])
                rings.append(pts[p : p + ln])
                p += ln
                r += 1
            out[name] = rings
        return out

    def _pen_flat(self):
        """Flat ring arrays for every cmap-mapped glyph with the
        fontTools pen filling in whatever the native parser couldn't
        handle (CFF2 fonts, native-rejected charstrings, or the whole
        set when the native library is absent). One pen walk per glyph
        NAME (the old per-glyph fallback re-walked per CODEPOINT), and
        the result feeds the same vectorized `build_cores` pass as the
        native path — so degraded fonts keep the batched host-prep
        fast path. Returns
        (names, pts [N,2] f64, ring_lens [R] i32, glyph_nrings [n] i32,
        −1 marking glyphs whose pen walk failed)."""
        import numpy as np

        names = sorted(set(self._cmap.values()))
        native = self._native_rings  # None, or per-name rings/None
        pts_parts: list = []
        lens: list[int] = []
        nrings: list[int] = []
        for name in names:
            rings = native.get(name) if native is not None else None
            if rings is None:
                try:
                    acc = RingAccumulator()
                    self._glyph_set[name].draw(RingPen(self._glyph_set, acc))
                    rings = acc.finish()
                except Exception:
                    nrings.append(-1)  # truly malformed: per-glyph error
                    continue
            nrings.append(len(rings))
            for ring in rings:
                pts_parts.append(np.asarray(ring, dtype=np.float64))
                lens.append(len(ring))
        pts = (
            np.concatenate(pts_parts, axis=0)
            if pts_parts
            else np.zeros((0, 2), dtype=np.float64)
        )
        return (
            names,
            pts,
            np.asarray(lens, dtype=np.int32),
            np.asarray(nrings, dtype=np.int32),
        )

    @cached_property
    def _cores_and_mode(self):
        """(cores dict, key mode): the per-glyph `GlyphCore` table and
        how it is keyed — ``"gid"`` on the all-native fast path (cmap/
        hmtx/outlines all parsed natively; no fontTools post/glyphOrder
        decompile ever runs), ``"name"`` otherwise. `glyph_key` returns
        the matching key per codepoint."""
        import numpy as np

        from ..constants import FLATTEN_TOLERANCE_SQ
        from ..proto import native
        from ..render.metrics import build_cores

        idx = self._native_index
        if idx is not None:
            cps, gids, adv = idx
            glyf = self._glyf_raw
            cff = self._cff_raw if glyf is None else None
            res = None
            ugids = np.unique(gids).astype(np.uint32)
            if glyf is not None:
                res = native.glyf_rings(
                    glyf[0], glyf[1], ugids, FLATTEN_TOLERANCE_SQ
                )
            elif cff is not None:
                res = native.cff_rings(cff, ugids, FLATTEN_TOLERANCE_SQ)
            if res is not None and int(res[2].min(initial=0)) >= 0:
                pts, ring_lens, glyph_nrings = res
                advances = adv[ugids].astype(np.float64)
                cores = build_cores(
                    ugids.tolist(), advances, self.units_per_em,
                    pts, ring_lens, glyph_nrings,
                )
                return cores, "gid"

        raw = self._native_raw
        if raw is not None and int(raw[3].min(initial=0)) >= 0:
            names, pts, ring_lens, glyph_nrings = raw
        else:
            names, pts, ring_lens, glyph_nrings = self._pen_flat()
        advances = np.array(
            [self.hor_advance(n) for n in names], dtype=np.float64
        )
        cores = build_cores(
            names, advances, self.units_per_em, pts, ring_lens, glyph_nrings
        )
        return cores, "name"

    @property
    def prep_cores(self):
        """Key → `render.metrics.GlyphCore` for every cmap-mapped
        glyph: metrics + device transport caches computed in ONE
        vectorized pass over the font (`render.metrics.build_cores`).
        Keys are whatever `glyph_key` returns (glyph ids on the
        all-native path, names otherwise); every codepoint mapping to
        a glyph shares its core. Glyphs the native parser can't handle
        (CFF2, rejected charstrings, absent native library) are
        pen-walked into the same flat arrays (`_pen_flat`), so every
        font keeps the vectorized metrics path; per-key None cores
        remain only for glyphs whose pen walk itself failed."""
        return self._cores_and_mode[0]

    def glyph_key(self, codepoint: int):
        """The `prep_cores` dict key for a codepoint (gid or name per
        the core table's mode); None when the codepoint is unmapped."""
        if self._cores_and_mode[1] == "gid":
            return self._gid_map.get(codepoint)
        return self.glyph_name(codepoint)

    def outline_rings(self, glyph_name: str):
        """Flattened closed rings (font units, float64) for a glyph."""
        cache = self._native_rings
        if cache is not None:
            rings = cache.get(glyph_name, None)
            if rings is not None:
                return rings
        acc = RingAccumulator()
        pen = RingPen(self._glyph_set, acc)
        self._glyph_set[glyph_name].draw(pen)
        return acc.finish()

    def outline_curves(self, glyph_name: str):
        """Cubic-curve soup [C, 4, 2] (font units, float64) for the
        differentiable model path."""
        import numpy as np

        pen = CurvePen(self._glyph_set)
        self._glyph_set[glyph_name].draw(pen)
        if not pen.curves:
            return np.zeros((0, 4, 2))
        return np.asarray(pen.curves, dtype=np.float64)
