"""Font file ingestion: metadata, coverage, advances and outlines.

Host-side equivalent of the reference's `FontFileEntry` + `FontMetadata`
(`reference/src/font/file_entry.rs`, `src/font/metadata.rs`), read
without fontTools: the sfnt directory, ``head`` and ``name`` by
`font.sfnt`; the cmap union, hmtx advances and the glyf/CFF outlines by
the native parsers (`proto.native`, ``csrc/vg_native.cpp``), which walk
outlines with fontTools' pen semantics bit for bit: flattened rings for
the render (one batch a font, into `render.metrics.build_cores`) and
the segments from which `curve_soup` builds the fit path's cubics.
Glyphs are keyed by glyph id: `glyph_key` gives a codepoint's, and
`hor_advance`, `outline_rings`, `outline_curves` and `prep_cores` take it.

fontTools is needed, and imported where it is used, only for what the
native parsers do not cover:

- a unicode cmap subtable of a format other than 0, 4, 6, 12 and 14:
  the codepoints, glyph ids and advances then come from fontTools'
  ``TTFont`` (the same union as the JAX package's fallback);
- outlines in no 'glyf' and no 'CFF ' table (CFF2), and a glyph the
  native walkers reject (seac accents, point-matched components, CFF
  arithmetic operators): those outlines are drawn with its pens
  (`font.pens`).

Where fontTools is not importable such a font raises ValueError naming
the font and the table: for the cmap and the outline table when the
entry is made, for a rejected glyph when its outline is first read.
"""

from __future__ import annotations

import io
from functools import cached_property

import numpy as np

from ..constants import FLATTEN_TOLERANCE_SQ
from ..proto import native
from .names import generate_name, parse_font_name
from .sfnt import Sfnt

# Unicode cmap subtable formats the native union reads (14, variation
# sequences, maps no codepoint in fontTools' union either).
NATIVE_CMAP_FORMATS = (0, 4, 6, 12, 14)
# Segment kinds of `proto.native.glyf_curves` / `cff_curves`.
MOVE, LINE, QUAD, CUBIC, CLOSE = range(5)


def curve_soup(kinds: np.ndarray, pts: np.ndarray):
    """The cubic soup of native segment records (kinds [M], pts [M, 4, 2]:
    the current point, then the segment's points): (curves [M, 4, 2],
    keep [M] bool), the rules of `font.pens` CurvePen with its operation
    order. A line becomes a cubic with control points at the thirds, a
    quadratic is degree-elevated by 2/3, a cubic stays, and a close whose
    current point is not the contour's start becomes a closing line."""
    s, a, e = pts[:, 0], pts[:, 1], pts[:, 3]
    line = (kinds == LINE) | ((kinds == CLOSE) & np.any(s != e, axis=1))
    quad = kinds == QUAD
    out = pts.copy()
    sl, el = s[line], e[line]
    out[line, 1] = sl + (el - sl) / 3.0
    out[line, 2] = sl + 2.0 * (el - sl) / 3.0
    sq, cq, eq = s[quad], a[quad], e[quad]
    out[quad, 1] = sq + 2.0 / 3.0 * (cq - sq)
    out[quad, 2] = eq + 2.0 / 3.0 * (cq - eq)
    return out, line | quad | (kinds == CUBIC)


def _cmap_why(cmap: bytes) -> str:
    """Which part of a cmap table the native union rejected."""
    if len(cmap) >= 4:
        n = int.from_bytes(cmap[2:4], "big")
        for t in range(n):
            rec = cmap[4 + 8 * t: 12 + 8 * t]
            if len(rec) < 8:
                break
            plat, enc = int.from_bytes(rec[:2], "big"), int.from_bytes(rec[2:4], "big")
            off = int.from_bytes(rec[4:], "big")
            if not (plat == 0 or (plat == 3 and enc in (0, 1, 10))):
                continue
            fmt = cmap[off:off + 2]
            if len(fmt) == 2 and int.from_bytes(fmt, "big") not in NATIVE_CMAP_FORMATS:
                return (f"its 'cmap' subtable ({plat}, {enc}) of format "
                        f"{int.from_bytes(fmt, 'big')}")
    return "its malformed 'cmap' table"


class FontMetadata:
    """Extracted font properties: family/style/weight/width + codepoint
    coverage (union of all unicode cmap subtables, mapped codepoints
    only — `src/font/metadata.rs:103-118`)."""

    def __init__(self, family: str, ps_name: str, codepoints: list[int]):
        self.name = family
        self.family, self.style, self.weight, self.width = parse_font_name(family, ps_name)
        self.codepoints: list[int] = codepoints

    def generate_name(self) -> str:
        return generate_name(self.family, self.style, self.weight, self.width)

    def __repr__(self) -> str:
        return (
            f"FontMetadata {{ family: {self.family}, style: {self.style}, "
            f"weight: {self.weight}, width: {self.width}, "
            f"codepoints: {len(self.codepoints)} }}"
        )


class FontFileEntry:
    """One parsed font file: raw bytes + sfnt directory + metadata +
    outline access by glyph id. Mirrors `src/font/file_entry.rs`
    (identity) and the outline path of `src/render/renderer.rs:103-116`
    (lookup + advance). Raises RuntimeError when the native library is
    not built (`proto.native.require`), ValueError for a file that is
    not a font or that needs fontTools where there is none."""

    def __init__(self, data: bytes):
        native.require()
        self.data = data
        self.sfnt = Sfnt(data)
        family, ps_name = self.sfnt.names()
        self.label = family or ps_name or "(unnamed)"
        self.units_per_em: int = self.sfnt.units_per_em
        self._tt = None
        index = self._native_index()
        if isinstance(index, str):
            index = self._fonttools_index(index)
        self._cps, self._gids, self._advances = index
        if self._outline_table is None:
            # No native route for any outline: fail now without fontTools.
            self._fonttools(self._outlines_of("the outlines"))
        self.metadata = FontMetadata(family or "", ps_name or "", self._cps.tolist())

    # -- fontTools, for the fallback only ---------------------------------

    def _fonttools(self, what: str):
        """fontTools' TTFont of the file; ValueError naming the font and
        ``what`` needs it when fontTools is not importable."""
        if self._tt is None:
            try:
                from fontTools.ttLib import TTFont
            except ImportError:
                raise ValueError(f"font {self.label!r}: fontTools is needed for {what}, "
                                 "and it is not installed") from None
            self._tt = TTFont(io.BytesIO(self.data), fontNumber=0, lazy=True)
        return self._tt

    def _glyph_name(self, gid: int, what: str) -> str:
        return self._fonttools(what).getGlyphOrder()[gid]

    # -- index: codepoints, glyph ids, advances -----------------------------

    def _native_index(self):
        """(cps u32 sorted, gids u32, advances u16 by gid) from the raw
        cmap/hmtx/hhea/maxp tables by the native parsers, or why they do
        not cover this font (str)."""
        s = self.sfnt
        if "cmap" not in s:
            raise ValueError("Font has no cmap table")
        for tag in ("cmap", "hmtx", "hhea", "maxp"):
            if tag not in s:
                return f"a font with no '{tag}' table"
            if not s.covered(tag):
                # Over-declared directory length (fontTools tolerates
                # the short read).
                return f"its '{tag}' table, which runs past the end of the file"
        cmap = s.table("cmap")
        res = native.cmap_union(np.frombuffer(cmap, np.uint8))
        if res is None:
            return _cmap_why(cmap)
        cps, gids = res
        num_h, num_g = s.u16("hhea", 34), s.u16("maxp", 4)
        if num_h is None or num_g is None:
            return "its short 'hhea' or 'maxp' table"
        adv = native.hmtx_advances(np.frombuffer(s.table("hmtx"), np.uint8), num_h, num_g)
        if adv is None:
            return "its short 'hmtx' table"
        keep = gids < num_g  # guard malformed cmaps; fontTools would err
        if not keep.all():
            cps, gids = cps[keep], gids[keep]
        return cps, gids, adv

    def _fonttools_index(self, why: str):
        """The index through fontTools: the union over its unicode cmap
        subtables (first subtable to map a codepoint wins), names turned
        into glyph ids, advances from its hmtx (0 where it has none)."""
        tt = self._fonttools(why)
        cmap = tt.get("cmap")
        if cmap is None:
            raise ValueError("Font has no cmap table")
        union: dict = {}
        for sub in cmap.tables:
            if sub.isUnicode():
                for cp, name in sub.cmap.items():
                    union.setdefault(cp, name)
        gid_of = tt.getReverseGlyphMap()
        cps = np.array(sorted(union), dtype=np.uint32)
        gids = np.array([gid_of[union[int(cp)]] for cp in cps], dtype=np.uint32)
        try:
            metrics = tt["hmtx"].metrics
        except KeyError:
            metrics = {}
        adv = np.array([metrics.get(n, (0, 0))[0] for n in tt.getGlyphOrder()], dtype=np.uint16)
        return cps, gids, adv

    @cached_property
    def _gid_map(self) -> dict:
        """cp → glyph id."""
        return dict(zip(self._cps.tolist(), self._gids.tolist()))

    def glyph_key(self, codepoint: int):
        """The glyph id of a codepoint: the key of `prep_cores`,
        `hor_advance`, `outline_rings` and `outline_curves`; None when the
        codepoint has no glyph (reference: `face.glyph_index(cp)`
        returning None skips the glyph)."""
        return self._gid_map.get(codepoint)

    def hor_advance(self, gid: int) -> int:
        return int(self._advances[gid]) if 0 <= gid < len(self._advances) else 0

    # -- outlines -----------------------------------------------------------

    @cached_property
    def _outline_table(self):
        """("glyf", glyf bytes, loca u32 offsets), ("CFF ", table bytes),
        or None (CFF2 or no outline table): the native walkers' input."""
        s = self.sfnt
        if "glyf" in s and "loca" in s:
            raw = s.table("loca")
            if s.index_to_loc_format == 0:
                raw = raw[: len(raw) // 2 * 2]
                loca = np.frombuffer(raw, dtype=">u2").astype(np.uint32) * 2
            else:
                raw = raw[: len(raw) // 4 * 4]
                loca = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
            return "glyf", np.frombuffer(s.table("glyf"), np.uint8), loca
        if "CFF " in s:
            return "CFF ", np.frombuffer(s.table("CFF "), np.uint8)
        return None

    def _outlines_of(self, what: str) -> str:
        """``what`` of the font's outline table, for a message."""
        tag = next((t for t in ("glyf", "CFF ", "CFF2") if t in self.sfnt), None)
        return f"{what} of its '{tag}' table" if tag else f"{what} of a font with no outline table"

    def _rejected(self, gid: int) -> str:
        return self._outlines_of(f"glyph {gid}")

    def _pen_rings(self, name: str):
        """A glyph's rings drawn by fontTools' pen (the fallback)."""
        from ..ops.flatten import RingAccumulator
        from .pens import pen_classes

        glyph_set = self._tt.getGlyphSet()
        acc = RingAccumulator()
        glyph_set[name].draw(pen_classes()[0](glyph_set, acc))
        return acc.finish()

    @cached_property
    def _flat(self):
        """(gids u32 sorted unique, pts [N, 2] f64, ring_lens [R] i32,
        glyph_nrings [n] i32) of every mapped glyph: one native batch
        parse and flatten (csrc vg_glyf_rings / vg_cff_rings), the glyphs
        it rejects drawn by fontTools' pen; −1 marks a glyph whose pen
        walk failed too."""
        ugids = np.unique(self._gids).astype(np.uint32)
        table = self._outline_table
        res = None
        if table is not None and table[0] == "glyf":
            res = native.glyf_rings(table[1], table[2], ugids, FLATTEN_TOLERANCE_SQ)
        elif table is not None:
            res = native.cff_rings(table[1], ugids, FLATTEN_TOLERANCE_SQ)
        if res is None:
            res = (np.zeros((0, 2)), np.zeros(0, np.int32), np.full(len(ugids), -1, np.int32))
        pts, ring_lens, nrings = res
        if int(nrings.min(initial=0)) >= 0:
            return ugids, pts, ring_lens, nrings
        rings = self._split_rings(pts, ring_lens, nrings)
        parts, lens, counts = [], [], []
        for gid, rs in zip(ugids.tolist(), rings):
            if rs is None:
                name = self._glyph_name(gid, self._rejected(gid))
                try:
                    rs = self._pen_rings(name)
                except Exception:
                    counts.append(-1)  # truly malformed: per-glyph error
                    continue
            counts.append(len(rs))
            for r in rs:
                parts.append(np.asarray(r, dtype=np.float64))
                lens.append(len(r))
        pts = np.concatenate(parts, axis=0) if parts else np.zeros((0, 2), np.float64)
        return (ugids, pts, np.asarray(lens, dtype=np.int32),
                np.asarray(counts, dtype=np.int32))

    @staticmethod
    def _split_rings(pts, ring_lens, nrings) -> list:
        """Per glyph, its list of (K, 2) rings (views), None where −1."""
        out = []
        p = r = 0
        for k in nrings.tolist():
            if k < 0:
                out.append(None)
                continue
            rings = []
            for ln in ring_lens[r:r + k].tolist():
                rings.append(pts[p:p + ln])
                p += ln
            r += k
            out.append(rings)
        return out

    @cached_property
    def _ring_map(self) -> dict:
        """gid → list of (K, 2) f64 rings, None for a failed glyph."""
        ugids, pts, ring_lens, nrings = self._flat
        return dict(zip(ugids.tolist(), self._split_rings(pts, ring_lens, nrings)))

    @cached_property
    def prep_cores(self):
        """Glyph id → `render.metrics.GlyphCore` for every cmap-mapped
        glyph: metrics + device transport caches computed in ONE
        vectorized pass over the font (`render.metrics.build_cores`);
        every codepoint mapping to a glyph shares its core. A None core
        remains only for a glyph whose outline no parser could walk."""
        from ..render.metrics import build_cores

        ugids, pts, ring_lens, nrings = self._flat
        advances = self._advances[ugids].astype(np.float64)
        return build_cores(ugids.tolist(), advances, self.units_per_em, pts, ring_lens, nrings)

    def outline_rings(self, gid: int):
        """Flattened closed rings (font units, float64) of a glyph."""
        rings = self._ring_map.get(gid)
        if rings is None:
            rings = self._pen_rings(self._glyph_name(gid, self._rejected(gid)))
        return rings

    @cached_property
    def _curve_map(self) -> dict:
        """gid → cubic soup [C, 4, 2] of every mapped glyph."""
        return self._native_curves(np.unique(self._gids).astype(np.uint32))

    def _native_curves(self, ugids: np.ndarray) -> dict:
        """gid → cubic soup [C, 4, 2] from one native walk of the glyphs'
        segments (csrc vg_glyf_curves / vg_cff_curves), None where the
        walker rejected a glyph."""
        table = self._outline_table
        if table is None:
            return dict.fromkeys(ugids.tolist())
        if table[0] == "glyf":
            kinds, pts, nrecs = native.glyf_curves(table[1], table[2], ugids)
        else:
            kinds, pts, nrecs = native.cff_curves(table[1], ugids)
        curves, keep = curve_soup(kinds, pts)
        out: dict = {}
        r = 0
        for gid, m in zip(ugids.tolist(), nrecs.tolist()):
            if m < 0:
                out[gid] = None
                continue
            out[gid] = np.ascontiguousarray(curves[r:r + m][keep[r:r + m]])
            r += m
        return out

    def outline_curves(self, gid: int):
        """Cubic-curve soup [C, 4, 2] (font units, float64) for the
        differentiable model path; empty as [0, 4, 2]."""
        cmap = self._curve_map
        curves = cmap[gid] if gid in cmap else self._native_curves(np.array([gid], np.uint32))[gid]
        if curves is None:
            from .pens import pen_classes

            name = self._glyph_name(gid, self._rejected(gid))
            glyph_set = self._tt.getGlyphSet()
            pen = pen_classes()[1](glyph_set)
            glyph_set[name].draw(pen)
            curves = np.asarray(pen.curves, dtype=np.float64)
        return curves if len(curves) else np.zeros((0, 4, 2))
