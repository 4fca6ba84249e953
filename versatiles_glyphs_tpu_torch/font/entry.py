"""Font file ingestion: metadata, coverage, advances and outlines.

Host-side equivalent of the reference's `FontFileEntry` + `FontMetadata`
(`reference/src/font/file_entry.rs`, `src/font/metadata.rs`), read
without fontTools: the sfnt directory, ``head`` and ``name`` by
`font.sfnt`; the cmap union, hmtx advances and the glyf, CFF and CFF2
outlines by the native parsers (`proto.native`, ``csrc/vg_native.cpp``),
which read every font the JAX package reads through fontTools 4.61.1 and
give what it gives, bit for bit: flattened rings for the render (one
batch a font, into `render.metrics.build_cores`) and the segments from
which `curve_soup` builds the fit path's cubics. A glyph fontTools'
pen fails to draw is −1 in the batch (a None core), as the JAX package
records it; a font fontTools fails to read raises ValueError.
Glyphs are keyed by glyph id: `glyph_key` gives a codepoint's, and
`hor_advance`, `outline_rings`, `outline_curves` and `prep_cores` take it.

Where a font's cmap, hhea, maxp or hmtx is missing, runs past the end
of the file or is short, `FontFileEntry` reads the index as fontTools'
tables give it (the JAX package's route for such a font): advances 0
where fontTools has no metric, and ValueError where it raises.
"""

from __future__ import annotations

import struct
from functools import cached_property

import numpy as np

from ..constants import FLATTEN_TOLERANCE_SQ
from ..proto import native
from .names import generate_name, parse_font_name
from .sfnt import Sfnt

# Segment kinds of `proto.native.glyf_curves` / `cff_curves`.
MOVE, LINE, QUAD, CUBIC, CLOSE = range(5)


def curve_soup(kinds: np.ndarray, pts: np.ndarray):
    """The cubic soup of native segment records (kinds [M], pts [M, 4, 2]:
    the current point, then the segment's points): (curves [M, 4, 2],
    keep [M] bool), the rules of the JAX package's CurvePen (a fontTools
    pen) with its operation order. A line becomes a cubic with control points at the thirds, a
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


def _fonttools_cmap(cmap: bytes) -> bool:
    """Whether a cmap has a unicode subtable of format 2 or 13 (declared
    length not 0): the JAX package's native reader lacks those, and
    reads the whole font's index through fontTools."""
    n = struct.unpack(">H", cmap[2:4])[0] if len(cmap) >= 4 else 0
    for t in range(n):
        rec = cmap[4 + 8 * t:12 + 8 * t]
        if len(rec) < 8:
            break
        pid, eid, off = struct.unpack(">HHI", rec)
        if not (pid == 0 or (pid == 3 and eid in (0, 1, 10))):
            continue
        head = cmap[off:off + 8]
        if len(head) < 4:
            continue
        fmt = struct.unpack(">H", head[:2])[0]
        if fmt == 2 and struct.unpack(">H", head[2:4])[0]:
            return True
        if fmt == 13 and len(head) == 8 and struct.unpack(">I", head[4:8])[0]:
            return True
    return False


def _side_bearings(hmtx: bytes, num_h: int, num_g: int):
    """hmtx's left side bearing of each of ``num_g`` glyphs (int16): the
    long metrics', then the trailing array's; None where the table is
    too short for them."""
    if num_h < 1 or len(hmtx) < 4 * num_h + 2 * (num_g - num_h):
        return None
    lsb = np.empty(num_g, np.int16)
    lsb[:num_h] = np.frombuffer(hmtx[:4 * num_h], ">i2")[1::2]
    lsb[num_h:] = np.frombuffer(hmtx[4 * num_h:4 * num_h + 2 * (num_g - num_h)], ">i2")
    return lsb


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
    not a font or that fontTools fails to read."""

    def __init__(self, data: bytes):
        native.require()
        self.data = data
        self.sfnt = Sfnt(data)
        family, ps_name = self.sfnt.names()
        self.label = family or ps_name or "(unnamed)"
        self.units_per_em: int = self.sfnt.units_per_em
        try:
            self._cps, self._gids, self._advances, self._lsbs = self._index()
        except ValueError as e:
            raise ValueError(f"font {self.label!r}: {e}") from None
        self.metadata = FontMetadata(family or "", ps_name or "", self._cps.tolist())

    # -- index: codepoints, glyph ids, advances -----------------------------

    def _index(self):
        """(cps u32 sorted, gids u32, advances u16 by gid, lsbs i16 by gid
        or None): the native cmap union, and the advances of hmtx as the
        JAX package reads them (natively where its native reader
        applies, else — a table missing or short, or a unicode cmap
        subtable its native reader lacks — as fontTools' tables give
        them, `_tolerant_metrics`). The side bearings are always
        fontTools' (its glyph set's: a glyph drawn by fontTools' route is
        moved by lsb - xMin), None where fontTools has no glyph set."""
        s = self.sfnt
        if "cmap" not in s:
            raise ValueError("Font has no cmap table")
        if not s.covered("cmap"):
            raise ValueError("its 'cmap' table runs past the end of the file")
        cmap = s.table("cmap")
        cps, gids = native.cmap_union(np.frombuffer(cmap, np.uint8))
        num_h, num_g = s.u16("hhea", 34), s.u16("maxp", 4)
        adv = None
        if (all(s.covered(t) for t in ("hmtx", "hhea", "maxp")) and None not in (num_h, num_g)
                and not _fonttools_cmap(cmap)):
            adv = native.hmtx_advances(np.frombuffer(s.table("hmtx"), np.uint8), num_h, num_g)
        if adv is not None:
            keep = gids < num_g  # guard malformed cmaps, as the JAX native reader does
            if not keep.all():
                cps, gids = cps[keep], gids[keep]
            try:  # fontTools' reading of hmtx (its glyph set), or none
                lsb = self._tolerant_metrics()[1]
            except ValueError:
                lsb = None
            return cps, gids, adv, lsb
        adv, lsb = self._tolerant_metrics()
        if len(gids) and int(gids.max()) >= len(adv):
            raise ValueError(f"its 'cmap' maps glyph {int(gids.max())}, past its "
                             f"{len(adv)} glyphs")
        return cps, gids, adv, lsb

    def _table_for_fonttools(self, tag: str) -> bytes:
        """A listed table's bytes; ValueError where it runs past the end
        of the file (fontTools' load asserts its length)."""
        if not self.sfnt.covered(tag):
            raise ValueError(f"its '{tag}' table runs past the end of the file")
        return self.sfnt.table(tag)

    def _num_glyphs(self) -> int | None:
        """``maxp.numGlyphs`` as fontTools decodes maxp (exactly 6 bytes
        of version 0.5 or 32 of 1.0); None without a maxp."""
        if "maxp" not in self.sfnt:
            return None
        raw = self._table_for_fonttools("maxp")
        if len(raw) < 6 or len(raw) != (6 if raw[:4] == b"\0\0\x50\0" else 32):
            raise ValueError("its 'maxp' table, which fontTools cannot decode")
        return struct.unpack(">H", raw[4:6])[0]

    def _tolerant_metrics(self):
        """(advances u16, lsbs i16 or None) of each glyph of fontTools'
        glyph order, as fontTools' hmtx gives them: advance 0 and no side
        bearings (no glyph set) without an hmtx; numberOfHMetrics is the
        glyph count without an hhea, and capped at it; ValueError where
        fontTools raises (a table cut short, an hhea or maxp it cannot
        decode, an hmtx shorter than its metrics or without the maxp it
        reads, no long metric at all)."""
        s = self.sfnt
        if "CFF " in s:  # the glyph order is the CFF charset
            n = native.cff_glyph_count(np.frombuffer(self._table_for_fonttools("CFF "), np.uint8))
            if n < 0:
                raise ValueError("its 'CFF ' table, which does not parse")
        else:
            n = self._num_glyphs()
            if n is None:
                raise ValueError("a font with no 'maxp' table")
        adv = np.zeros(n, np.uint16)
        if "hmtx" not in s:
            return adv, None
        num_g = self._num_glyphs()
        if num_g is None:  # fontTools keeps a half-read hmtx, which fails when read again
            raise ValueError("its 'hmtx' table, which cannot be read without a 'maxp'")
        num_h = num_g
        if "hhea" in s:
            hhea = self._table_for_fonttools("hhea")
            if len(hhea) != 36:
                raise ValueError("its 'hhea' table, which fontTools cannot decode")
            num_h = min(struct.unpack(">H", hhea[34:36])[0], num_g)
        hmtx = self._table_for_fonttools("hmtx")
        if len(hmtx) < 4 * num_h + 2 * (num_g - num_h):
            raise ValueError("its short 'hmtx' table")
        if num_h == 0:
            raise ValueError("its 'hmtx' table, which holds no long metric")
        if num_g > n:
            raise ValueError(f"its 'maxp' counts {num_g} glyphs, past its {n}")
        long_adv = np.frombuffer(hmtx[:4 * num_h], ">u2")[::2]
        adv[:num_h] = long_adv
        adv[num_h:num_g] = long_adv[-1]
        return adv, _side_bearings(hmtx, num_h, num_g)

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
        ("CFF2", table bytes), or None (no outline table: every glyph −1,
        as fontTools draws none)."""
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
        for tag in ("CFF ", "CFF2"):
            if tag in s:
                return tag, np.frombuffer(s.table(tag), np.uint8)
        return None

    def _native_rings(self, ugids: np.ndarray):
        """(pts [N, 2] f64, ring_lens [R] i32, glyph_nrings [n] i32) of
        the glyphs from one native batch parse and flatten (csrc
        vg_glyf_rings / vg_cff_rings); −1 marks a glyph fontTools' pen
        fails to draw too."""
        table = self._outline_table
        res = None
        ft = self._lsbs is not None  # fontTools has a glyph set (a readable hmtx)
        if table is not None and table[0] == "glyf":
            res = native.glyf_rings(table[1], table[2], ugids, FLATTEN_TOLERANCE_SQ, self._lsbs, ft)
        elif table is not None:
            res = native.cff_rings(table[1], ugids, FLATTEN_TOLERANCE_SQ, ft)
        if res is None:
            res = (np.zeros((0, 2)), np.zeros(0, np.int32), np.full(len(ugids), -1, np.int32))
        return res

    @cached_property
    def _flat(self):
        """(gids u32 sorted unique, pts [N, 2] f64, ring_lens [R] i32,
        glyph_nrings [n] i32) of every mapped glyph."""
        ugids = np.unique(self._gids).astype(np.uint32)
        return (ugids, *self._native_rings(ugids))

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
        remains only for a glyph fontTools' pen fails to draw."""
        from ..render.metrics import build_cores

        ugids, pts, ring_lens, nrings = self._flat
        advances = self._advances[ugids].astype(np.float64)
        return build_cores(ugids.tolist(), advances, self.units_per_em, pts, ring_lens, nrings)

    def _failed(self, gid: int) -> ValueError:
        tag = self._outline_table[0].strip() if self._outline_table else "no outline"
        return ValueError(f"font {self.label!r}: glyph {gid} of its '{tag}' table "
                          "cannot be drawn")

    def outline_rings(self, gid: int):
        """Flattened closed rings (font units, float64) of a glyph;
        ValueError for a glyph fontTools' pen fails to draw."""
        if gid in self._ring_map:
            rings = self._ring_map[gid]
        else:
            rings = self._split_rings(*self._native_rings(np.array([gid], np.uint32)))[0]
        if rings is None:
            raise self._failed(gid)
        return rings

    @cached_property
    def _curve_map(self) -> dict:
        """gid → cubic soup [C, 4, 2] of every mapped glyph."""
        return self._native_curves(np.unique(self._gids).astype(np.uint32))

    def _native_curves(self, ugids: np.ndarray) -> dict:
        """gid → cubic soup [C, 4, 2] from one native walk of the glyphs'
        segments (csrc vg_glyf_curves / vg_cff_curves), None where
        fontTools' pen fails to draw a glyph."""
        table = self._outline_table
        if table is None or self._lsbs is None:  # no glyph set in fontTools
            return dict.fromkeys(ugids.tolist())
        if table[0] == "glyf":
            kinds, pts, nrecs = native.glyf_curves(table[1], table[2], ugids, self._lsbs)
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
        differentiable model path; empty as [0, 4, 2]; ValueError for a
        glyph fontTools' pen fails to draw."""
        cmap = self._curve_map
        curves = cmap[gid] if gid in cmap else self._native_curves(np.array([gid], np.uint32))[gid]
        if curves is None:
            raise self._failed(gid)
        return curves if len(curves) else np.zeros((0, 4, 2))
