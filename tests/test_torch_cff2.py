"""The port reads every font the JAX package reads through fontTools,
with fontTools refused, and gives what the JAX package gives, on the CPU.

The port's side of every comparison runs inside `fonttools_refused`:
fontTools' modules are taken out of ``sys.modules`` and the import
system refuses them, and no fontTools module may be loaded when it ends.
The JAX side is the JAX package's `FontFileEntry` on the same bytes
(fontTools 4.61.1: its native readers where they apply, its fontTools
pens and tables elsewhere). Per codepoint: the advance (left out where
the JAX entry's ``hor_advance`` raises because fontTools cannot decode
an hhea its native reader read), the glyph's
prep (advance, box and ``chain16`` bits) or −1 (a None core) in both,
its rings and its cubic soup (or both raise; a glyph whose prep failed
is read again by a fresh JAX entry, as fontTools leaves a glyph it
failed to decompile half-read); a font either side refuses, both refuse.

(a) cmap subtables of formats 2 and 13 from raw bytes (single-byte and
two-byte codes, a code set twice, an idDelta wrapping to glyph 0,
many-to-one ranges, overlapping groups, a zero length), and formats 8
and 10, which fontTools 4.61.1 has no decoder for: both refuse a font
with such a unicode subtable, and both skip one off the unicode
platforms; format 2 tables made by hypothesis against fontTools'
``cmap_format_2`` decompile.
(b) CFF2: `utils.synth_font.build_otf2_curved` (blend in charstrings,
subrs and the Private DICT, vsindex, FDSelect formats 0, 3 and 4), and
charstrings of FontBuilder's CFF2 at the edges of blend and vsindex.
(c) The Type 2 walker where the native walk gives up or fontTools
differs from it: arithmetic (``div`` works, the rest raise), a drawing
operator before a moveto, operators after ``endchar``, operand counts
fontTools unpacks or rejects, hint masks, flex with 16.16 operands;
seac accents (base and accent, a missing accent, codes out of range).
(d) glyf: point-matched components (fontTools raises: −1 in both),
cubic contours (flag 0x80), mixed and odd cubic runs, a side bearing
other than xMin, composites 12 deep.
(e) The index where hhea, maxp or hmtx is missing, cut short or runs
past the end of the file; malformed structures the JAX package's native
readers accept and fontTools rejects (a flag repeat past a glyph's
points, a contour count below -1, a Private DICT with operands left
over), a contour end past the points (−1, as fontTools' pen fails), and
a format 13 table of too many codes (refused).
(f) The four CJK Mac name codecs against ``NameRecord.toUnicode``.
(g) `build_otf_curved` (CID-keyed and name-keyed) and
`build_otf2_curved` against fontTools: it opens them and draws
`cjk_outlines`, and FontBuilder's fonts of the same outlines hold the
same cmap, advances, glyph count and names; the CFF2 twin's curves are
the CFF font's.

Tolerance: none; every comparison is exact (floats by their bits).
"""

import contextlib
import importlib.abc
import io
import logging
import struct
import sys
from array import array
from functools import lru_cache

import numpy as np
import pytest
from fontTools.encodings.StandardEncoding import StandardEncoding
from fontTools.fontBuilder import FontBuilder
from fontTools.misc.psCharStrings import T2CharString
from fontTools.pens.recordingPen import RecordingPen
from fontTools.pens.t2CharStringPen import T2CharStringPen
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import TTFont
from fontTools.ttLib.tables import ttProgram
from fontTools.ttLib.tables._c_m_a_p import CmapSubtable
from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent, GlyphCoordinates
from fontTools.ttLib.tables._n_a_m_e import NameRecord
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import versatiles_glyphs_tpu.font.entry as jx_entry
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf
from versatiles_glyphs_tpu_torch.font import entry as pt_entry
from versatiles_glyphs_tpu_torch.font import sfnt
from versatiles_glyphs_tpu_torch.proto import native
from versatiles_glyphs_tpu_torch.utils import synth_font

logging.getLogger("fontTools").setLevel(logging.ERROR)


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "fontTools":
            raise ImportError("refused for the test: " + name)


@contextlib.contextmanager
def fonttools_refused():
    """fontTools unimportable inside (its loaded modules set aside), and
    none of its modules loaded at the end."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == "fontTools"}
    finder = _Refuse()
    sys.meta_path.insert(0, finder)
    try:
        yield
        loaded = sorted(k for k in sys.modules if k.split(".")[0] == "fontTools")
        assert not loaded, loaded
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def _glyph_view(advance, core, cp, rings, curves):
    prep = None
    if core is not None:
        p = core.make_prep(cp)
        prep = (p.advance, p.width, p.height, p.x0, p.y0, _bits(p.chain16))
    try:
        r = [_bits(x) for x in rings()]
    except Exception:  # noqa: BLE001 - fontTools raises many kinds; the port ValueError
        r = "raises"
    try:
        c = _bits(curves())
    except Exception:  # noqa: BLE001
        c = "raises"
    return advance, prep, r, c


def port_view(data: bytes):
    """The port's reading of a font, fontTools refused: (name, coverage,
    {cp: glyph view}), or "raises"."""
    with fonttools_refused():
        try:
            a = pt_entry.FontFileEntry(data)
        except ValueError:
            return "raises"
        out = {}
        for cp in a.metadata.codepoints:
            key = a.glyph_key(cp)
            out[cp] = _glyph_view(a.hor_advance(key), a.prep_cores.get(key), cp,
                                  lambda: a.outline_rings(key), lambda: a.outline_curves(key))
        return a.metadata.generate_name(), a.metadata.codepoints, out


def _advance(b, name):
    """The JAX entry's ``hor_advance``, which reads fontTools' hmtx even
    where the native index read the advances: "raises" where fontTools
    cannot (the font's prep cores and tree do not need it)."""
    try:
        return b.hor_advance(name)
    except Exception:  # noqa: BLE001
        return "raises"


def jax_view(data: bytes):
    """The JAX package's reading of the same bytes: "raises" where it
    fails on the font (making the entry, or reading an advance or the
    prep cores, as its CLI does)."""
    try:
        b = jx_entry.FontFileEntry(data)
        cps = b.metadata.codepoints
        keys = [(cp, b.glyph_name(cp), b.glyph_key(cp)) for cp in cps]
        metrics = {cp: (_advance(b, name), b.prep_cores.get(key)) for cp, name, key in keys}
    except Exception:  # noqa: BLE001
        return "raises"
    out = {}
    for cp, name, _ in keys:
        # A glyph fontTools failed to draw for the cores is read again by a
        # fresh entry: a failed decompile leaves fontTools' glyph half-read,
        # and a second draw of it gives what the first did not.
        e = b if metrics[cp][1] is not None else jx_entry.FontFileEntry(data)
        out[cp] = _glyph_view(*metrics[cp], cp, lambda: e.outline_rings(name),
                              lambda: jx_entry.FontFileEntry(data).outline_curves(name)
                              if e is not b else e.outline_curves(name))
    return b.metadata.generate_name(), cps, out


def assert_same(data: bytes, min_glyphs: int = 1):
    got, want = port_view(data), jax_view(data)
    if got != "raises" and want != "raises":
        # Where the JAX entry's `hor_advance` raises, its prep's advance stands for it.
        for cp, view in want[2].items():
            if view[0] == "raises" and cp in got[2]:
                got[2][cp] = ("raises",) + got[2][cp][1:]
    assert got == want
    if want != "raises":
        assert len(want[1]) >= min_glyphs
    return got


# -- (a) cmap formats -----------------------------------------------------------


def _with_cmap(records, family="Cmap Sans", n=6) -> bytes:
    """`build_ttf`'s font (glyphs g0..g5 at ids 1..6) with a raw cmap of
    ``records`` [(platform, encoding, subtable bytes)]."""
    return synth_font.with_cmap(build_ttf(n, family=family), records)


_format2, _format13 = synth_font.cmap_format2, synth_font.cmap_format13


def _format_long(fmt, body=b"", length=None) -> bytes:
    """A subtable of format 8 or 10 (32-bit length at offset 4)."""
    n = 12 + len(body)
    return struct.pack(">HHII", fmt, 0, n if length is None else length, 0) + body


CMAP_CASES = {
    # single-byte codes 0x41.. through subHeader 0, two-byte codes 0x8140.. through 1
    "fmt2": [(0, 3, _format2([(0x41, 3, 0, 0), (0x40, 3, 1, 3)], {0x81: 1}, [1, 2, 3, 3, 4, 5]))],
    # a code set twice (high bytes 0x81 and 0x82 share subHeader 1: distinct codes; and
    # subHeader 2's entries run past 0xFF into the next high byte's codes)
    "fmt2_overlap": [(3, 1, _format2([(0x20, 2, 0, 0), (0x40, 2, 0, 2), (0xFE, 4, 0, 4)],
                                     {0x81: 1, 0x82: 1, 0x83: 2}, [1, 2, 3, 4, 5, 6, 1, 2]))],
    # idDelta wrapping a glyph to 0 (unmapped) and past 0xFFFF
    "fmt2_delta": [(0, 3, _format2([(0x30, 4, -2, 0)], {}, [2, 3, 4, 5]))],
    "fmt13": [(3, 10, _format13([(0x41, 0x45, 2), (0x4E00, 0x4E10, 3), (0x20000, 0x20002, 4)]))],
    "fmt13_overlap": [(0, 4, _format13([(0x41, 0x50, 1), (0x48, 0x4A, 5), (0x60, 0x5F, 2)]))],
    # a later group of glyph 0 unmaps nothing (fontTools skips it)
    "fmt13_zero_glyph": [(3, 10, _format13([(0x41, 0x50, 1), (0x44, 0x46, 0)]))],
    "fmt13_bad_length": [(3, 10, _format13([(0x41, 0x45, 2)], length=40))],
    "fmt13_then_fmt4": [(0, 4, _format13([(0x41, 0x42, 6)])), (3, 1, None)],
    "fmt2_short": [(0, 3, _format2([(0x41, 3, 0, 0)], {}, [1, 2, 3])[:300])],
    "fmt8": [(3, 1, _format_long(8, bytes(8192) + struct.pack(">I", 0)))],
    "fmt10": [(3, 10, _format_long(10, struct.pack(">II", 0x41, 3) + struct.pack(">3H", 1, 2, 3)))],
    "fmt10_mac": [(1, 0, _format_long(10, struct.pack(">II", 0x41, 1) + b"\0\1")), (3, 1, None)],
    "fmt10_zero_length": [(0, 3, _format_long(10, b"", length=0)), (3, 1, None)],
}


def _cmap_font(kind) -> bytes:
    records = []
    for pid, eid, data in CMAP_CASES[kind]:
        if data is None:  # the font's own format 4 subtable
            own = TTFont(io.BytesIO(build_ttf(6)))["cmap"].getcmap(3, 1)
            data = own.compile(TTFont(io.BytesIO(build_ttf(6))))
        records.append((pid, eid, data))
    return _with_cmap(records)


@pytest.mark.parametrize("kind", sorted(CMAP_CASES))
def test_cmap_format_matches_jax(kind):
    got = assert_same(_cmap_font(kind), min_glyphs=0)
    refused = kind in ("fmt8", "fmt10", "fmt13_bad_length", "fmt2_short")
    assert (got == "raises") == refused
    if not refused:
        assert len(got[1]) >= 2


@st.composite
def format2_tables(draw):
    n_sub = draw(st.integers(1, 4))
    glyphs = draw(st.lists(st.integers(0, 9), min_size=1, max_size=24))
    subs = []
    for _ in range(n_sub):
        count = draw(st.integers(0, 6))
        at = draw(st.integers(0, max(len(glyphs) - count, 0)))
        subs.append((draw(st.integers(0, 260)), count, draw(st.integers(-12, 12)), at))
    keys = draw(st.dictionaries(st.integers(0, 255), st.integers(0, n_sub - 1), max_size=6))
    return _format2(subs, keys, glyphs + [0] * 8)


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(format2_tables())
def test_cmap_format2_matches_fonttools_decompile(table):
    """The native union of one format 2 subtable against fontTools'
    decompile of it (codes to glyph ids, glyph 0 unmapped)."""
    font = TTFont(io.BytesIO(build_ttf(9)))
    sub = CmapSubtable.newSubtable(2)
    sub.platformID, sub.platEncID = 0, 3
    try:
        sub.decompile(table, font)
        want = {cp: font.getGlyphID(n) for cp, n in sub.cmap.items()}
    except Exception:  # noqa: BLE001
        want = "raises"
    cmap = struct.pack(">HHHHI", 0, 1, 0, 3, 12) + table
    try:
        cps, gids = native.cmap_union(np.frombuffer(cmap, np.uint8))
        got = dict(zip(cps.tolist(), gids.tolist()))
    except ValueError:
        got = "raises"
    assert got == want


@st.composite
def format13_tables(draw):
    groups = []
    for _ in range(draw(st.integers(0, 5))):
        start = draw(st.one_of(st.integers(0, 300), st.integers(0x10FF00, 0x110100)))
        groups.append((start, max(start + draw(st.integers(-3, 40)), 0), draw(st.integers(0, 11))))
    length = draw(st.one_of(st.none(), st.integers(0, 100)))
    return _format13(groups, length)


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(format13_tables())
def test_cmap_format13_matches_fonttools_decompile(table):
    """The native union of one format 13 subtable against fontTools'
    reading of it (its declared length, glyph-0 groups skipped, later
    groups overriding; codes past U+10FFFF left out, as the port drops
    them)."""
    font = TTFont(io.BytesIO(build_ttf(9)))
    declared = struct.unpack(">I", table[4:8])[0]
    try:
        want = {}
        if declared:
            sub = CmapSubtable.newSubtable(13)
            sub.decompileHeader(table[:declared], font)
            sub.decompile(None, None)
            want = {cp: font.getGlyphID(n) for cp, n in sub.cmap.items() if cp < 0x110000}
    except Exception:  # noqa: BLE001
        want = "raises"
    cmap = struct.pack(">HHHHI", 0, 1, 3, 10, 12) + table
    try:
        cps, gids = native.cmap_union(np.frombuffer(cmap, np.uint8))
        got = dict(zip(cps.tolist(), gids.tolist()))
    except ValueError:
        got = "raises"
    assert got == want


# -- (b) and (c): CFF2 and the Type 2 walker ------------------------------------


@pytest.mark.parametrize("fdselect", [0, 3, 4])
def test_cff2_twin_matches_jax(fdselect):
    got = assert_same(synth_font.build_otf2_curved(40, seed=3, first_cp=0x4E00,
                                                    fdselect_format=fdselect), 40)
    assert all(v[1] is not None for v in got[2].values())


@pytest.mark.parametrize("cid", [True, False])
def test_cff_writer_font_matches_jax(cid):
    assert_same(synth_font.build_otf_curved(40, seed=3, cid=cid), 40)


def test_cff2_twin_curves_equal_cff_curves():
    """The twin's curves, bit for bit, are the CFF font's (port alone)."""
    with fonttools_refused():
        a = pt_entry.FontFileEntry(synth_font.build_otf_curved(300, seed=5))
        b = pt_entry.FontFileEntry(synth_font.build_otf2_curved(300, seed=5))
        assert a.metadata.codepoints == b.metadata.codepoints
        for cp in a.metadata.codepoints:
            ka, kb = a.glyph_key(cp), b.glyph_key(cp)
            assert _bits(a.outline_curves(ka)) == _bits(b.outline_curves(kb))
            assert [_bits(r) for r in a.outline_rings(ka)] == [_bits(r) for r in b.outline_rings(kb)]


SQ = [100, 100, "rmoveto", 300, 0, 0, 300, -300, 0, "rlineto"]
T2_CASES = {
    "plain": SQ + ["endchar"],
    "add": SQ + [1, 2, "add", "endchar"],
    "mul": SQ + [1, 2, "mul", "endchar"],
    "div_int": [100, 100, "rmoveto", 600, 2, "div", 0, "rlineto", 0, 300, "rlineto", "endchar"],
    "div_frac": [100, 100, "rmoveto", 7, 2, "div", 50, "rlineto", 0, 300, -300, 0, "rlineto",
                 "endchar"],
    "div_zero": SQ + [7, 0, "div", "endchar"],
    "line_first": [300, 0, 0, 300, -300, 0, "rlineto", "endchar"],
    "curve_first": [100, 0, 100, 100, 0, 100, "rrcurveto", -100, 0, "rlineto", "endchar"],
    "after_endchar": SQ + ["endchar", 50, 50, "rmoveto", 100, 0, 0, 100, "rlineto"],
    "odd_rlineto": [100, 100, "rmoveto", 300, 0, 0, 300, -300, "rlineto", "endchar"],
    "hmoveto3": [10, 20, 30, "hmoveto", 300, 0, 0, 300, -300, 0, "rlineto", "endchar"],
    "rmoveto4": [5, 6, 7, 8, "rmoveto", 300, 0, 0, 300, -300, 0, "rlineto", "endchar"],
    "rmoveto1": [5, "rmoveto", 300, 0, "rlineto", "endchar"],
    "hmoveto_empty": ["hmoveto", 300, 0, 0, 300, "rlineto", "endchar"],
    "endchar2": SQ + [1, 2, "endchar"],
    "flex14": [100, 100, "rmoveto", 1, 10, 20, 10, 20, 0, 20, 0, 20, -10, 10, -10, 50, 9, "flex",
               "endchar"],
    "hflex_fixed": [100, 100, "rmoveto", 30, 40, 0.5, 30, 30, 40, 30, "hflex", 0, 200, "rlineto",
                    "endchar"],
    "hflex1_fixed": [100, 100, "rmoveto", 30, 0.25, 40, 0.5, 30, 30, 40, -0.125, 30, "hflex1",
                     0, 200, "rlineto", "endchar"],
    "flex1_fixed": [100, 100, "rmoveto", 30, 0.25, 40, 0.5, 30, 1, 30, -0.75, 40, -0.125, 30,
                    "flex1", 0, 200, "rlineto", "endchar"],
    "dotsection": [100, 100, "rmoveto", "ignore", 300, 0, 0, 300, -300, 0, "rlineto", "endchar"],
    "fixed_move": [100.5, 100.25, "rmoveto", 300.125, 0, 0, 300, -300, 0, "rlineto", "endchar"],
    "vvcurve_left": [100, 100, "rmoveto", 10, 20, 30, 40, 50, 60, "vvcurveto", "endchar"],
    "hvcurve3": [100, 100, "rmoveto", 10, 20, 30, "hvcurveto", "endchar"],
    "rcurveline9": [100, 100, "rmoveto", 1, 2, 3, 4, 5, 6, 7, 8, 9, "rcurveline", "endchar"],
    "rlinecurve5": [100, 100, "rmoveto", 1, 2, 3, 4, 5, "rlinecurve", "endchar"],
    "rlinecurve9": [100, 100, "rmoveto", 1, 2, 3, 4, 5, 6, 7, 8, 9, "rlinecurve", "endchar"],
    "hintmask2": [10, 20, 30, 40, "hstemhm", "hintmask", b"\x80", 100, 100, "rmoveto", 5,
                  "hintmask", b"\x80", 300, 0, 0, 300, "rlineto", "endchar"],
    "blend_in_cff": SQ + [1, 2, 3, 1, "blend", "rlineto", "endchar"],
    "vsindex_in_cff": SQ + [0, "vsindex", "endchar"],
    "stack60": [100, 100, "rmoveto"] + [10, 0] * 30 + ["rlineto", "endchar"],
    "width": [500, 100, 100, "rmoveto", 300, 0, 0, 300, -300, 0, "rlineto", "endchar"],
}
_SE = StandardEncoding.index
_A = [100, 0, "rmoveto", 200, 600, 200, -600, "rlineto"]
SEAC_CASES = {
    "A": _A + ["endchar"],
    "acute": [250, 650, "rmoveto", 100, 100, -40, 0, "rlineto", "endchar"],
    "seac": [0, 0, _SE("A"), _SE("acute"), "endchar"],
    "seac_width": [480, 10, 20, _SE("A"), _SE("acute"), "endchar"],
    "seac_missing_accent": [0, 30, _SE("A"), _SE("dieresis"), "endchar"],
    "seac_fixed_offset": [0.5, -0.25, _SE("A"), _SE("acute"), "endchar"],
    "seac_negative_code": [0, 0, _SE("A") - 256, _SE("acute"), "endchar"],
    "seac_code_past_255": [0, 0, 300, _SE("acute"), "endchar"],
    "seac_notdef": [0, 0, 0, _SE("acute"), "endchar"],
    "seac_fixed_code": [0, 0, 65.5, _SE("acute"), "endchar"],
    "seac_after_path": _A + [40, 0, _SE("acute"), _SE("acute"), "endchar"],
}


@lru_cache(maxsize=None)
def _cff_views(kind: str):
    """(port's view, JAX's view) of a FontBuilder CFF font whose glyphs
    are one set of programs (bounds not recalculated: fontTools cannot
    draw some of them)."""
    programs = T2_CASES if kind == "t2" else SEAC_CASES
    names = [".notdef"] + list(programs)
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(names[1:])})
    cs = {".notdef": T2CharString(program=["endchar"])}
    cs.update({n: T2CharString(program=p) for n, p in programs.items()})
    fb.setupCFF("EdgeCff-Regular", {"FullName": "Edge Cff"}, cs, {})
    _finish(fb, names, "Edge Cff")
    data = _save(fb)
    return port_view(data), jax_view(data), names


def _finish(fb, names, family):
    fb.setupHorizontalMetrics({n: (600, 0) for n in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": family, "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()


def _save(fb) -> bytes:
    fb.font.recalcBBoxes = False
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


def _case(kind, name):
    got, want, names = _cff_views(kind)
    assert got[:2] == want[:2]
    cp = 0x41 + names.index(name) - 1
    assert got[2][cp] == want[2][cp]
    return want[2][cp]


FAILS = {"add", "mul", "div_zero", "rlinecurve5", "blend_in_cff", "vsindex_in_cff", "rmoveto1",
         "hmoveto_empty",
         "seac_code_past_255", "seac_fixed_code"}


@pytest.mark.parametrize("name", sorted(T2_CASES))
def test_charstring_edge_case_matches_jax(name):
    view = _case("t2", name)
    assert (view[1] is None) == (name in FAILS)


@pytest.mark.parametrize("name", sorted(SEAC_CASES))
def test_seac_matches_jax(name):
    view = _case("seac", name)
    assert (view[1] is None) == (name in FAILS)


CFF2_CASES = {
    "plain": [100, 100, "rmoveto", 300, 0, 0, 300, -300, 0, "rlineto"],
    "blend": [100, 100, 10, 20, 30, 40, 2, "blend", "rmoveto", 300, 0, 0, 300, -300, 0, "rlineto"],
    "vsindex": [0, "vsindex", 100, 100, 10, 20, 30, 40, 2, "blend", "rmoveto", 300, 0, 0, 300,
                "rlineto"],
    "vsindex_past_end": [3, "vsindex", 100, 100, "rmoveto", 300, 0, 0, 300, "rlineto"],
    "vsindex_negative": [-1, "vsindex", 100, 100, 10, 20, 30, 40, 2, "blend", "rmoveto", 300, 0,
                         0, 300, "rlineto"],
    "blend_fixed_count": [100, 100, 10, 20, 30, 40, 2.5, "blend", "rmoveto", 300, 0, 0, 300,
                          "rlineto"],
    "blend_negative_count": [100, 100, 10, 20, -1, "blend", "rmoveto", 300, 0, 0, 300, "rlineto"],
    "blend_leaves_width": [7, 100, 100, 10, 20, 30, 40, 50, 60, 3, "blend", "rmoveto", 300, 0, 0,
                           300, "rlineto"],
    "width": [50, 100, 100, "rmoveto", 300, 0, 0, 300, "rlineto"],
    "fixed_blend": [100.5, 100.25, 0.5, 0.25, 1.5, 1.25, 2, "blend", "rmoveto", 300.125, 0, 0,
                    300, "rlineto"],
}


@lru_cache(maxsize=None)
def _cff2_views():
    names = [".notdef"] + list(CFF2_CASES)
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(names[1:])})
    cs = {".notdef": T2CharString(program=[])}
    cs.update({n: T2CharString(program=p) for n, p in CFF2_CASES.items()})
    fb.setupNameTable({"familyName": "Edge Two", "styleName": "Regular"})
    fb.setupFvar([("wght", 100, 400, 900, "Weight")], [])
    fb.setupCFF2(cs, regions=[{"wght": (0, 1.0, 1.0)}, {"wght": (-1.0, -1.0, 0)}])
    fb.setupHorizontalMetrics({n: (600, 0) for n in names})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    data = _save(fb)
    return port_view(data), jax_view(data), names


@pytest.mark.parametrize("name", sorted(CFF2_CASES))
def test_cff2_blend_edge_case_matches_jax(name):
    got, want, names = _cff2_views()
    assert got[:2] == want[:2]
    cp = 0x41 + names.index(name) - 1
    assert got[2][cp] == want[2][cp]
    fails = {"vsindex_past_end", "blend_fixed_count", "blend_leaves_width", "width"}
    assert (want[2][cp][1] is None) == (name in fails)


# -- (d) glyf ---------------------------------------------------------------------


def _simple(points, flags, ends) -> Glyph:
    g = Glyph()
    g.numberOfContours = len(ends)
    g.coordinates = GlyphCoordinates(points)
    g.flags = array("B", flags)
    g.endPtsOfContours = ends
    g.program = ttProgram.Program()
    g.program.fromBytecode(b"")
    return g


def _component(name, x=0, y=0, more=False, points=None, transform=None):
    c = GlyphComponent()
    c.glyphName = name
    c.flags = 0x20 if more else 0
    if points:
        c.firstPt, c.secondPt = points
    else:
        c.x, c.y = x, y
        c.flags |= 0x2
    if transform:
        c.transform = transform
    return c


def _composite(*components) -> Glyph:
    g = Glyph()
    g.numberOfContours = -1
    g.components = list(components)
    return g


@lru_cache(maxsize=None)
def _glyf_views():
    """A glyf font (format 1, cubic contours allowed) of the glyf cases."""
    cub = ([(100, 0), (200, 300), (400, 300), (500, 0), (300, -100)], [1, 0x80, 0x80, 1, 1], [4])
    g = {".notdef": TTGlyphPen(None).glyph(),
         "base": _simple([(100, 0), (500, 0), (300, 600)], [1, 1, 1], [2]),
         "point_matched": _composite(_component("base", more=True), _component("base", points=(1, 0))),
         "cubic": _simple(*cub),
         "cubic_all_off": _simple([(100, 0), (200, 300), (400, 300), (500, 0)], [0x80] * 4, [3]),
         "cubic_run": _simple([(100, 0), (150, 200), (250, 300), (350, 300), (450, 200), (500, 0)],
                              [1, 0x80, 0x80, 0x80, 0x80, 1], [5]),
         "cubic_mixed": _simple([(100, 0), (200, 300), (400, 300), (500, 0)], [1, 0x80, 0, 1], [3]),
         "cubic_odd": _simple([(100, 0), (200, 300), (300, 350), (400, 300), (500, 0)],
                              [1, 0x80, 0x80, 0x80, 1], [4]),
         "cubic_lsb": _simple(*cub)}
    g["cubic_component"] = _composite(_component("cubic", 30, 40, transform=[[0.5, 0.25], [-0.25, 0.75]]))
    prev = "base"
    for d in range(12):
        g[f"deep{d}"] = _composite(_component(prev, 7, -3, transform=[[0.875, 0.0625], [-0.125, 0.9375]]))
        prev = f"deep{d}"
    names = list(g)
    fb = FontBuilder(1000, isTTF=True, glyphDataFormat=1)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41 + i: n for i, n in enumerate(names[1:])})
    fb.setupGlyf(g)
    glyf = fb.font["glyf"]
    metrics = {}
    for n in names:
        glyf[n].recalcBounds(glyf)
        metrics[n] = (600, 77 if n == "cubic_lsb" else getattr(glyf[n], "xMin", 0))
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Glyf Edge", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    data = _save(fb)
    return port_view(data), jax_view(data), names


GLYF_CASES = ["point_matched", "cubic", "cubic_all_off", "cubic_run", "cubic_mixed", "cubic_odd",
              "cubic_lsb", "cubic_component", "deep11"]


@pytest.mark.parametrize("name", GLYF_CASES)
def test_glyf_edge_case_matches_jax(name):
    got, want, names = _glyf_views()
    assert got[:2] == want[:2]
    cp = 0x41 + names.index(name) - 1
    assert got[2][cp] == want[2][cp]
    fails = {"point_matched", "cubic_mixed", "cubic_odd"}
    assert (want[2][cp][1] is None) == (name in fails)


def test_glyf_nesting_matches_jax():
    """Every level of a 12-deep composite (the native walk stops at 8)."""
    got, want, names = _glyf_views()
    for d in range(12):
        cp = 0x41 + names.index(f"deep{d}") - 1
        assert got[2][cp] == want[2][cp] and want[2][cp][1] is not None


def _patched(data: bytes, tag: str, at: int, value: bytes) -> bytes:
    """``data`` with bytes of table ``tag`` at ``at`` replaced (the
    directory's checksums left stale: neither reader checks them)."""
    off = sfnt.Sfnt(data).tables[tag][0]
    return data[:off + at] + value + data[off + at + len(value):]


def _glyf_at(data: bytes, gid: int) -> int:
    """The offset of glyph ``gid`` in the glyf table."""
    font = TTFont(io.BytesIO(data))
    return font["loca"][gid]


def _malformed(kind: str) -> bytes:
    """Structures the JAX package's native readers accept and fontTools
    rejects: a flag repeat past the glyph's points, a contour count
    below -1, a Private DICT whose operands are left over."""
    if kind == "private_leftover":
        data = synth_font.build_otf_curved(12, seed=2, cid=False)
        top = TTFont(io.BytesIO(data))["CFF "].cff.topDictIndex[0]
        size, off = top.rawDict["Private"]
        # Its last operator (Subrs) becomes the operand 0: operands stay.
        return _patched(data, "CFF ", off + size - 1, bytes([139]))
    data = build_ttf(6)
    at = _glyf_at(data, 2)
    if kind == "glyf_flags_past_points":
        raw = sfnt.Sfnt(data).table("glyf")
        nc = struct.unpack(">h", raw[at:at + 2])[0]
        ilen = struct.unpack(">H", raw[at + 10 + 2 * nc:at + 12 + 2 * nc])[0]
        flags_at = at + 12 + 2 * nc + ilen
        return _patched(data, "glyf", flags_at, bytes([raw[flags_at] | 0x08, 200]))
    return _patched(data, "glyf", at, struct.pack(">h", -7))


@pytest.mark.parametrize("kind", ["glyf_flags_past_points", "glyf_contours_below_minus_one",
                                  "private_leftover"])
def test_malformed_structure_matches_jax(kind):
    """Rings as the JAX package's native reader gives them where it
    accepts the glyph (−1 where fontTools decides and fails), curves
    raising as fontTools' pen does."""
    got = assert_same(_malformed(kind), 6)
    assert any(v[3] == "raises" for v in got[2].values())


def test_contour_end_past_points_is_minus_one():
    """A contour end past the glyph's points (the JAX package's native
    walker reads past its arrays there): −1, as fontTools' pen fails."""
    data = build_ttf(6)
    at = _glyf_at(data, 2)
    nc = struct.unpack(">h", sfnt.Sfnt(data).table("glyf")[at:at + 2])[0]
    assert nc >= 2
    bad = _patched(data, "glyf", at + 10, struct.pack(">H", 60000))
    font = TTFont(io.BytesIO(bad))
    with pytest.raises(Exception):  # noqa: B017 - fontTools raises IndexError here
        font.getGlyphSet()[font.getGlyphName(2)].draw(RecordingPen())
    got = port_view(bad)
    cp = next(cp for cp in got[1] if cp == 0x42)
    assert got[2][cp][1] is None and got[2][cp][3] == "raises"


def test_format13_of_too_many_codes_is_refused():
    """Groups setting more than 16 × 0x110000 codes: refused (fontTools
    would spend minutes or gigabytes on them)."""
    groups = [(0, 0x10FFFF, 1)] * 17
    assert port_view(_with_cmap([(3, 10, _format13(groups))])) == "raises"


# -- (e) the index where a table is missing or short -------------------------------


def _edit_tables(data: bytes, drop=(), cut=None, extend=None) -> bytes:
    """``data`` with tables dropped from the directory, one cut to
    ``cut = (tag, length)`` bytes, or one's listed length raised past the
    end of the file (``extend``)."""
    n = struct.unpack(">H", data[4:6])[0]
    recs = [data[12 + 16 * i: 28 + 16 * i] for i in range(n)]
    keep = [r for r in recs if r[:4].decode("latin1") not in drop]
    out = bytearray(data[:4] + struct.pack(">H", len(keep)) + data[6:12] + b"".join(keep))
    body = bytearray(data[12 + 16 * n:])
    shift = 12 + 16 * n - len(out)
    for i, r in enumerate(keep):
        tag = r[:4].decode("latin1")
        cs, off, length = struct.unpack(">III", r[4:])
        if cut and tag == cut[0]:
            length = cut[1]
        if extend == tag:
            length = len(data) + 64
        out[12 + 16 * i: 28 + 16 * i] = r[:4] + struct.pack(">III", cs, off - shift, length)
    return bytes(out + body)


SHORT_CASES = {
    "no_hmtx": dict(drop=("hmtx",)),
    "no_hhea": dict(drop=("hhea",)),
    "no_maxp": dict(drop=("maxp",)),
    "hmtx_past_end": dict(extend="hmtx"),
    "hhea_short": dict(cut=("hhea", 30)),
    "maxp_short": dict(cut=("maxp", 5)),
    "hmtx_short": dict(cut=("hmtx", 10)),
    "cmap_past_end": dict(extend="cmap"),
}


@pytest.mark.parametrize("source", ["ttf", "otf"])
@pytest.mark.parametrize("kind", sorted(SHORT_CASES))
def test_short_table_index_matches_jax(kind, source):
    base = build_ttf(6) if source == "ttf" else build_otf(6)
    assert_same(_edit_tables(base, **SHORT_CASES[kind]), min_glyphs=0)


@pytest.mark.parametrize("cmap", ["format4", "format13"])
def test_long_hhea_index_matches_jax(cmap):
    """An hhea listed at 38 bytes: the JAX package's native reader takes
    it (format 4; fontTools' glyph set cannot, so curves raise), fontTools
    cannot decode it (its route for format 13: the font is refused)."""
    base = build_ttf(6) if cmap == "format4" else _cmap_font("fmt13")
    got = assert_same(_edit_tables(base, cut=("hhea", 38)), min_glyphs=0)
    assert (got == "raises") == (cmap == "format13")
    if cmap == "format4":
        assert all(v[1] is not None and v[3] == "raises" for v in got[2].values())


# -- (f) the CJK Mac name codecs ---------------------------------------------------


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(st.sampled_from([(1, 1), (1, 2), (1, 3), (1, 25)]),
       st.lists(st.one_of(st.integers(0, 255), st.sampled_from([0x7E, 0x80, 0x81, 0x82, 0x83,
                                                                0xA0, 0xFC, 0xFD, 0xFE, 0xFF])),
                min_size=1, max_size=8))
def test_mac_cjk_names_match_fonttools(encoding, raw):
    rec = NameRecord()
    rec.platformID, rec.platEncID = encoding
    rec.langID, rec.nameID, rec.string = 0, 1, bytes(raw)
    try:
        want = rec.toUnicode()
    except UnicodeDecodeError:
        want = "raises"
    try:
        got = sfnt.decode_name(bytes(raw), *encoding, 0)
    except UnicodeDecodeError:
        got = "raises"
    assert got == want


def test_mac_cjk_family_name_matches_jax():
    """A font whose only family name is a Mac Japanese record."""
    font = TTFont(io.BytesIO(build_ttf(6, family="Placeholder")))
    name = font["name"]
    name.names = [r for r in name.names if r.nameID not in (1, 4, 6)]
    rec = NameRecord()
    rec.platformID, rec.platEncID, rec.langID, rec.nameID = 1, 1, 11, 1
    rec.string = "日本 Sans".encode("shift_jis") + b"\xfd"
    name.names.append(rec)
    buf = io.BytesIO()
    font.save(buf)
    got = assert_same(buf.getvalue(), 6)
    assert got[0].startswith("日本")


# -- (g) the OTF writers -------------------------------------------------------------


def _fontbuilder_twin(n_glyphs, seed, cff2) -> bytes:
    """`cjk_outlines` written by FontBuilder (name-keyed CFF or CFF2)."""
    outlines = synth_font.cjk_outlines(n_glyphs, seed)
    names = [".notdef"] + [f"g{k}" for k in range(n_glyphs)]
    fb = FontBuilder(synth_font.UPEM, isTTF=False)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({cp: names[k + 1] for k, cp in enumerate(synth_font.cjk_codepoints(n_glyphs))})
    charstrings = {}
    for name, (advance, contours) in zip(names, [(synth_font.CJK_ADVANCE, [])] + outlines):
        pen = T2CharStringPen(None if cff2 else advance, None, CFF2=cff2)
        for start, segs in contours:
            pen.moveTo(start)
            for s in segs:
                pen.lineTo(s[1]) if s[0] == "l" else pen.curveTo(*s[1:])
            pen.closePath()
        charstrings[name] = pen.getCharString()
    if cff2:
        fb.setupCFF2(charstrings)
    else:
        fb.setupCFF("SynthIdeo-Regular", {}, charstrings, {})
    metrics = {n: (adv, 0) for n, (adv, _) in zip(names, [(synth_font.CJK_ADVANCE, [])] + outlines)}
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=synth_font.ASCENT, descent=synth_font.DESCENT)
    fb.setupNameTable({"familyName": "Synth Ideo", "styleName": "Regular",
                       "fullName": "Synth Ideo Regular", "psName": "SynthIdeo-Regular"})
    fb.setupOS2(sTypoAscender=synth_font.ASCENT, sTypoDescender=synth_font.DESCENT)
    fb.setupPost(keepGlyphNames=False)
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


def _drawings(font: TTFont):
    gs, out = font.getGlyphSet(), []
    for name in font.getGlyphOrder():
        pen = RecordingPen()
        gs[name].draw(pen)
        out.append(pen.value)
    return out


@pytest.mark.parametrize("kind", ["cid", "name_keyed", "cff2"])
def test_otf_writer_matches_fontbuilder(kind):
    n, seed = 48, 9
    if kind == "cff2":
        data = synth_font.build_otf2_curved(n, seed=seed)
    else:
        data = synth_font.build_otf_curved(n, seed=seed, cid=kind == "cid")
    got, want = TTFont(io.BytesIO(data)), TTFont(io.BytesIO(_fontbuilder_twin(n, seed, kind == "cff2")))
    assert got.sfntVersion == "OTTO" and ("CFF2" if kind == "cff2" else "CFF ") in got
    assert _drawings(got) == _drawings(want)
    outlines = synth_font.cjk_outlines(n, seed)
    assert _drawings(got)[1:] == [
        [r for start, segs in contours for r in
         [("moveTo", (start,))] + [("lineTo" if s[0] == "l" else "curveTo", tuple(s[1:]))
                                   for s in segs] + [("closePath", ())]]
        for _, contours in outlines]
    cmap = lambda f: {cp: f.getGlyphID(nm) for cp, nm in f.getBestCmap().items()}  # noqa: E731
    assert cmap(got) == cmap(want)
    advances = lambda f: [f["hmtx"][nm][0] for nm in f.getGlyphOrder()]  # noqa: E731
    assert advances(got) == advances(want)
    assert got["maxp"].numGlyphs == want["maxp"].numGlyphs == n + 1
    names = lambda f: sorted((r.platformID, r.nameID, r.toUnicode()) for r in f["name"].names)  # noqa: E731
    assert names(got) == names(want)
    if kind == "cid":
        top = got["CFF "].cff.topDictIndex[0]
        assert top.ROS == ("Adobe", "Identity", 0) and len(top.FDArray) >= 4
        assert top.FDSelect.format == 3
