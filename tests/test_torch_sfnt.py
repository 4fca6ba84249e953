"""The port's font reader and font writer without fontTools, held against
fontTools and the JAX package on the CPU.

(a) `font.sfnt` against fontTools' `TTFont` on every font kind of
``test_torch_host.FONTS`` and a font collection: the table directory,
``head``, ``hhea``, ``maxp`` and ``getDebugName``; and on ``name``
tables made by hypothesis (platforms 0-3 and an unknown one, several
records of one ID in any order, a wrong ``stringOffset``, truncated
tables, strings of odd length).

(b) `FontFileEntry.outline_curves` (the native segment walk and
`font.entry.curve_soup`) against fontTools' CurvePen through the JAX
`FontFileEntry`, glyph for glyph, on those fonts and on a font whose
glyphs sit at the walkers' edges: a contour that starts off-curve, an
all-off-curve contour, composites with a 2×2, an x/y and a uniform
scale, and a composite of a composite. Their rings too. And a CFF2 font
and a font whose only unicode cmap is of format 13, which the JAX
package reads through fontTools, against the JAX entry. The port's side
runs with fontTools refused (`test_torch_cff2.fonttools_refused`).

(c) `utils.synth_font.build_ttf_curved` against fontTools' FontBuilder
on the same glyphs: fontTools opens the file, its checksums hold, and
its cmap, advances, side bearings, ``head``, ``hhea``, ``maxp`` and
names equal FontBuilder's; the JAX CLI's ``merge --renderer exact``
trees of the two files are byte-equal.

Tolerance: none; every comparison is exact (floats by their bits).
"""

import io
import os
import struct
from array import array

import numpy as np
import pytest
from fontTools.fontBuilder import FontBuilder
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import TTCollection, TTFont
from fontTools.ttLib.sfnt import calcChecksum
from fontTools.ttLib.tables import ttProgram
from fontTools.ttLib.tables._c_m_a_p import CmapSubtable
from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphCoordinates
from fontTools.ttLib.tables._n_a_m_e import table__n_a_m_e
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import versatiles_glyphs_tpu.font.entry as jx_entry
from versatiles_glyphs_tpu.cli import main as jax_main
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_otf2, build_ttf, build_ttf_split_cmap
from versatiles_glyphs_tpu_torch.font import entry as pt_entry
from versatiles_glyphs_tpu_torch.font import sfnt
from versatiles_glyphs_tpu_torch.utils import synth_font

from test_torch_cff2 import fonttools_refused  # noqa: E402  (a sibling test module)

FONTS = {
    "ttf": lambda: build_ttf(24),
    "otf": lambda: build_otf(24),
    "split_cmap": lambda: build_ttf_split_cmap()[0],
    "curved": lambda: synth_font.build_ttf_curved(20, 0xF0, seed=3),
}


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


# -- (a) the reader -----------------------------------------------------------


def _collection(a: bytes, b: bytes) -> bytes:
    coll = TTCollection()
    coll.fonts = [TTFont(io.BytesIO(a)), TTFont(io.BytesIO(b))]
    buf = io.BytesIO()
    coll.save(buf)
    return buf.getvalue()


FONTS_AND_TTC = dict(FONTS, ttc=lambda: _collection(build_ttf(6, family="First Sans"),
                                                    build_ttf(8, family="Second Sans")))


@pytest.mark.parametrize("kind", sorted(FONTS_AND_TTC))
def test_sfnt_matches_fonttools(kind):
    data = FONTS_AND_TTC[kind]()
    got, tt = sfnt.Sfnt(data), TTFont(io.BytesIO(data), fontNumber=0, lazy=True)
    assert got.tables == {str(t): (e.offset, e.length) for t, e in tt.reader.tables.items()}
    assert all(got.covered(t) for t in got.tables)
    head = tt["head"]
    assert (got.units_per_em, got.index_to_loc_format) == (head.unitsPerEm, head.indexToLocFormat)
    assert got.u16("hhea", 34) == tt["hhea"].numberOfHMetrics
    assert got.u16("maxp", 4) == tt["maxp"].numGlyphs
    records = sfnt.name_records(got.table("name"))
    for nid in range(26):
        assert sfnt.debug_name(records, nid) == tt["name"].getDebugName(nid), nid
    assert got.names() == (tt["name"].getDebugName(1), tt["name"].getDebugName(6))
    a, b = pt_entry.FontFileEntry(data), jx_entry.FontFileEntry(data)
    assert (a.metadata.generate_name(), a.metadata.codepoints) == (
        b.metadata.generate_name(), b.metadata.codepoints)


ENCODINGS = st.sampled_from([(0, 3, 0), (0, 4, 0), (1, 0, 0), (1, 0, 15), (1, 0, 37),
                             (1, 1, 11), (1, 6, 0), (2, 0, 0), (2, 2, 0), (3, 1, 0x409),
                             (3, 1, 0x407), (3, 10, 0x409), (3, 2, 0x411), (4, 0, 0)])
TEXTS = st.sampled_from(["Synth Sans", "Übung", "Ελληνικά", "日本語", "", "A\tB", "x"])


@st.composite
def name_tables(draw):
    """A name table's bytes: records of IDs 1, 2 and 6 in any order
    over many encodings, strings encoded in their record's encoding
    where it can (else raw bytes, odd lengths among them), an optional
    wrong ``stringOffset`` and an optional cut at the end."""
    n = draw(st.integers(0, 8))
    recs, data = [], b""
    for _ in range(n):
        pid, eid, lid = draw(ENCODINGS)
        nid = draw(st.sampled_from([1, 2, 6]))
        try:
            raw = draw(TEXTS).encode(sfnt.encoding_of(pid, eid, lid))
        except (UnicodeEncodeError, LookupError):
            raw = b""
        if draw(st.booleans()):
            raw = draw(st.binary(max_size=9))
        recs.append(struct.pack(">6H", pid, eid, lid, nid, len(raw), len(data)))
        data += raw
    offset = 6 + 12 * n + draw(st.sampled_from([0, 0, 0, -3, -12, 1, 4]))
    table = struct.pack(">HHH", 0, n, max(offset, 0)) + b"".join(recs) + data
    cut = draw(st.integers(6, len(table)))
    return table[:cut] if draw(st.booleans()) else table


@settings(max_examples=150, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(name_tables())
def test_debug_name_matches_fonttools(table):
    want = table__n_a_m_e()
    want.decompile(table, None)
    records = sfnt.name_records(table)
    assert len(records) == len(want.names)
    for nid in (1, 2, 6):
        assert sfnt.debug_name(records, nid) == want.getDebugName(nid), nid


# -- (b) curves ---------------------------------------------------------------


def _simple(points, flags, ends) -> Glyph:
    g = Glyph()
    g.numberOfContours = len(ends)
    g.coordinates = GlyphCoordinates(points)
    g.flags = array("B", flags)
    g.endPtsOfContours = ends
    g.program = ttProgram.Program()
    g.program.fromBytecode(b"")
    return g


def edge_font() -> bytes:
    """Glyphs at the edges of the native walkers, built by fontTools:
    ``off_start`` (its contour's first point off-curve, then a second
    contour of lines), ``all_off`` (a contour of off-curve points only),
    ``two_by_two`` (``off_start`` under a 2×2 transform and ``all_off``
    under an x/y scale), ``scaled`` (a uniform scale) and ``nested``
    (``two_by_two`` transformed again)."""
    fb = FontBuilder(1000, isTTF=True)
    names = [".notdef", "off_start", "all_off", "two_by_two", "scaled", "nested"]
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({0x41 + k: n for k, n in enumerate(names[1:])})
    glyphs = {".notdef": TTGlyphPen(None).glyph()}
    glyphs["off_start"] = _simple(
        [(300, 0), (600, 50), (620, 400), (300, 700), (40, 420), (90, 30),
         (150, 150), (450, 150), (450, 500), (150, 500)],
        [0, 1, 0, 1, 0, 0, 1, 1, 1, 1], [5, 9])
    glyphs["all_off"] = _simple([(100, 0), (500, 0), (500, 400), (100, 400), (20, 200)],
                                [0, 0, 0, 0, 0], [4])
    pen = TTGlyphPen(glyphs)
    pen.addComponent("off_start", (0.5, 0.25, -0.25, 0.75, 37, -12))
    pen.addComponent("all_off", (0.75, 0, 0, 1.25, 400, 100))
    glyphs["two_by_two"] = pen.glyph()
    pen = TTGlyphPen(glyphs)
    pen.addComponent("off_start", (0.5, 0, 0, 0.5, 100, 100))
    glyphs["scaled"] = pen.glyph()
    pen = TTGlyphPen(glyphs)
    pen.addComponent("two_by_two", (0.875, -0.125, 0.0625, 0.9375, -20, 33))
    glyphs["nested"] = pen.glyph()
    fb.setupGlyf(glyphs)
    glyf = fb.font["glyf"]
    metrics = {}
    for n in names:  # a side bearing of xMin: fontTools draws no shift
        g = glyf[n]
        g.recalcBounds(glyf)
        metrics[n] = (700, getattr(g, "xMin", 0))
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "Edge Sans", "styleName": "Regular",
                       "psName": "EdgeSans-Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200)
    fb.setupPost()
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", sorted(FONTS) + ["edges"])
def test_outline_curves_equal_curve_pen(kind):
    """Every mapped glyph's cubic soup, bit for bit, against fontTools'
    CurvePen (the JAX entry's `outline_curves`), and its rings against
    the JAX entry's; the port's side with fontTools refused."""
    data = edge_font() if kind == "edges" else FONTS[kind]()
    b = jx_entry.FontFileEntry(data)
    with fonttools_refused():
        a = pt_entry.FontFileEntry(data)
        got = {cp: (a.outline_curves(a.glyph_key(cp)), a.outline_rings(a.glyph_key(cp)))
               for cp in a.metadata.codepoints}
    seen = 0
    for cp in b.metadata.codepoints:
        name = b.glyph_name(cp)
        curves, rings = got[cp]
        want = b.outline_curves(name)
        assert _bits(curves) == _bits(want), (kind, name)
        assert [_bits(r) for r in rings] == [_bits(r) for r in b.outline_rings(name)], (kind, name)
        seen += len(want)
    assert seen > 20


def cmap13_font() -> bytes:
    """A TrueType font whose only unicode cmap subtable is format 13."""
    font = TTFont(io.BytesIO(build_ttf(6, family="Thirteen Sans")))
    sub = CmapSubtable.getSubtableClass(13)(13)
    sub.platformID, sub.platEncID, sub.language = 3, 10, 0
    sub.cmap = {65 + k: f"g{k}" for k in range(6)}
    font["cmap"].tables = [sub]
    buf = io.BytesIO()
    font.save(buf)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["cff2", "cmap13"])
def test_fonttools_fallback_matches_jax(kind):
    """Where the JAX package reads a font through fontTools (CFF2
    outlines; a format 13 cmap), the port reads it natively, with no
    fontTools module loaded, and gives the JAX entry's results codepoint
    by codepoint: advance, the prep of the glyph's core, rings and
    curves."""
    data = build_otf2(8, family="Two Sans") if kind == "cff2" else cmap13_font()
    b = jx_entry.FontFileEntry(data)
    with fonttools_refused():
        a = pt_entry.FontFileEntry(data)
        got = {}
        for cp in a.metadata.codepoints:
            key = a.glyph_key(cp)
            got[cp] = (a.hor_advance(key), a.prep_cores[key].make_prep(cp),
                       a.outline_rings(key), a.outline_curves(key))
    assert (a.metadata.generate_name(), a.metadata.codepoints) == (
        b.metadata.generate_name(), b.metadata.codepoints)
    assert len(b.metadata.codepoints) >= 6
    for cp in b.metadata.codepoints:
        name = b.glyph_name(cp)
        advance, pa, rings, curves = got[cp]
        assert advance == b.hor_advance(name)
        pb = b.prep_cores[b.glyph_key(cp)].make_prep(cp)
        assert (pa.advance, pa.width, pa.height, pa.x0, pa.y0) == (
            pb.advance, pb.width, pb.height, pb.x0, pb.y0)
        assert _bits(pa.chain16) == _bits(pb.chain16)
        assert [_bits(r) for r in rings] == [_bits(r) for r in b.outline_rings(name)]
        assert _bits(curves) == _bits(b.outline_curves(name))


def test_curve_soup_rules():
    """`curve_soup` on hand-made records: a line, a quadratic, a cubic,
    a close off the start (a closing line) and one on it (nothing)."""
    P = np.array([[[0, 0], [3, 6], [3, 6], [3, 6]],
                  [[3, 6], [6, 9], [6, 9], [9, 3]],
                  [[9, 3], [8, 1], [7, 0], [5, 0]],
                  [[5, 0], [0, 0], [0, 0], [0, 0]],
                  [[0, 0], [0, 0], [0, 0], [0, 0]],
                  [[0, 0], [1, 1], [1, 1], [1, 1]]], np.float64)
    kinds = np.array([pt_entry.LINE, pt_entry.QUAD, pt_entry.CUBIC, pt_entry.CLOSE,
                      pt_entry.CLOSE, pt_entry.MOVE], np.int8)
    curves, keep = pt_entry.curve_soup(kinds, P)
    assert keep.tolist() == [True, True, True, True, False, False]
    np.testing.assert_array_equal(curves[0], [[0, 0], [1, 2], [2, 4], [3, 6]])
    np.testing.assert_array_equal(curves[1, 1], [3 + 2.0 / 3.0 * 3, 6 + 2.0 / 3.0 * 3])
    np.testing.assert_array_equal(curves[1, 2], [9 + 2.0 / 3.0 * -3, 3 + 2.0 / 3.0 * 6])
    np.testing.assert_array_equal(curves[2], P[2])
    np.testing.assert_array_equal(curves[3, 1:3], [[5 - 5 / 3.0, 0], [5 + 2.0 * -5 / 3.0, 0]])


# -- (c) the writer -----------------------------------------------------------

ARGS = dict(n_glyphs=20, first_cp=0xFFF0, seed=4, quads=6, family="Writer Test", style="Bold")


def fontbuilder_twin(n_glyphs, first_cp, seed, quads, family, style) -> bytes:
    """The glyphs of `build_ttf_curved` written by fontTools' FontBuilder
    (post format 3, no glyph names)."""
    outlines = synth_font.curved_outlines(n_glyphs, seed, quads)
    names = [f"g{k}" for k in range(n_glyphs)]
    fb = FontBuilder(synth_font.UPEM, isTTF=True)
    fb.setupGlyphOrder([".notdef"] + names)
    fb.setupCharacterMap({first_cp + k: n for k, n in enumerate(names)})
    glyphs, metrics = {".notdef": TTGlyphPen(None).glyph()}, {".notdef": (600, 0)}
    for name, (advance, contours) in zip(names, outlines):
        pen = TTGlyphPen(None)
        for on, off in contours:
            pen.moveTo(on[0])
            for j in range(len(on)):
                pen.qCurveTo(off[j], on[(j + 1) % len(on)])
            pen.closePath()
        glyphs[name] = pen.glyph()
        metrics[name] = (advance, min(x for on, off in contours for x, _ in on + off))
    fb.setupGlyf(glyphs)
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=synth_font.ASCENT, descent=synth_font.DESCENT)
    fb.setupNameTable({"familyName": family, "styleName": style,
                       "fullName": f"{family} {style}",
                       "psName": f"{family.replace(' ', '')}-{style.replace(' ', '')}"})
    fb.setupOS2(sTypoAscender=synth_font.ASCENT, sTypoDescender=synth_font.DESCENT)
    fb.setupPost(keepGlyphNames=False)
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


def _fields(table, skip=()):
    return {k: v for k, v in vars(table).items() if not k.startswith("_") and k not in skip}


@pytest.mark.parametrize("args", [ARGS, dict(n_glyphs=9, first_cp=0x41, seed=2)])
def test_writer_matches_fontbuilder(args):
    data = synth_font.build_ttf_curved(**args)
    got = TTFont(io.BytesIO(data))
    want = TTFont(io.BytesIO(fontbuilder_twin(**{**dict(quads=8, family="Synth Curved",
                                                         style="Regular"), **args})))
    # Checksums: each table's, then the file's (head.checkSumAdjustment).
    for tag, e in got.reader.tables.items():
        raw = data[e.offset:e.offset + e.length]
        if tag == "head":
            raw = raw[:8] + b"\0\0\0\0" + raw[12:]
        assert calcChecksum(raw) == e.checkSum, tag
    assert calcChecksum(data) == 0xB1B0AFBA
    assert got.getBestCmap() is not None and len(got.getBestCmap()) == args["n_glyphs"]
    cmap = lambda f: {cp: f.getGlyphID(n) for cp, n in f.getBestCmap().items()}  # noqa: E731
    assert cmap(got) == cmap(want)
    order_got, order_want = got.getGlyphOrder(), want.getGlyphOrder()
    assert len(order_got) == len(order_want) == args["n_glyphs"] + 1
    assert [got["hmtx"][n] for n in order_got] == [want["hmtx"][n] for n in order_want]
    skip = ("created", "modified", "checkSumAdjustment")
    assert _fields(got["head"], skip) == _fields(want["head"], skip)
    for tag in ("hhea", "maxp"):
        assert _fields(got[tag]) == _fields(want[tag]), tag
    names = lambda f: sorted((r.platformID, r.platEncID, r.langID, r.nameID, r.toUnicode())  # noqa: E731
                             for r in f["name"].names)
    assert names(got) == names(want)
    outline = lambda f, n: tuple(list(x) for x in f["glyf"][n].getCoordinates(f["glyf"]))  # noqa: E731
    assert [outline(got, n) for n in order_got] == [outline(want, n) for n in order_want]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_writer_tree_equals_fontbuilder_tree(tmp_path):
    """The JAX CLI renders both files into the same tree."""
    args = dict(ARGS, first_cp=0x3C)
    ours, theirs = tmp_path / "ours.ttf", tmp_path / "theirs.ttf"
    ours.write_bytes(synth_font.build_ttf_curved(**args))
    theirs.write_bytes(fontbuilder_twin(**args))
    for f in (ours, theirs):
        jax_main(["merge", str(f), "-o", str(tmp_path / f.stem), "--renderer", "exact"],
                 stdout=io.BytesIO())
    got = _tree(tmp_path / "ours")
    assert got == _tree(tmp_path / "theirs")
    assert sorted(got) == ["font_families.json", "index.json", "writer_test_bold/0-255.pbf"]
