"""The frozen copies against the port's originals as they stand: the
font writers byte for byte, the flattening and prep value for value,
the work constants, and the plain render against the port's exact
renderer."""

import numpy as np
import pytest

from glyphbench.frozen import outlines, synth_font, work
from glyphbench.reference import render


def test_ttf_writer_is_the_ports():
    from versatiles_glyphs_tpu_torch.utils import synth_font as port

    for n, first, seed, quads in ((40, 32, 3, 8), (25, 0x600, 9, 24)):
        ours = synth_font.build_ttf(range(first, first + n), seed=seed, quads=quads,
                                    family="Fira Sans", style="Bold Italic")
        assert ours == port.build_ttf_curved(n, first, seed=seed, quads=quads,
                                             family="Fira Sans", style="Bold Italic")


def test_otf_writer_is_the_ports():
    from versatiles_glyphs_tpu_torch.utils import synth_font as port

    assert synth_font.build_otf_curved(60, seed=4) == port.build_otf_curved(60, seed=4)
    assert synth_font.cjk_codepoints(70) == port.cjk_codepoints(70)


def test_ttf_writer_maps_a_codepoint_list():
    from versatiles_glyphs_tpu_torch.font.entry import FontFileEntry

    cps = [40, 41, 300, 8200, 65533]
    e = FontFileEntry(synth_font.build_ttf(cps, n_glyphs=9, seed=2))
    assert e.metadata.codepoints == cps
    assert [e.glyph_key(cp) for cp in cps] == [1, 2, 3, 4, 5]


def _port_view(font: bytes, cps):
    from versatiles_glyphs_tpu_torch.font.entry import FontFileEntry
    from versatiles_glyphs_tpu_torch.render.metrics import prepare_glyph

    e = FontFileEntry(font)
    out = []
    for cp in cps:
        gid = e.glyph_key(cp)
        rings = e.outline_rings(gid)
        out.append((rings, prepare_glyph(cp, rings, e.units_per_em, e.hor_advance(gid))))
    return out


@pytest.mark.parametrize("kind", ["text", "heavy", "cjk"])
def test_flatten_and_prep_are_the_ports(kind):
    if kind == "cjk":
        n, font = 40, synth_font.build_otf_curved(40, seed=11)
        cps, rings = synth_font.cjk_codepoints(40), outlines.cjk_font_rings(40, 11)
    else:
        quads = 8 if kind == "text" else 24
        n, cps = 30, list(range(0x600, 0x600 + 30))
        font = synth_font.build_ttf(cps, n_glyphs=35, seed=7, quads=quads)
        rings = outlines.text_font_rings(n, 7, quads)
    p = outlines.prep(rings)
    for k, (port_rings, q) in enumerate(_port_view(font, cps)):
        mine = rings.glyph_rings(k)
        assert len(mine) == len(port_rings)
        for a, b in zip(mine, port_rings):
            assert np.array_equal(a, b)
        got = (p.advance[k], p.dx[k], bool(p.empty[k]), p.width[k], p.height[k], p.pbf_left[k],
               p.pbf_top[k], p.pbf_width[k], p.pbf_height[k])
        want = (q.advance, q.dx, q.empty, q.width, q.height, q.pbf_left, q.pbf_top, q.pbf_width,
                q.pbf_height)
        assert tuple(got) == want
        assert np.array_equal(p.xy[p.pt_start[k]:p.pt_start[k] + p.npts[k]],
                              np.concatenate(q.rings_px))


def test_cjk_library_flattening_is_flattening_in_place():
    n, seed = 150, 5
    slow = outlines._contour_rings([c for _, cs in synth_font.cjk_outlines(n, seed) for c in cs])
    fast = outlines.cjk_font_rings(n, seed)
    assert np.array_equal(slow.pts, fast.pts)
    assert np.array_equal(slow.ring_lens, fast.ring_lens)


def test_work_constants_are_the_ports():
    from versatiles_glyphs_tpu_torch.tools import work as port

    for name in ("ROW_SHARED_PAIR_F32_OPS", "ROW_TEST_F32_OPS", "CROSSING_F32_OPS",
                 "CROSSING_PIXEL_F32_OPS", "BYTE_PIXEL_F32_OPS", "BWD_PIXEL_F32_OPS",
                 "PEAK_F32_OPS_PER_S", "PEAK_BYTES_PER_S"):
        assert getattr(work, name) == getattr(port, name), name


def test_crossed_rows_counts_by_hand():
    # Rows centred at y = 9.5, 8.5, ..., 0.5 (top first); a segment over
    # [2.0, 5.0) crosses the rows at 4.5, 3.5 and 2.5.
    assert work.crossed_rows(np.array([2.0]), np.array([5.0]), 9.5, 10)[0] == 3
    assert work.crossed_rows(np.array([5.0]), np.array([2.0]), 9.5, 10)[0] == 3
    assert work.crossed_rows(np.array([2.5]), np.array([2.5]), 9.5, 10)[0] == 0
    w = work.field_work(np.array([[0.0, 2.0, 1.0, 5.0]]), np.array([0]), [4], [10], [0])
    assert w == {"pixels": 40, "segments": 1, "pairs": 40, "row_tests": 10, "crossings": 3,
                 "crossing_pixels": 12}
    ops = work.render_work(np.array([[0.0, 2.0, 1.0, 5.0]]), np.array([0]), [4], [10], [0])["f32_ops"]
    assert ops == 40 * 16 + 10 * 2 + 3 * 4 + 12 * 1 + 40 * 8


def test_reference_render_is_the_ports_exact_renderer():
    from versatiles_glyphs_tpu_torch.ops.sdf_ref import render_sdf_exact

    for rings in (outlines.text_font_rings(12, 3, 8), outlines.cjk_font_rings(6, 4)):
        p = outlines.prep(rings)
        segs, sg = outlines.segments(p)
        out, starts = render.render(segs, sg, p.width, p.height, p.x0, p.y0, pairs_per_block=1 << 18)
        for g in range(len(p.width)):
            want = render_sdf_exact(segs[sg == g], int(p.width[g]), int(p.height[g]),
                                    int(p.x0[g]), int(p.y0[g]))
            assert np.array_equal(out[starts[g]:starts[g] + len(want)], want)
