"""Synthesized curved glyphs of real-font size, for tests and the chip
smoke run.

`versatiles_glyphs_tpu.utils.synth_font.build_ttf` draws squares: about
8 lanes per glyph. The outlines here are deterministic quadratic-curve
contours (an outer ring and, for two glyphs in three, a hole of the
opposite orientation), whose flattening (`ops.flatten`) gives a few
hundred points per glyph at the default detail, like a text font, and
about a thousand at ``quads=24``, like a heavy script.

`curved_outlines`, `curved_preps`, `synth_fit_batch` and `SynthEntry`
need only numpy (and torch); `build_ttf_curved` wraps the same outlines
into a TrueType font with fontTools, imported where it is called. The
CPU tests show that the font and the synthesized forms agree: the same
preps, the same fit batch, the same metadata.
"""

from __future__ import annotations

import io
import math

import numpy as np

from ..ops.flatten import RingAccumulator
from ..render.metrics import prepare_glyph

UPEM = 1000
ASCENT = 800
DESCENT = -200


def _ring(rng, cx: int, cy: int, radius: float, n: int, reverse: bool):
    """On-curve points P_j and off-curve points C_j (integer font units)
    of one closed quadratic contour: quad j runs P_j → C_j → P_{j+1}."""
    step = 2.0 * math.pi / n
    ang = step * np.arange(n) + rng.uniform(-0.2, 0.2, n) * step
    if reverse:
        ang = ang[::-1]
    r_on = radius * rng.uniform(0.85, 1.0, n)
    mid = ang + np.diff(np.append(ang, ang[0] + (-1 if reverse else 1) * 2.0 * math.pi)) / 2.0
    on = [(cx + round(r * math.cos(a)), cy + round(r * math.sin(a))) for r, a in zip(r_on, ang)]
    off = [(cx + round(radius * math.cos(a)), cy + round(radius * math.sin(a))) for a in mid]
    return on, off


def curved_outlines(n_glyphs: int, seed: int = 0, quads: int = 8):
    """Per glyph ``(advance, contours)``, each contour an ``(on, off)``
    pair of equal-length integer point lists. Deterministic in
    ``(seed, glyph index)``."""
    out = []
    for k in range(n_glyphs):
        rng = np.random.default_rng([seed, k])
        radius = float(rng.integers(190, 360))
        cx = 60 + round(1.3 * radius)
        cy = round(1.3 * radius) - 120
        contours = [_ring(rng, cx, cy, radius, quads + int(rng.integers(0, 3)), False)]
        if k % 3:
            contours.append(_ring(rng, cx, cy, 0.4 * radius, max(quads * 3 // 4, 3), True))
        out.append((2 * cx, contours))
    return out


def _draw(contours, move_to, quad_to, close):
    for on, off in contours:
        move_to(*on[0])
        n = len(on)
        for j in range(n):
            quad_to(*off[j], *on[(j + 1) % n])
        close()


def curved_preps(n_glyphs: int, first_cp: int = 32, seed: int = 0, quads: int = 8):
    """`GlyphPrep`s of `curved_outlines`, flattened by `ops.flatten` and
    measured by `render.metrics.prepare_glyph`, for codepoints
    ``first_cp ..``: what a font file holding these outlines gives."""
    preps = []
    for k, (advance, contours) in enumerate(curved_outlines(n_glyphs, seed, quads)):
        acc = RingAccumulator()
        _draw(contours, acc.move_to, acc.quad_to, acc.close_path)
        preps.append(prepare_glyph(first_cp + k, acc.finish(), UPEM, advance))
    return preps


def build_ttf_curved(
    n_glyphs: int,
    first_cp: int = 32,
    seed: int = 0,
    quads: int = 8,
) -> bytes:
    """A TrueType font of `curved_outlines`, glyph k mapped from
    ``first_cp + k``."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    outlines = curved_outlines(n_glyphs, seed, quads)
    names = [f"g{k}" for k in range(n_glyphs)]
    fb = FontBuilder(UPEM, isTTF=True)
    fb.setupGlyphOrder([".notdef"] + names)
    fb.setupCharacterMap({first_cp + k: name for k, name in enumerate(names)})
    glyphs = {".notdef": TTGlyphPen(None).glyph()}
    metrics = {".notdef": (600, 0)}
    for name, (advance, contours) in zip(names, outlines):
        pen = TTGlyphPen(None)
        _draw(
            contours,
            lambda x, y: pen.moveTo((x, y)),
            lambda cx, cy, x, y: pen.qCurveTo((cx, cy), (x, y)),
            pen.closePath,
        )
        glyphs[name] = pen.glyph()
        # The left side bearing is the glyph's xMin, as font editors
        # write it: fontTools draws a glyph shifted by lsb − xMin.
        metrics[name] = (advance, min(x for on, off in contours for x, _ in on + off))
    fb.setupGlyf(glyphs)
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=ASCENT, descent=DESCENT)
    fb.setupNameTable(
        {"familyName": "Synth Curved", "styleName": "Regular", "psName": "SynthCurved-Regular"}
    )
    fb.setupOS2(sTypoAscender=ASCENT, sTypoDescender=DESCENT)
    fb.setupPost()
    buf = io.BytesIO()
    fb.save(buf)
    return buf.getvalue()


def _contour_curves(on, off):
    """The cubics [C, 4, 2] (font units, float64) that
    `versatiles_glyphs_tpu.font.entry.CurvePen` collects for one contour
    of `_draw`: each quadratic degree-elevated by 2/3, and a closing line
    (a collinear cubic) where the contour does not end at its start."""
    n = len(on)
    curves = []
    start = cur = on[0]
    for j in range(n):
        (sx, sy), (cx, cy), (ex, ey) = cur, off[j], on[(j + 1) % n]
        curves.append(((sx, sy),
                       (sx + 2.0 / 3.0 * (cx - sx), sy + 2.0 / 3.0 * (cy - sy)),
                       (ex + 2.0 / 3.0 * (cx - ex), ey + 2.0 / 3.0 * (cy - ey)),
                       (ex, ey)))
        cur = (ex, ey)
    if cur != start:
        (sx, sy), (ex, ey) = cur, start
        curves.append(((sx, sy),
                       (sx + (ex - sx) / 3.0, sy + (ey - sy) / 3.0),
                       (sx + 2.0 * (ex - sx) / 3.0, sy + 2.0 * (ey - sy) / 3.0),
                       (ex, ey)))
    return curves


def synth_fit_batch(
    n_glyphs: int,
    first_cp: int = 32,
    seed: int = 0,
    quads: int = 8,
    depth: int = 3,
    perturb: float = 0.0,
):
    """A `models.fitting.FitBatch` of `curved_outlines`, without a font
    file: what `models.fitting.make_fit_batch` gives for the font
    `build_ttf_curved` of the same arguments (a self-fit). Curves follow
    the rules of `font.entry.CurvePen`, scaled by 24/UPEM and shifted by
    ``prep.dx``; targets are exact SDFs of the `curved_preps` outlines
    (the native f64 renderer where it is built, else
    `ops.sdf_ref.render_sdf_exact`; the two agree byte for byte).
    ``perturb`` > 0 adds seeded normal noise of that scale (pixels) to
    the live control points of the start. ``depth`` is the caller's
    fitting depth: the batch itself does not depend on it."""
    from ..ops.sdf_ref import render_sdf_exact
    from ..proto import native

    from ..models.fitting import assemble_fit_batch, fit_item

    del depth
    preps = curved_preps(n_glyphs, first_cp, seed, quads)
    if native.available():
        bitmaps = native.render_sdf_batch(preps)
    else:
        bitmaps = [render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0) for p in preps]
    items = []
    for (_, contours), prep, bitmap in zip(curved_outlines(n_glyphs, seed, quads), preps, bitmaps):
        curves = np.asarray(
            [c for on, off in contours for c in _contour_curves(on, off)], np.float64
        )
        curves = curves * (24.0 / UPEM) + np.array([prep.dx, 0.0])
        items.append(fit_item(prep.codepoint, curves, prep, bitmap))
    batch = assemble_fit_batch(items)
    if perturb > 0:
        rng = np.random.default_rng(seed)
        noise = rng.normal(0.0, perturb, batch.curves0.shape).astype(np.float32)
        batch.curves0 = batch.curves0 + noise * batch.curve_mask[:, :, None, None]
    return batch


class _SynthMetadata:
    """The metadata fields `font.index_files` reads, as
    `font.entry.FontMetadata` parses them from `build_ttf_curved`."""

    def __init__(self, codepoints):
        from ..font.names import parse_font_name

        self.name = "Synth Curved"
        self.family, self.style, self.weight, self.width = parse_font_name(
            "Synth Curved", "SynthCurved-Regular"
        )
        self.codepoints = list(codepoints)

    def generate_name(self) -> str:
        from ..font.names import generate_name

        return generate_name(self.family, self.style, self.weight, self.width)


class SynthEntry:
    """The part of `font.entry.FontFileEntry` that
    `models.render_fitted.fitted_preps`, `render_fitted_pbfs`, the
    manager (`font.wrapper.FontWrapper`, `font.manager.FontManager`) and
    `render.driver.Renderer.prep_glyph` / `prep_block` read (glyph names
    and keys, outlines as flattened rings, advances, units per EM,
    metadata), for the font `build_ttf_curved(n_glyphs, first_cp, seed,
    quads)`, without fontTools. It has no table of prep cores, so the
    renderer preps each glyph from its rings: the preps of
    `curved_preps`."""

    units_per_em = UPEM
    prep_cores = None
    _cores_and_mode = (None, "name")

    def __init__(self, n_glyphs: int, first_cp: int = 32, seed: int = 0, quads: int = 8):
        self.first_cp = first_cp
        self._outlines = curved_outlines(n_glyphs, seed, quads)
        self.metadata = _SynthMetadata(range(first_cp, first_cp + n_glyphs))

    def glyph_name(self, codepoint: int):
        k = codepoint - self.first_cp
        return f"g{k}" if 0 <= k < len(self._outlines) else None

    glyph_key = glyph_name

    def hor_advance(self, name: str) -> int:
        return self._outlines[int(name[1:])][0]

    def outline_rings(self, name: str):
        """Flattened closed rings (font units, float64), as
        `curved_preps` flattens them."""
        acc = RingAccumulator()
        _draw(self._outlines[int(name[1:])][1], acc.move_to, acc.quad_to, acc.close_path)
        return acc.finish()


def _ring_prep(cp: int, w: int, h: int, ring):
    from ..render.metrics import GlyphPrep

    return GlyphPrep(codepoint=cp, advance=w, empty=False, width=w, height=h, x0=0, y0=0,
                     x1=w, y1=h, rings_px=[np.array(ring, dtype=np.float64)])


def row_list_edge_preps():
    """Three glyphs at the edges of the render kernels' crossing lists
    (``csrc/sdf_pair.cuh``, RowLists): a bitmap 3 pixels wide, so that
    256 pixels span 86 bitmap rows (more than a block lists); a comb
    whose rows cross 48 segments (more than a row lists); and a bitmap
    of 63 pixels, under one pixel tile of 64."""
    narrow = _ring_prep(70, 3, 90, [(0.5, 1.0), (2.5, 1.0), (2.5, 88.25), (0.5, 88.25), (0.5, 1.0)])
    teeth = [(2.0 + k, 28.5 if k % 2 else 2.25) for k in range(49)]
    comb = _ring_prep(71, 52, 30, [(2.0, 1.0), *teeth, (50.0, 1.0), (2.0, 1.0)])
    tiny = _ring_prep(72, 9, 7, [(1.0, 1.0), (7.5, 1.5), (4.0, 5.5), (1.0, 1.0)])
    return [narrow, comb, tiny]


def unaligned_point_chain():
    """A hand-made point chain (pts [2, 512] f32, mask words [16] i32,
    tile table [8, 6] i32 at 256 pixels a tile) for the render tile
    kernel's staging: a glyph whose lane run starts at lane 37, off a
    multiple of 32, with two rings (dead lanes 56 and 86 inside the
    run) over two tiles; a glyph whose lanes are all dead (bytes 0); a
    row with npts = 1 and one with npts = 0; and a row past w·h."""
    N = 512
    pts = np.zeros((2, N), np.float32)
    bits = np.zeros(N, bool)
    ang = np.linspace(0.0, 2 * np.pi, 20)[:-1]
    outer = np.stack([10 + 7.5 * np.cos(ang), 10 + 6.25 * np.sin(ang)], 1)
    outer = np.concatenate([outer, outer[:1]])  # 20 points, lanes 37..56
    ang = np.linspace(0.0, -2 * np.pi, 30)[:-1]
    inner = np.stack([10 + 3.5 * np.cos(ang), 10 + 2.75 * np.sin(ang)], 1)
    inner = np.concatenate([inner, inner[:1]])  # 30 points, lanes 57..86
    pts[:, 37:57] = outer.T
    pts[:, 57:87] = inner.T
    bits[37:56] = bits[57:86] = True
    pts[:, 100:110] = np.array([[2.0, 8, 8, 2, 2, 3, 4, 5, 6, 7], [2.0, 2, 8, 8, 2, 3, 4, 5, 6, 7]])
    pts[:, 120] = 4.0
    words = np.packbits(bits, bitorder="little").view(np.int32)
    tmeta = np.array([
        # x0, y0, w, h, npts, off, pix_base, _
        [0, 0, 20, 20, 50, 37, 0, 0], [0, 0, 20, 20, 50, 37, 256, 0],
        [0, 0, 10, 10, 10, 100, 0, 0], [0, 0, 8, 8, 1, 120, 0, 0], [0, 0, 8, 8, 0, 130, 0, 0],
        [0, 0, 20, 20, 50, 37, 512, 0],
    ], np.int32).T
    return pts, words, np.ascontiguousarray(tmeta)


def tied_point_chain():
    """A hand-made point chain (pts [2, 512] f32, mask words [16] i32,
    tile table [8, 2] i32 at 256 pixels a tile) for the min-field tile
    kernel's first argmin: one glyph of 400 points from lane 5, two
    staged chunks of lanes, four live segments, of which lanes 8 and 308
    are the same segment (the tie goes to 8, across the chunks and the
    dead lanes between)."""
    pts = np.zeros((2, 512), np.float32)
    bits = np.zeros(512, bool)
    for lane, (v, w) in {8: ((2.0, 2.0), (12.0, 15.0)), 308: ((2.0, 2.0), (12.0, 15.0)),
                         105: ((-2.0, 19.0), (0.0, 19.5)), 403: ((15.0, -2.0), (15.5, 0.0))}.items():
        pts[:, lane], pts[:, lane + 1] = v, w
        bits[lane] = True
    words = np.packbits(bits, bitorder="little").view(np.int32)
    tmeta = np.array([[-3, -3, 19, 23, 400, 5, 0, 0], [-3, -3, 19, 23, 400, 5, 256, 0]], np.int32).T
    return pts, words, np.ascontiguousarray(tmeta)


PADDED_EDGE_CASES = ("holes", "narrow", "comb", "chunks", "degenerate")
# The padded backward's: those, a glyph whose every pixel has one argmin
# segment, and a glyph of more pixels than one warp walks.
PADDED_BWD_EDGE_CASES = PADDED_EDGE_CASES + ("one_wins", "large")


def padded_edge_case(name: str):
    """An input at an edge of the padded min-field kernel
    (``csrc/sdf_min_field_padded.cu``), from a numpy seed: (segs
    [B, S, 4] f32, mask [B, S] f32, meta [B, 4] i32, P).

    ``holes``: masks with holes in the middle, so a staged segment's
    slot is not its index, and P = 437, a multiple of no block size.
    ``narrow``: a bitmap 5 pixels wide at P = 768, so that a span of
    384 pixels holds 77 bitmap rows, more than a block lists. ``comb``: glyph 0
    crosses every row 48 times, more than a row lists. ``chunks``: 300
    segments, more than a staged chunk; glyph 1 has four live ones, of
    which 3 and 260 are the same segment (the tie goes to 3).
    ``degenerate``: zero-length and horizontal segments, negative
    origins, and a glyph with every segment masked (the sentinel).
    ``one_wins``: glyph 0 has one live segment, so it wins every pixel.
    ``large``: 4,096 pixels a glyph, more than one warp of the padded
    backward kernel walks."""
    if name == "degenerate":
        segs = np.zeros((3, 8, 4), np.float32)
        segs[0, :6] = [[3, 4, 7, 4], [2, 2, 6, 2], [6, 2, 6, 6], [6, 6, 2, 6], [2, 6, 2, 2],
                       [4.5, 4.5, 4.5, 4.5]]
        segs[1, :3] = [[1, 1, 1, 1], [1, 1, 7, 1], [7, 1, 4, 5]]
        segs[2, :2] = [[0, 0, 5, 5], [5, 5, 0, 0]]  # masked below
        mask = np.zeros((3, 8), np.float32)
        mask[0, :6] = 1.0
        mask[1, :3] = 1.0
        return segs, mask, np.array([[0, 0, 10, 9], [-2, -1, 12, 6], [0, 0, 17, 17]], np.int32), 300
    seed, B, S, box, P = {
        "holes": (7, 4, 70, (-3, -3, 19, 23), 19 * 23),
        "narrow": (8, 2, 40, (0, 0, 5, 64), 768),
        "comb": (9, 2, 48, (0, 0, 16, 10), 160),
        "chunks": (10, 2, 300, (-3, -3, 19, 23), 19 * 23),
        "one_wins": (11, 2, 24, (-2, -2, 17, 17), 300),
        "large": (12, 3, 40, (0, 0, 64, 64), 4096),
    }[name]
    rng = np.random.default_rng(seed)
    x0, y0, w, h = box
    lo, hi = np.array([x0 - 1, y0 - 1] * 2), np.array([x0 + w + 1, y0 + h + 1] * 2)
    segs = rng.uniform(lo, hi, size=(B, S, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)
    if name == "comb":
        x = (1.0 + 0.3 * np.arange(S)).astype(np.float32)
        up = np.arange(S) % 2 == 0
        segs[0] = np.stack([x, np.where(up, 0.2, 9.8), x, np.where(up, 9.8, 0.2)], 1)
        mask[0] = 1.0
        mask[1, 12:] = 0.0  # glyph 1 stays inside the lists
    if name == "one_wins":
        mask[0] = 0.0
        mask[0, 5] = 1.0
    if name == "chunks":
        mask[1] = 0.0
        mask[1, [3, 100, 260, 299]] = 1.0
        segs[1, 3] = segs[1, 260] = [2.0, 2.0, 12.0, 15.0]
        segs[1, 100], segs[1, 299] = [-2.0, 19.0, 0.0, 19.5], [15.0, -2.0, 15.5, 0.0]
    return segs, mask, np.tile(np.array([box], np.int32), (B, 1)), P


def out_of_range_argmin(am: np.ndarray, S: int, seed: int = 0) -> np.ndarray:
    """``am`` [B, P] i32 with about an eighth of its entries, drawn from
    a numpy seed, replaced by values that name no segment of [0, S):
    negative ones, S and beyond, the sentinel 2³¹−1 and −2³¹. The padded
    backward must add nothing for them."""
    rng = np.random.default_rng(seed)
    bad = np.array([-1, -7, S, S + 9, 2**31 - 1, -(2**31)], np.int64)
    out = np.where(rng.uniform(size=am.shape) < 0.125, rng.choice(bad, size=am.shape), am)
    return out.astype(np.int32)


def degenerate_fit_plan():
    """A flat-plan point chain for the fitting kernels' edges: (plan,
    chain [2, N] f32 torch tensor) of three glyphs at depth 2, one with
    zero-length curves, a horizontal line and a square, one with no
    live segment (the argmin sentinel), and one whose bitmap has
    negative origins."""
    import torch

    from ..models import fitting

    curves = np.zeros((3, 8, 4, 2), np.float32)
    mask = np.zeros((3, 8), bool)
    lines = [((3, 4), (7, 4)), ((2, 2), (6, 2)), ((6, 2), (6, 6)), ((6, 6), (2, 6)),
             ((2, 6), (2, 2))]
    for c, (a, b) in enumerate(lines):
        a, b = np.array(a, np.float32), np.array(b, np.float32)
        curves[0, c] = [a, a + (b - a) / 3, a + 2 * (b - a) / 3, b]
    curves[0, 5:7] = 4.5
    mask[0, :7] = True
    meta = np.array([[0, 0, 10, 9], [0, 0, 17, 17], [-2, -1, 12, 6]], np.int32)
    plan = fitting.build_flat_plan(mask, meta, 2, 512)
    chain = fitting.flat_chain_points(torch.tensor(curves), torch.zeros(3, 2), 2,
                                      torch.as_tensor(plan.chunk_map).long())
    return plan, chain.contiguous()


# The flat backward's edge inputs, made from a plan's own (pts, am, ct,
# tile table) by `flat_bwd_edge_case`.
FLAT_BWD_EDGE_CASES = ("unmasked", "one_wins", "out_of_run", "unaligned", "short_runs")


def flat_bwd_edge_case(name: str, pts: np.ndarray, am: np.ndarray, tmeta: np.ndarray,
                       seed: int = 0):
    """An input at an edge of the flat backward kernel
    (``csrc/sdf_min_field_bwd.cu``), made from a flat plan's point chain
    pts [2, N] f32, a forward's argmin am [T, TP] i32 and the tile table
    [8, T] i32, with a cotangent drawn from a numpy seed over every
    pixel (past w·h and on skip rows too, where it must add nothing):
    (pts, am, ct [T, TP] f32, tmeta), numpy arrays.

    ``unmasked``: the plan as it is. ``one_wins``: every pixel of a glyph
    has the argmin lane off + (npts − 1) // 2 (a step's 32 lanes are one
    set). ``out_of_run``: about a quarter of the argmins replaced by
    lanes outside their glyph's segment lanes [off, off + npts − 1): the
    lane before the run, the chain's last point, lanes past it, another
    glyph's lane, negative ones, N and beyond, and the sentinel.
    ``unaligned``: the lanes shifted by 5, so that no run starts on a
    multiple of 32. ``short_runs``: glyph 0 given npts = 1 and glyph 1
    npts = 0 (their argmins then lie outside their runs, and glyph 0
    owns one lane, glyph 1 none)."""
    rng = np.random.default_rng(seed)
    pts, am, tmeta = pts.copy(), am.copy(), tmeta.copy()
    T, TP = am.shape
    N = pts.shape[1]
    ct = rng.normal(size=(T, TP)).astype(np.float32)
    first = np.flatnonzero((tmeta[6] == 0) & (tmeta[2] * tmeta[3] > 0) & (tmeta[4] >= 2))
    # Each glyph's rows: from its first row while pix_base goes up.
    glyph = np.full(T, -1)
    for g, t0 in enumerate(first):
        t = t0
        while t < T and (t == t0 or tmeta[6, t] == tmeta[6, t - 1] + TP):
            glyph[t] = g
            t += 1
    off, npts = tmeta[5, first].astype(np.int64), tmeta[4, first].astype(np.int64)
    if name == "one_wins":
        rows = glyph >= 0
        am[rows] = (off + (npts - 1) // 2)[glyph[rows]][:, None]
    elif name == "out_of_run":
        rows = glyph >= 0
        g = glyph[rows][:, None]
        other = off[(glyph[rows] + 1) % len(first)][:, None]
        bad = np.stack(np.broadcast_arrays(
            off[g] - 1, off[g] + npts[g] - 1, off[g] + npts[g] + 3, other,
            np.full_like(g, -5), np.full_like(g, N), np.full_like(g, N + 40),
            np.full_like(g, 2**31 - 1)), -1)  # [rows, 1, 8]
        pick = bad[:, 0, :][np.arange(g.shape[0])[:, None], rng.integers(0, 8, size=(g.shape[0], TP))]
        am[rows] = np.where(rng.uniform(size=pick.shape) < 0.25, pick, am[rows])
    elif name == "unaligned":
        pts = np.concatenate([np.zeros((2, 5), np.float32), pts], 1)
        am = np.where((am >= 0) & (am < N), am + 5, am)
        tmeta[5] += 5
    elif name == "short_runs":
        tmeta[4, glyph == 0] = 1
        tmeta[4, glyph == 1] = 0
    elif name != "unmasked":
        raise ValueError(f"unknown flat backward case {name!r}")
    return pts, am.astype(np.int32), ct, np.ascontiguousarray(tmeta)
