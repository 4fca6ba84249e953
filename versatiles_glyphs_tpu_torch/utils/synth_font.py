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
    `models.render_fitted.fitted_preps` and `render_fitted_pbfs` read
    (glyph names, advances, units per EM, metadata), for the font
    `build_ttf_curved(n_glyphs, first_cp, seed, quads)`, without
    fontTools."""

    units_per_em = UPEM

    def __init__(self, n_glyphs: int, first_cp: int = 32, seed: int = 0, quads: int = 8):
        self.first_cp = first_cp
        self._advances = [adv for adv, _ in curved_outlines(n_glyphs, seed, quads)]
        self.metadata = _SynthMetadata(range(first_cp, first_cp + n_glyphs))

    def glyph_name(self, codepoint: int):
        k = codepoint - self.first_cp
        return f"g{k}" if 0 <= k < len(self._advances) else None

    def hor_advance(self, name: str) -> int:
        return self._advances[int(name[1:])]
