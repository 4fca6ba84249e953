"""Synthesized curved glyphs of real-font size, for tests and the chip
smoke run.

`versatiles_glyphs_tpu.utils.synth_font.build_ttf` draws squares: about
8 lanes per glyph. The outlines here are deterministic quadratic-curve
contours (an outer ring and, for two glyphs in three, a hole of the
opposite orientation), whose flattening (`ops.flatten`) gives a few
hundred points per glyph at the default detail, like a text font, and
about a thousand at ``quads=24``, like a heavy script.

`curved_outlines` and `curved_preps` need only numpy; `build_ttf_curved`
wraps the same outlines into a TrueType font with fontTools, imported
where it is called.
"""

from __future__ import annotations

import io
import math

import numpy as np

from versatiles_glyphs_tpu.ops.flatten import RingAccumulator
from versatiles_glyphs_tpu.render.metrics import prepare_glyph

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
        metrics[name] = (advance, 0)
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
