"""Font generator ``text_ttf``: one TrueType font a style of ``styles``
([style name, fontstack id]), family ``family``, each of ``glyphs``
`synth_font.curved_outlines` glyphs (``quads``, default 8) of which the
first are mapped from the codepoints of ``codepoint_ranges`` (inclusive
[first, last] pairs)."""

from __future__ import annotations

from glyphbench.deploy import Font, codepoints, font_seed
from glyphbench.frozen import outlines, synth_font


def fonts(spec: dict, first: int, seed: int) -> list:
    cps = codepoints(spec)
    return [Font(f"{first + k:02d}-{fs}.ttf", fs, spec["family"], style, "text_ttf",
                 font_seed(seed, first + k), int(spec["glyphs"]), int(spec.get("quads", 8)), cps)
            for k, (style, fs) in enumerate(spec["styles"])]


def font_bytes(font: Font) -> bytes:
    return synth_font.build_ttf(font.codepoints.tolist(), font.n_glyphs, font.seed, font.quads,
                                family=font.family, style=font.style)


def rings(font: Font) -> outlines.FontRings:
    return outlines.text_font_rings(len(font.codepoints), font.seed, font.quads)
