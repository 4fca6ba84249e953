"""Font generator ``cid_cff_otf``: one CID-keyed CFF OpenType font,
family ``family`` and style ``style``, fontstack ``fontstack``, of
``glyphs`` `synth_font.cjk_outlines` ideographs, each mapped from the
codepoints of ``codepoint_ranges``. The frozen writer maps its glyphs
to `synth_font.CJK_RANGES` (URO and Ext A) in order and nothing else,
so the ranges have to be those, or their start."""

from __future__ import annotations

import numpy as np

from glyphbench.deploy import Font, codepoints, font_seed
from glyphbench.frozen import outlines, synth_font


def fonts(spec: dict, first: int, seed: int) -> list:
    cps = codepoints(spec)
    cjk = synth_font.cjk_codepoints(len(cps))
    if len(cps) != int(spec["glyphs"]) or not np.array_equal(cps, cjk):
        raise ValueError("cid_cff_otf maps every glyph, from the writer's CJK blocks in order")
    return [Font(f"{first:02d}-{spec['fontstack']}.otf", spec["fontstack"], spec["family"],
                 spec["style"], "cid_cff_otf", font_seed(seed, first), len(cps), 0, cps)]


def font_bytes(font: Font) -> bytes:
    return synth_font.build_otf_curved(font.n_glyphs, font.seed, cid=True, family=font.family,
                                       style=font.style)


def rings(font: Font) -> outlines.FontRings:
    return outlines.cjk_font_rings(len(font.codepoints), font.seed)
