"""Font generator ``cid_cff_otf_ranges``: one CID-keyed CFF OpenType
font, family ``family`` and style ``style``, fontstack ``fontstack``, of
``glyphs`` `synth_font.cjk_outlines` ideographs, glyph k mapped from the
k-th codepoint of ``codepoint_ranges`` (any blocks, one glyph a
codepoint). The frozen writer's font (``cid_cff_otf``) with its cmap
written anew over those codepoints, and OS/2's first and last
character index with it: a CJK member whose coverage is not the
writer's URO and Ext A, such as kana or hangul."""

from __future__ import annotations

import struct

from glyphbench.deploy import Font, codepoints, font_seed
from glyphbench.frozen import outlines, synth_font


def fonts(spec: dict, first: int, seed: int) -> list:
    cps = codepoints(spec)
    if len(cps) != int(spec["glyphs"]) or len(set(cps.tolist())) != len(cps):
        raise ValueError("cid_cff_otf_ranges maps every glyph from one codepoint of its own")
    return [Font(f"{first:02d}-{spec['fontstack']}.otf", spec["fontstack"], spec["family"],
                 spec["style"], "cid_cff_otf_ranges", font_seed(seed, first), len(cps), 0, cps)]


def _tables(font: bytes) -> dict:
    """tag -> bytes of an sfnt's tables."""
    n = struct.unpack_from(">H", font, 4)[0]
    out = {}
    for i in range(n):
        tag, _, off, length = struct.unpack_from(">4sIII", font, 12 + 16 * i)
        out[tag.decode("latin1")] = font[off:off + length]
    return out


def font_bytes(font: Font) -> bytes:
    tables = _tables(synth_font.build_otf_curved(font.n_glyphs, font.seed, cid=True,
                                                 family=font.family, style=font.style))
    cps = [int(cp) for cp in font.codepoints]
    tables["cmap"] = synth_font._cmap_table({cp: k + 1 for k, cp in enumerate(cps)})
    os2 = bytearray(tables["OS/2"])
    os2[64:68] = struct.pack(">HH", min(min(cps), 0xFFFF), min(max(cps), 0xFFFF))
    tables["OS/2"] = bytes(os2)
    head = bytearray(tables["head"])
    head[8:12] = bytes(4)  # checkSumAdjustment, set again over the new file
    tables["head"] = bytes(head)
    return synth_font._sfnt(tables, b"OTTO")


def rings(font: Font) -> outlines.FontRings:
    return outlines.cjk_font_rings(len(font.codepoints), font.seed)
