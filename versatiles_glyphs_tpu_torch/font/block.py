"""Glyph blocks: the shard/batch unit (256 codepoints → one .pbf).

Mirrors `reference/src/font/glyph_block.rs`: a block covers
``start .. start+255``; each contained codepoint is owned by the first
font file that claimed it. Rendering produces the encoded `glyphs`
protobuf for the block's fontstack. In the TPU build a block is also the
natural device batch (see `render.batch`) and the data-parallel shard
unit (see `parallel.mesh`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..constants import GLYPH_BLOCK_SIZE
from ..proto.pbf import encode_glyphs

if TYPE_CHECKING:  # a block only holds entries
    from .entry import FontFileEntry


class GlyphBlock:
    def __init__(self, start_index: int):
        self.start_index = start_index
        # char offset (0..255) -> FontFileEntry; first claim wins.
        self.glyphs: dict[int, FontFileEntry] = {}

    def set_glyph_font(self, char_index: int, font: FontFileEntry) -> None:
        self.glyphs.setdefault(char_index, font)

    def __len__(self) -> int:
        return len(self.glyphs)

    def files(self) -> list[FontFileEntry]:
        """The entries that own a glyph of the block, each once, in the
        order of their first glyph."""
        return list({id(e): e for e in self.glyphs.values()}.values())

    def range(self) -> str:
        return f"{self.start_index}-{self.start_index + GLYPH_BLOCK_SIZE - 1}"

    def filename(self) -> str:
        return f"{self.range()}.pbf"

    def glyph_sources(self) -> list[tuple[int, FontFileEntry]]:
        """(codepoint, entry) pairs in codepoint order. (The reference
        iterates HashMap order — PBF glyph order is unordered by spec;
        `debug` sorts on read. We render sorted for determinism.)"""
        return [
            (self.start_index + ci, self.glyphs[ci]) for ci in sorted(self.glyphs)
        ]

    def render(self, font_name: str, renderer) -> bytes:
        glyphs = renderer.render_block_glyphs(self.glyph_sources())
        return encode_glyphs(font_name, self.range(), glyphs)
