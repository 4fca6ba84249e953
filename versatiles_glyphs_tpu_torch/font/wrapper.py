"""FontWrapper: one logical font = N files (script splits).

Mirrors `reference/src/font/wrapper.rs`: files sharing a
normalized name merge; block assembly walks each file's codepoint
coverage, and the first file (in insertion order) to claim a codepoint
wins (span `font.claim`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ..constants import GLYPH_BLOCK_SIZE
from ..utils import trace
from .block import GlyphBlock

if TYPE_CHECKING:  # the parser is imported where a file is read
    from .entry import FontFileEntry, FontMetadata


class FontWrapper:
    def __init__(self):
        self.files: list[FontFileEntry] = []

    def add_file(self, file: FontFileEntry) -> None:
        self.files.append(file)

    def add_paths(self, sources) -> None:
        from .entry import FontFileEntry

        for path in sources:
            with open(path, "rb") as f:
                data = f.read()
            try:
                file = FontFileEntry(data)
            except Exception as e:
                # Contextual error instead of a raw parser traceback
                # (the reference's anyhow context chain,
                # `wrapper.rs:137-146`).
                raise ValueError(
                    f"failed to parse font file {str(path)!r}: {e}"
                ) from e
            self.files.append(file)

    def get_blocks(self) -> list[GlyphBlock]:
        with trace.span("font.claim"):
            blocks: dict[int, GlyphBlock] = {}
            for font_file in self.files:
                for cp in font_file.metadata.codepoints:
                    block_index = cp // GLYPH_BLOCK_SIZE
                    char_index = cp % GLYPH_BLOCK_SIZE
                    block = blocks.get(block_index)
                    if block is None:
                        block = blocks[block_index] = GlyphBlock(
                            block_index * GLYPH_BLOCK_SIZE
                        )
                    block.set_glyph_font(char_index, font_file)
            return list(blocks.values())

    def get_metadata(self) -> FontMetadata:
        if not self.files:
            raise ValueError("FontWrapper has no files")
        return self.files[0].metadata
