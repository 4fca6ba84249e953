"""The font read of the render: milliseconds a thousand glyphs in the
program's `font.read` spans (`FontManager.add_path`: the file read and
`FontFileEntry`, its directory, names, cmap and hmtx)."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "font_read_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "font ingest and prep"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "font.read"))
