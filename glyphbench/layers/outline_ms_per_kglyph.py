"""The outline walk of the render: milliseconds a thousand glyphs in the
program's `font.outlines` spans (`FontFileEntry._flat`, the native
glyf/CFF walk and flatten of every mapped glyph), on the prep pool's
threads."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "outline_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "font ingest and prep"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "font.outlines"))
