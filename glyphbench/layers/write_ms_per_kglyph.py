"""The output's writes: milliseconds a thousand glyphs in the program's
`writer.write` spans (every file, index files included) and
`writer.clear` (the output directory cleared before a request)."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "write_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "encode and write"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "writer.write", "writer.clear"))
