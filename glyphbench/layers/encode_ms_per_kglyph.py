"""The PBF encode: milliseconds a thousand glyphs in the program's
`proto.encode` spans by self time (the fetch waits and dispatches
that its pull of the bitmaps runs, its child spans, left out)."""

from glyphbench.layers._program import ms_per_kglyph, self_s

NAME = "encode_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "encode and write"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, self_s(trace, "proto.encode"))
