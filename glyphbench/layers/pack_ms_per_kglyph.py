"""The render session's pack: milliseconds a thousand glyphs in the
program's `session.pack` spans (`Renderer._dispatch_group`: the
packers, `tile_starts` and the lane-run check)."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "pack_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "render session"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "session.pack"))
