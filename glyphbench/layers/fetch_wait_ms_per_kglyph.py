"""The main thread's wait for the card's bitmaps: milliseconds a
thousand glyphs in the program's `session.fetch_wait` spans on the
main thread (`_Group.wait`, until a group's fetch has completed)."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "fetch_wait_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "render session"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "session.fetch_wait", main_only=True))
