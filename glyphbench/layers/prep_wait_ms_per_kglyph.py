"""The main thread's wait for the prep pool: milliseconds a thousand
glyphs in the program's `manager.prep_wait` spans on the main thread
(`FontManager.render_glyphs`, a font's prep future)."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "prep_wait_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "cli / font.manager"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "manager.prep_wait", main_only=True))
