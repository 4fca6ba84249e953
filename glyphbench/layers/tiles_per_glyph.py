"""The kernel's work a glyph in tiles: the 256-pixel tiles the render
dispatched over the glyphs it dispatched, both from
`render.driver.WIRE_STATS` over the traced requests. A count that
repeats exactly."""

NAME = "tiles_per_glyph"
UNIT = "tiles"
BETTER = "lower"
LAYER = "kernels"
SOURCE = "program_counter"
MOVES = "glyphs_per_s"


def read(trace, drv):
    glyphs = trace.counters.get("glyphs", 0)
    if not glyphs:
        return None
    return trace.counters.get("tiles", 0) / glyphs
