"""How full the render's tiles are: 100 × the bitmaps' own pixels
(w·h) over the 256-pixel tiles the kernel renders for them, from
`render.driver.WIRE_STATS` over the traced requests. A count that
repeats exactly."""

NAME = "tile_fill_pct"
UNIT = "%"
BETTER = "higher"
LAYER = "kernels"
SOURCE = "program_counter"
MOVES = "glyphs_per_s"


def read(trace, drv):
    tiles = trace.counters.get("tiles", 0)
    if not tiles:
        return None
    return 100.0 * trace.counters.get("pixels", 0) / (256 * tiles)
