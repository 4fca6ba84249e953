"""Bytes the render session moved between host and card a glyph:
`render.driver.WIRE_STATS` upload and fetch bytes over the traced
requests, over their glyphs. A count that repeats exactly."""

from glyphbench.layers._common import units

NAME = "wire_bytes_per_glyph"
UNIT = "B"
BETTER = "lower"
LAYER = "render session"
SOURCE = "program_counter"
MOVES = "glyphs_per_s"


def read(trace, drv):
    n = units(trace)
    wire = trace.counters.get("upload_bytes", 0) + trace.counters.get("fetch_bytes", 0)
    if not n or not wire:
        return None
    return wire / n
