"""The font-level metrics pass of the render: milliseconds a thousand
glyphs in the program's `font.build_cores` spans
(`render.metrics.build_cores`, the outline walk left out), on the prep
pool's threads."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "cores_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "font ingest and prep"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "font.build_cores"))
