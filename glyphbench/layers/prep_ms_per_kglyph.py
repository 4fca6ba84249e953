"""Host prep of the render: milliseconds a thousand glyphs spent in
`Renderer.prep_block` (each block's parse, flatten and metrics pass,
`font/manager.py`), summed over the prep pool's threads."""

from glyphbench.layers._common import units

NAME = "prep_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "font ingest and prep"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    n = units(trace)
    busy = trace.spans.busy("prep_block", trace.t0, trace.t1)
    if not n or not busy:
        return None
    return 1e3 * busy / (n / 1e3)
