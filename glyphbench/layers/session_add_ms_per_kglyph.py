"""The render session's host side: milliseconds a thousand glyphs spent
in `RenderSession.add` on the main thread (pack, lane-run check,
upload, launch)."""

from glyphbench.layers._common import units

NAME = "session_add_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "render session"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    n = units(trace)
    busy = trace.spans.busy("RenderSession.add", trace.t0, trace.t1)
    if not n or not busy:
        return None
    return 1e3 * busy / (n / 1e3)
