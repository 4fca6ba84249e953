"""The claim walk of a merge: milliseconds a thousand glyphs in the
program's `font.claim` spans (`FontWrapper.get_blocks`, each codepoint
given to the first file that maps it) on the main thread."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "claim_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "cli / font.manager"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "font.claim", main_only=True))
