"""The per-file prep of a render: milliseconds a thousand glyphs in the
program's `manager.prep_file` spans (one a font file: its outline walk
and prep cores, on the prep pool), summed over the pool's threads."""

from glyphbench.layers._program import busy_s, ms_per_kglyph

NAME = "prep_file_ms_per_kglyph"
UNIT = "ms"
BETTER = "lower"
LAYER = "font ingest and prep"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return ms_per_kglyph(trace, busy_s(trace, "manager.prep_file"))
