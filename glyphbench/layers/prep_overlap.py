"""How far the files of a render prep at once: the summed seconds of
the program's `manager.prep_file` spans over the union of their
intervals, the mean number of files in prep while any is (1: one after
another, as a one-file merge always reads)."""

from glyphbench.harness import union_s
from glyphbench.layers._program import records

NAME = "prep_overlap"
UNIT = "x"
BETTER = "higher"
LAYER = "cli / font.manager"
SOURCE = "program_span"
MOVES = "glyphs_per_s"


def read(trace, drv):
    recs = records(trace)
    spans = [(r.start, r.end) for r in recs or () if r.name == "manager.prep_file"]
    union = union_s(spans)
    if not union:
        return None
    return sum(b - a for a, b in spans) / union
