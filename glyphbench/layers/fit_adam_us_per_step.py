"""The fit step's optimizer on the host: microseconds a step in the
program's `fit.adam` spans (`opt.step()` outside the graph)."""

from glyphbench.layers._program import busy_s, us_per_step

NAME = "fit_adam_us_per_step"
UNIT = "us"
BETTER = "lower"
LAYER = "fit step"
SOURCE = "program_span"
MOVES = "fit_step_ms"


def read(trace, drv):
    return us_per_step(trace, busy_s(trace, "fit.adam"))
