"""The fit step's graph replay on the host: microseconds a step in the
program's `fit.replay` spans (the replay's enqueue, `count_replay`
included)."""

from glyphbench.layers._program import busy_s, us_per_step

NAME = "fit_replay_us_per_step"
UNIT = "us"
BETTER = "lower"
LAYER = "fit step"
SOURCE = "program_span"
MOVES = "fit_step_ms"


def read(trace, drv):
    return us_per_step(trace, busy_s(trace, "fit.replay"))
