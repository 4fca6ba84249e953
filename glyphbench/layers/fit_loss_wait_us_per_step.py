"""The host's wait for the card in the fit: microseconds a step in the
program's `fit.loss_fetch` spans (the losses' copy at the end of each
call, which returns once the card has run the call's steps). Near
zero while the host paces the loop; it grows where the card does."""

from glyphbench.layers._program import busy_s, us_per_step

NAME = "fit_loss_wait_us_per_step"
UNIT = "us"
BETTER = "lower"
LAYER = "fit step"
SOURCE = "program_span"
MOVES = "fit_step_ms"


def read(trace, drv):
    return us_per_step(trace, busy_s(trace, "fit.loss_fetch"))
