"""Device events a fit step: the kernels, copies and sets the card ran
in the traced window (`torch.profiler`) over the traced steps."""

from glyphbench.layers._common import units

NAME = "fit_events_per_step"
UNIT = "events"
BETTER = "lower"
LAYER = "fit step"
SOURCE = "device_trace"
MOVES = "fit_step_ms"


def read(trace, drv):
    steps = units(trace)
    events = trace.in_window()
    if not events or not steps:
        return None
    return len(events) / steps
