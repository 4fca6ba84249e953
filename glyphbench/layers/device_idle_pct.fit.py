"""The card's idle share over the traced fit window: 100 × (1 − the
union of its kernels', copies' and sets' intervals ÷ the window),
from `torch.profiler`."""

from glyphbench.layers._common import device_idle_pct

NAME = "device_idle_pct.fit"
UNIT = "%"
BETTER = "lower"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "fit_step_ms"


def read(trace, drv):
    return device_idle_pct(trace)
