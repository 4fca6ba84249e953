"""The card's idle share over the traced render window: 100 × (1 − the
union of its kernels', copies' and sets' intervals ÷ the window),
from `torch.profiler`."""

from glyphbench.layers._common import device_idle_pct

NAME = "device_idle_pct.render"
UNIT = "%"
BETTER = "lower"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "glyphs_per_s"


def read(trace, drv):
    return device_idle_pct(trace)
