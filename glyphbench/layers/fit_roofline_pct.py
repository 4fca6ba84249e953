"""The fit step's share of its roofline: the least time of each step's
min field and its backward (every glyph's chords and target pixels,
`frozen.work.fit_step_work`; max of operations over 67 TFLOP/s and
bytes over 3.35 TB/s) times the traced steps, over the summed time of
every device kernel in the traced window (the step's other work, the
loss, autograd and Adam, included)."""

from glyphbench.layers._common import units

NAME = "fit_roofline_pct"
UNIT = "%"
BETTER = "higher"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "fit_step_ms"


def read(trace, drv):
    from glyphbench.frozen import work

    kernel_s = trace.kernel_s()
    steps = units(trace)
    if not kernel_s or not steps:
        return None
    w = drv.work_per_step()
    return 100.0 * steps * work.bound_s(w["f32_ops"], w["bytes"]) / kernel_s
