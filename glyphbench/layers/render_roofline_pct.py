"""The render's share of its roofline: the least time of the SDF work
of the glyphs rendered in the traced requests (each glyph's own
segments and bitmap, `frozen.work.render_work`; max of operations over
67 TFLOP/s and bytes over 3.35 TB/s) over the summed time of every
device kernel in the traced window. It reads the same work whatever
kernels implement it."""

from glyphbench.layers._common import units

NAME = "render_roofline_pct"
UNIT = "%"
BETTER = "higher"
LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "glyphs_per_s"


def read(trace, drv):
    from glyphbench.frozen import work

    kernel_s = trace.kernel_s()
    n = units(trace)
    if not kernel_s or not n:
        return None
    w = drv.work_per_request()
    requests = n / drv.glyphs_per_request
    return 100.0 * requests * work.bound_s(w["f32_ops"], w["bytes"]) / kernel_s
