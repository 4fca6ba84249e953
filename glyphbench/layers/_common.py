"""Shared by the readers: the glyphs and steps of the traced requests."""


def units(trace) -> int:
    return sum(u for _, _, u, ok in trace.requests if ok)


def device_idle_pct(trace):
    """100 × (1 − union of the device's kernels, copies and sets ÷ the
    traced window); None where the trace holds no device event."""
    if not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
