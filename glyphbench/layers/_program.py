"""Shared by the readers of the program's own spans
(`versatiles_glyphs_tpu_torch.utils.trace`, which records while the
traced window's profiler runs): its records that start in the window,
and the seconds of a span by name, in all or by self time. Each returns
None where the program has no span module or recorded no such span."""

from glyphbench.harness import clip, union_s
from glyphbench.layers._common import units


def records(trace):
    """The program's span records that start in the traced window, or
    None where the program has no span module."""
    try:
        from versatiles_glyphs_tpu_torch.utils import trace as program
    except ImportError:
        return None
    return [r for r in program.records() if trace.t0 <= r.start <= trace.t1]


def _named(trace, names, main_only):
    recs = records(trace)
    if recs is None:
        return None, None
    sel = [r for r in recs if r.name in names and (not main_only or r.thread == trace.spans.main)]
    return (recs, sel) if sel else (recs, None)


def busy_s(trace, *names, main_only=False):
    """Seconds of the spans ``names`` (on every thread, or on the main
    thread alone), summed; None where none was recorded."""
    _, sel = _named(trace, names, main_only)
    if sel is None:
        return None
    return sum(r.end - r.start for r in sel)


def self_s(trace, name, main_only=False):
    """Seconds of the spans ``name`` less the part of each that its child
    spans cover; None where none was recorded."""
    recs, sel = _named(trace, (name,), main_only)
    if sel is None:
        return None
    children: dict = {}
    for r in recs:
        children.setdefault(r.parent, []).append((r.start, r.end))
    return sum(r.end - r.start - union_s(clip(children.get(r.id, []), r.start, r.end))
               for r in sel)


def ms_per_kglyph(trace, seconds):
    """Milliseconds a thousand glyphs of the traced requests."""
    n = units(trace)
    if not n or seconds is None:
        return None
    return 1e3 * seconds / (n / 1e3)


def us_per_step(trace, seconds):
    """Microseconds a step of the traced requests."""
    n = units(trace)
    if not n or seconds is None:
        return None
    return 1e6 * seconds / n
