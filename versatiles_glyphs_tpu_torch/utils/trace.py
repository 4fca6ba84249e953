"""Spans of the port: named intervals at its layer boundaries, on the
`time.perf_counter` clock, kept in memory.

A span records only while a `torch.profiler` session records in the
process or after `enable`. Otherwise `span` returns one shared no-op
context: an untraced run pays one check a span and allocates nothing.

A record holds the span's name, its id, its parent's id (None for a
root), its request id (the root's id, shared by every span of one
request on every thread), the thread and its start and end. A span's
parent is the span open on its thread, or the ``parent`` it is given:
a `ThreadPoolExecutor` carries no context to its threads, so a span
that work hands to one is passed on explicitly (`current`). Records go
into a ring of `RING` records; ``dropped`` counts those pushed out.
A span adds nothing to the profiler's own timeline (a `record_function`
range costs ~14 us of host time, which paces a profiled fit): `cli --trace`
places the records there by the profiler's clock.

::

    with trace.span("cli.request"):
        parent = trace.current()
        pool.submit(work, parent)         # work: with trace.span("x", parent): ...
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

RING = 1 << 16

Record = collections.namedtuple("Record", "name id parent request thread start end")

_ring: collections.deque = collections.deque(maxlen=RING)
dropped = 0  # records pushed out of the full ring since the last `clear`
_ids = itertools.count(1)
_lock = threading.Lock()
_tls = threading.local()
_on = False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):  # named: no tuple packed a call
        return None


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "start", "_given")

    def __init__(self, name: str, parent):
        self.name = name
        self.id = next(_ids)
        self._given = parent

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        parent = self._given if self._given is not None else (stack[-1] if stack else None)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global dropped
        end = time.perf_counter()
        _tls.stack.pop()
        # A plain tuple of atoms: the collector stops tracking it, where it
        # tracks a namedtuple for good (a full ring then slows every pass).
        rec = (self.name, self.id, self.parent, self.request, threading.get_ident(),
               self.start, end)
        with _lock:
            if len(_ring) == RING:
                dropped += 1
            _ring.append(rec)


def span(name: str, parent=None):
    """A context manager of the span ``name``; ``parent``: a span of
    another thread (`current` there) to hang it under."""
    # The profiler's own flag: a module global, set while any session
    # records (`torch.autograd._profiler_enabled` is a C call a thread).
    if _on or _profiler._is_profiler_enabled:
        return _Span(name, parent)
    return _NOOP


def current():
    """The innermost recording span open on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def records() -> list:
    """The `Record`s in the ring, oldest first."""
    with _lock:
        return [Record._make(r) for r in _ring]


def clear() -> None:
    global dropped
    with _lock:
        _ring.clear()
        dropped = 0


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False
