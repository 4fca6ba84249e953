"""The benchmark's machinery, driven by the files beside it.

A cell is ``workloads/<cell>.json``: its configuration (a font
deployment, ``configs/<config>.json``), its traffic kind (a driver,
``traffic/<kind>.py``, and the parameters the file gives it), its
chips and its limits. A per-layer metric is a reader,
``layers/<metric>.py``. `run_cell` runs one cell once:

1. set-up: the driver writes the deployment's fonts from the seed and
   warms up every shape the window uses (its time from the process's
   start is ``setup_s``);
2. the window: whole requests, one after the other (a closed loop of
   one client), until ``seconds`` have passed since the first began;
   with ``trace`` the first ``trace_requests`` run under
   `torch.profiler` and the harness's spans;
3. the device's peak memory is read and the program's state freed;
4. with ``trace``, every reader whose end-to-end metric the cell reports;
5. the comparison with the plain reference (`reference`), whose
   numbers, each beside its limit, decide ``correct``.

Spans are the harness's own: around calls into the program's layers,
wrapped from here for the traced run alone (`Spans`).
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
import sys
import threading
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Modules that may not be loaded once a window has closed: JAX and the
# JAX package, compared by the whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "versatiles_glyphs_tpu")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def forbidden_modules(modules=None) -> list:
    """The top-level names among ``modules`` (default: `sys.modules`)
    that are in `FORBIDDEN`, by whole name."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def process_start_time() -> float:
    """This process's start on the `time.time` clock, from /proc (the
    interpreter's own start included)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Definitions:
    """The cells, configurations, traffic drivers and readers found
    under one directory (the benchmark's own, or a test's)."""

    def __init__(self, root: str = BENCH_DIR):
        self.root = root

    def cell(self, name: str) -> dict:
        if not NAME_RE.match(name):
            raise ValueError(f"bad workload name {name!r}")
        path = os.path.join(self.root, "workloads", f"{name}.json")
        if not os.path.exists(path):
            raise ValueError(f"no workload {name!r} (no {path})")
        cell = load_json(path)
        cell["name"] = name
        return cell

    def config(self, name: str) -> dict:
        if not NAME_RE.match(name):
            raise ValueError(f"bad config name {name!r}")
        return load_json(os.path.join(self.root, "configs", f"{name}.json"))

    def driver(self, kind: str):
        if not NAME_RE.match(kind):
            raise ValueError(f"bad traffic kind {kind!r}")
        path = os.path.join(self.root, "traffic", f"{kind}.py")
        return load_module(path, f"glyphbench_traffic_{kind}")

    def readers(self) -> list:
        out = []
        for path in sorted(glob.glob(os.path.join(self.root, "layers", "*.py"))):
            name = os.path.basename(path)[:-3]
            if name.startswith("_"):
                continue
            out.append(load_module(path, "glyphbench_layer_" + name.replace(".", "_")))
        return out


# -- spans ------------------------------------------------------------------


class Spans:
    """(name, thread id, start s, end s) of calls wrapped by `wrap`,
    on the `time.perf_counter` clock; `unwrap` puts the originals back."""

    def __init__(self):
        self.records: list = []
        self.main = threading.get_ident()
        self._undo: list = []
        self.on = False

    def wrap(self, owner, attr: str, name: str, main_only: bool = False) -> None:
        orig = getattr(owner, attr)
        spans = self

        def wrapped(*a, **k):
            if not spans.on or (main_only and threading.get_ident() != spans.main):
                return orig(*a, **k)
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                spans.records.append((name, threading.get_ident(), t0, time.perf_counter()))

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def span(self, name: str):
        spans = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                spans.records.append((name, threading.get_ident(), self.t0, time.perf_counter()))

        return _Ctx()

    def unwrap(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def busy(self, name: str, t0: float, t1: float) -> float:
        """Seconds of spans ``name`` (every thread) that start in [t0, t1]."""
        return sum(b - a for n, _, a, b in self.records if n == name and t0 <= a <= t1)


# -- device trace -----------------------------------------------------------


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def clip(intervals, t0: float, t1: float) -> list:
    return [(max(a, t0), min(b, t1)) for a, b in intervals if b > t0 and a < t1]


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a set."""
    low = name.lower()
    return not ("memcpy" in low or "memset" in low)


def idle_gaps(busy_intervals, t0: float, t1: float, spans, main: int) -> dict:
    """{label: seconds} of the device's idle time in [t0, t1], each
    piece labelled by the innermost span open on the main thread then
    (``between requests`` outside any): one sweep over the span and
    busy-interval edges in time order."""
    edges = []  # (time, order at equal times, kind, span id)
    for k, (n, tid, a, b) in enumerate(spans):
        if tid == main and b > t0 and a < t1:
            edges += [(max(a, t0), 1, "open", k), (min(b, t1), 0, "close", k)]
    for a, b in clip(busy_intervals, t0, t1):
        edges += [(a, 1, "busy", None), (b, 0, "idle", None)]
    edges.sort(key=lambda e: (e[0], e[1]))
    out: dict = {}
    stack: list = []
    busy = 0
    prev = t0
    for t, _, kind, k in edges:
        if busy == 0 and t > prev:
            label = spans[stack[-1]][0] if stack else "between requests"
            out[label] = out.get(label, 0.0) + (t - prev)
        prev = max(prev, t)
        if kind == "open":
            stack.append(k)
        elif kind == "close":
            stack.remove(k)
        elif kind == "busy":
            busy += 1
        else:
            busy -= 1
    if busy == 0 and t1 > prev:
        label = "between requests"
        out[label] = out.get(label, 0.0) + (t1 - prev)
    return out


class Trace:
    """What a traced window leaves: device events (name, start s, end s)
    on the perf_counter clock, the window, spans, and the driver's
    counts over the traced requests."""

    def __init__(self, events, t0, t1, spans: Spans, requests: list, counters: dict | None = None):
        self.events = events
        self.t0, self.t1 = t0, t1
        self.spans = spans
        self.requests = requests
        self.counters = counters or {}  # the driver's counters' change over the traced requests

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def in_window(self):
        return [e for e in self.events if self.t0 <= e[1] <= self.t1]

    @property
    def busy_s(self) -> float:
        return union_s(clip([(a, b) for _, a, b in self.events], self.t0, self.t1))

    def kernel_s(self) -> float:
        return sum(b - a for n, a, b in self.in_window() if is_kernel(n))


def profile_events(prof, mark_name: str, mark_t: float) -> list:
    """The device events of a `torch.profiler` run, (name, start s, end s)
    moved onto the perf_counter clock by the marker ``mark_name``
    recorded at ``mark_t``."""
    from torch.autograd import DeviceType

    evs = prof.events()
    mark = next((e for e in evs if e.name == mark_name), None)
    if mark is None:
        raise RuntimeError("the profiler recorded no marker: its clock cannot be read")
    off = mark_t - mark.time_range.start * 1e-6
    return [(e.name, e.time_range.start * 1e-6 + off, e.time_range.end * 1e-6 + off)
            for e in evs if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _stop_profile(prof, spans: Spans, device, mark_t: float) -> list:
    """End a traced window: wait for the card, stop the spans and the
    profiler, and return its device events on the perf_counter clock."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans.on = False
    prof.__exit__(None, None, None)
    return profile_events(prof, "glyphbench.mark", mark_t)


def breakdown(trace: Trace) -> dict:
    by_op: dict = {}
    for n, a, b in trace.in_window():
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps([(a, b) for _, a, b in trace.events], trace.t0, trace.t1,
                     trace.spans.records, trace.spans.main)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in top]}


# -- one run ----------------------------------------------------------------


class Context:
    """What a driver gets: the cell, its configuration, the seed, a
    scratch directory under TMPDIR, the device and the spans."""

    def __init__(self, cell, config, seed, workdir, device, spans, phases):
        self.cell, self.config, self.seed = cell, config, seed
        self.workdir, self.device, self.spans = workdir, device, spans
        self.phases = phases  # {set-up phase: seconds}, in order

    def phase(self, name: str):
        ctx = self

        class _P:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                ctx.phases[name] = ctx.phases.get(name, 0.0) + time.perf_counter() - self.t0

        return _P()


def _log(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def run_cell(defs: Definitions, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, phases: dict, workdir: str) -> dict:
    """One run of cell ``name``; returns the result object (`correct`,
    `attempted`, `failed`, `metrics`, `device` and, traced,
    `breakdown`; the numbers compared under `checks`). ``t_start`` is
    the process's start (`time.time` clock); ``phases`` holds the
    set-up phases so far."""
    import torch

    cell = defs.cell(name)
    config = defs.config(cell["config"])
    drv_mod = defs.driver(cell["traffic"])
    spans = Spans()
    ctx = Context(cell, config, seed, workdir, device, spans, phases)
    drv = drv_mod.Driver(ctx)
    drv.setup()
    if trace:
        drv.wrap_spans(spans)

    # -- the window ---------------------------------------------------------
    n_traced = cell.get("trace_requests")  # None: every request of the window
    requests: list = []  # (start, end, units, ok)
    failed = 0
    prof = events = None
    counters0 = counters1 = {}
    setup_s = time.time() - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        with record_function("glyphbench.mark"):
            mark_t = time.perf_counter()
        spans.on = True
        counters0 = drv.counters()
    t_first = time.perf_counter()
    i = 0
    while not requests or time.perf_counter() - t_first < seconds:
        t0 = time.perf_counter()
        try:
            with spans.span("request"):
                units = drv.request(i)
            ok = True
        except Exception as e:  # a failed request is counted, and the run goes on
            _log({"request_failed": i, "error": repr(e)[:500]})
            units, ok = 0, False
            failed += 1
        requests.append((t0, time.perf_counter(), units, ok))
        i += 1
        if prof is not None and i == n_traced:
            events = _stop_profile(prof, spans, device, mark_t)
            counters1, prof = drv.counters(), None
    if prof is not None:
        events = _stop_profile(prof, spans, device, mark_t)
        counters1 = drv.counters()
    t_last = requests[-1][1]

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    drv.release()
    if trace:
        spans.unwrap()

    result = {"correct": None, "attempted": 0, "failed": failed, "metrics": {}, "device": {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }}
    result["attempted"] = len(requests) * drv.attempts_per_request
    if trace:
        traced = requests[:n_traced]
        tr = Trace(events, t_first, traced[-1][1], spans, traced,
                   {k: counters1[k] - counters0[k] for k in counters1})
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        reported = set(drv.END_TO_END)
        for rd in defs.readers():
            if rd.MOVES not in reported:
                continue
            value = rd.read(tr, drv)
            if value is not None:
                result["metrics"][rd.NAME] = {"value": value, "unit": rd.UNIT}
        result["breakdown"] = breakdown(tr)
    else:
        for k, (v, unit) in drv.end_to_end(requests, t_first, t_last).items():
            result["metrics"][k] = {"value": v, "unit": unit}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}

    _log({"requests": len(requests), "window_s": t_last - t_first, "failed": failed,
          "bytes_written": drv.bytes_written(),
          "request_s": [round(b - a, 4) for a, b, _, _ in requests[:400]]})
    checks = drv.check(requests)
    ok = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = bool(ok)
    result["checks"] = checks
    return result
