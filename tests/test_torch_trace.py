"""The port's spans (`utils.trace`) and the render session's counters, on
the CPU.

A span records only under `torch.profiler` or after `trace.enable()`;
off, it is a shared no-op, and no span reaches `record_function`. Under
the profiler, a merge through `cli.main` records every span of the
render path with one request id on the main thread and the prep pool's,
and the graphed fit steps record a replay and an Adam step a step.
`render.driver.WIRE_STATS` counts the glyphs, tiles and pixels of each
dispatched group. ``--trace FILE`` writes the profiler's Chrome trace
with the spans of every thread in it.
"""

import gc
import io
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from versatiles_glyphs_tpu_torch import cli
from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.render import driver as tdriver
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.utils import trace
from versatiles_glyphs_tpu_torch.utils.synth_font import (
    build_ttf_curved,
    curved_preps,
    synth_fit_batch,
)

# Each span of the render path and the span it hangs under (several
# where the encode's first pull dispatches the session's last groups).
RENDER_PARENTS = {
    "cli.request": {None},
    "font.read": {"cli.request"},
    "writer.clear": {"cli.request"},
    "font.claim": {"cli.request"},
    "manager.prep_file": {"cli.request"},
    "manager.prep_font": {"cli.request"},
    "font.outlines": {"manager.prep_file"},
    "font.build_cores": {"manager.prep_file"},
    "manager.prep_wait": {"cli.request"},
    "session.add": {"cli.request"},
    "session.pack": {"session.add", "proto.encode"},
    "session.upload": {"session.add", "proto.encode"},
    "session.launch": {"session.add", "proto.encode"},
    "session.fetch_wait": {"proto.encode"},
    "proto.encode": {"cli.request"},
    "writer.write": {"cli.request"},
}
POOL_SPANS = {"manager.prep_file", "manager.prep_font", "font.outlines", "font.build_cores"}


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def test_spans_nest_with_parents_and_one_request_id():
    trace.enable()
    with trace.span("root") as root:
        with trace.span("a") as a:
            with trace.span("b"):
                pass
        parent = trace.current()
        t = threading.Thread(target=lambda: trace.span("pool", parent).__enter__().__exit__(
            None, None, None))
        t.start()
        t.join()
    with trace.span("other"):
        pass
    assert trace.current() is None
    recs = {r.name: r for r in trace.records()}
    assert [r.name for r in trace.records()] == ["b", "a", "pool", "root", "other"]
    assert recs["root"].parent is None and recs["root"].request == root.id
    assert recs["a"].parent == root.id and recs["b"].parent == a.id
    assert recs["pool"].parent == root.id and recs["pool"].thread != recs["root"].thread
    assert {recs[n].request for n in ("root", "a", "b", "pool")} == {root.id}
    assert recs["other"].request == recs["other"].id != root.id
    assert recs["root"].start <= recs["a"].start <= recs["b"].start <= recs["b"].end
    assert recs["b"].end <= recs["a"].end <= recs["root"].end


def test_the_ring_is_bounded_and_counts_what_it_drops():
    trace.enable()
    for _ in range(trace.RING + 5):
        with trace.span("x"):
            pass
    recs = trace.records()
    assert len(recs) == trace.RING and trace.dropped == 5
    assert recs[0].id + trace.RING - 1 == recs[-1].id
    trace.clear()
    assert trace.records() == [] and trace.dropped == 0


def test_the_collector_stops_tracking_what_the_ring_holds():
    # A tracked record would make every collection walk the whole ring.
    trace.enable()
    for _ in range(3):
        with trace.span("x"):
            pass
    gc.collect()
    assert not any(gc.is_tracked(r) for r in trace._ring)
    assert all(isinstance(r, trace.Record) for r in trace.records())


def test_off_records_nothing_and_never_reaches_record_function(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("record_function called while not recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = trace.span("x"), trace.span("y")
    assert a is b  # one shared no-op
    with a as handle:
        assert handle is None and trace.current() is None
    font = tmp_path / "font.ttf"
    font.write_bytes(build_ttf_curved(12, 8))
    cli.main(["merge", str(font), "-o", str(tmp_path / "out"), "--renderer", "torch"],
             stdout=io.BytesIO())
    assert trace.records() == []
    # A span that records, after `enable` or under the profiler, does not call it either.
    trace.enable()
    with trace.span("z"):
        pass
    trace.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("w"):
            pass
    assert [r.name for r in trace.records()] == ["z", "w"]


def test_a_merge_under_the_profiler_records_every_render_span(tmp_path):
    font = tmp_path / "font.ttf"
    font.write_bytes(build_ttf_curved(300, 8))
    main = threading.get_ident()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cli.main(["merge", str(font), "-o", str(tmp_path / "out"), "--renderer", "torch"],
                 stdout=io.BytesIO())
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    assert {r.name for r in recs} == set(RENDER_PARENTS)
    assert len({r.request for r in recs}) == 1
    for r in recs:
        parent = by_id[r.parent].name if r.parent is not None else None
        assert parent in RENDER_PARENTS[r.name], (r.name, parent)
        assert (r.thread != main) == (r.name in POOL_SPANS), r.name
        assert r.start <= r.end
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start <= r.start and r.end <= p.end, r.name
    # Two index files and one PBF a block.
    blocks = sum(1 for r in recs if r.name == "proto.encode")
    assert sum(1 for r in recs if r.name == "writer.write") == blocks + 2
    # The spans add no range to the profiler's own timeline: `--trace`
    # places them there from the records.
    assert not set(RENDER_PARENTS) & {e.name for e in prof.events()}


@pytest.mark.parametrize("backend", ["torch", "flat"])
def test_graphed_fit_steps_record_a_replay_and_an_adam_step_a_step(backend):
    fitter = fitting.FontFitter(depth=2, backend=backend, device="cpu")
    params, opt, dev_batch = fitter.init(synth_fit_batch(4, 65, seed=1, depth=2, perturb=0.3))
    trace.enable()
    with trace.span("call"):
        fitter._graphed_steps(params, opt, dev_batch, 3)
    names = [r.name for r in trace.records()]
    assert names == ["fit.replay", "fit.adam"] * 3 + ["call"]
    trace.clear()
    fitter.step_many(params, opt, dev_batch, 2)
    recs = trace.records()
    assert [r.name for r in recs] == ["fit.loss_fetch", "fit.step_many"]
    assert recs[0].parent == recs[1].id


def test_wire_stats_count_glyphs_tiles_and_pixels():
    preps = curved_preps(5, 65, seed=3)
    tdriver.reset_wire_stats()
    with Renderer("torch").start_session(parallel=False) as s:
        s.add(preps)
        list(s.results())
    assert s.groups == 1
    pixels = [p.width * p.height for p in preps]
    assert tdriver.WIRE_STATS["glyphs"] == 5
    assert tdriver.WIRE_STATS["tiles"] == sum(max(1, -(-n // 256)) for n in pixels)
    assert tdriver.WIRE_STATS["pixels"] == sum(pixels)
    tdriver.reset_wire_stats()
    assert set(tdriver.WIRE_STATS.values()) == {0}


def test_the_trace_flag_writes_a_chrome_trace_with_the_spans(tmp_path):
    font = tmp_path / "font.ttf"
    font.write_bytes(build_ttf_curved(40, 8))
    out, traced = tmp_path / "out", tmp_path / "traced"
    cli.main(["merge", str(font), "-o", str(out), "--renderer", "torch"], stdout=io.BytesIO())
    cli.main(["merge", str(font), "-o", str(traced), "--renderer", "torch",
              "--trace", str(tmp_path / "trace.json")], stdout=io.BytesIO())
    # The same output, and nothing written but the trace.
    assert sorted(p.name for p in tmp_path.iterdir()) == ["font.ttf", "out", "trace.json", "traced"]
    for f in out.rglob("*"):
        if f.is_file():
            assert (traced / f.relative_to(out)).read_bytes() == f.read_bytes()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e["name"] in RENDER_PARENTS]
    # Every span the request recorded, once.
    recorded = [r.name for r in trace.records()]
    assert sorted(e["name"] for e in spans) == sorted(recorded)
    assert set(recorded) == set(RENDER_PARENTS)
    by_name = {e["name"]: e for e in spans}
    # The main thread's spans on the marker's row; the pool's on their own.
    mark = next(e for e in events if e.get("name") == "vg.trace.mark")
    for e in spans:
        assert (e["tid"] == mark["tid"]) == (e["name"] not in POOL_SPANS), e["name"]
    # Every span sits inside the request's on the profiler's clock.
    root = by_name["cli.request"]
    assert mark["ts"] <= root["ts"]
    for e in spans:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-3
