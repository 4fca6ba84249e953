"""The readers of the program's own spans and counters on the CPU: on
hand-made records (the window, the main thread, self time less the
child spans, nothing where a span is absent), on counters, and in
traced runs of the tiny cells."""

import sys
import tempfile
import time

import pytest
import torch

import tiny
from glyphbench import harness
from versatiles_glyphs_tpu_torch import utils
from versatiles_glyphs_tpu_torch.utils import trace as program

pytestmark = pytest.mark.usefixtures("program_on_the_cpu")
MAIN, POOL = 1, 2

RENDER = {"font_read_ms_per_kglyph", "outline_ms_per_kglyph", "cores_ms_per_kglyph",
          "prep_wait_ms_per_kglyph", "pack_ms_per_kglyph", "fetch_wait_ms_per_kglyph",
          "encode_ms_per_kglyph", "write_ms_per_kglyph", "tile_fill_pct", "tiles_per_glyph"}
COUNTED = {"tile_fill_pct", "tiles_per_glyph"}
FIT = {"fit_replay_us_per_step", "fit_adam_us_per_step", "fit_loss_wait_us_per_step"}


@pytest.fixture(scope="module")
def readers():
    return {r.NAME: r for r in harness.Definitions().readers()}


def _rec(name, id, parent, thread, start, end):
    return program.Record(name, id, parent, 1, thread, start, end)


def _trace(units, counters=None, t0=0.0, t1=10.0):
    spans = harness.Spans()
    spans.main = MAIN
    return harness.Trace([], t0, t1, spans, [(t0, t1, units, True)], counters)


def _records(monkeypatch, recs):
    monkeypatch.setattr(program, "records", lambda: list(recs))


def test_render_readers_on_hand_made_records(monkeypatch, readers):
    _records(monkeypatch, [
        _rec("cli.request", 1, None, MAIN, 0.0, 9.0),
        _rec("font.read", 2, 1, MAIN, 0.0, 0.5),
        _rec("writer.clear", 3, 1, MAIN, 0.5, 0.7),
        _rec("manager.prep_font", 4, 1, POOL, 0.7, 3.0),
        _rec("font.outlines", 5, 4, POOL, 0.7, 1.7),
        _rec("font.build_cores", 6, 4, POOL, 1.7, 2.9),
        _rec("manager.prep_wait", 7, 1, MAIN, 0.7, 3.0),
        _rec("session.add", 8, 1, MAIN, 3.0, 4.0),
        _rec("session.pack", 9, 8, MAIN, 3.0, 3.6),
        _rec("proto.encode", 10, 1, MAIN, 4.0, 6.0),
        _rec("session.pack", 11, 10, MAIN, 4.0, 4.25),
        _rec("session.fetch_wait", 12, 10, MAIN, 4.5, 5.0),
        _rec("session.fetch_wait", 13, 10, MAIN, 4.9, 5.25),
        _rec("writer.write", 14, 1, MAIN, 6.0, 6.5),
        # Outside the window: left out.
        _rec("writer.write", 15, None, MAIN, 10.5, 11.0),
        _rec("font.read", 16, None, MAIN, -2.0, -1.0),
    ])
    tr = _trace(2000)
    got = {n: readers[n].read(tr, None) for n in RENDER - COUNTED}
    assert got == pytest.approx({
        "font_read_ms_per_kglyph": 250.0, "outline_ms_per_kglyph": 500.0,
        "cores_ms_per_kglyph": 600.0, "prep_wait_ms_per_kglyph": 1150.0,
        "pack_ms_per_kglyph": 425.0, "fetch_wait_ms_per_kglyph": 425.0,
        # 2 s less the union of 0.25 s of pack and 0.75 s of overlapping waits.
        "encode_ms_per_kglyph": 500.0, "write_ms_per_kglyph": 350.0,
    })


def test_main_thread_waits_count_the_main_thread_alone(monkeypatch, readers):
    _records(monkeypatch, [_rec("manager.prep_wait", 1, None, POOL, 0.0, 1.0),
                           _rec("session.fetch_wait", 2, None, POOL, 0.0, 1.0)])
    tr = _trace(1000)
    assert readers["prep_wait_ms_per_kglyph"].read(tr, None) is None
    assert readers["fetch_wait_ms_per_kglyph"].read(tr, None) is None


def test_fit_readers_on_hand_made_records(monkeypatch, readers):
    recs = [_rec("fit.step_many", 1, None, MAIN, 0.0, 0.005)]
    for i in range(10):
        t = i * 4e-4
        recs += [_rec("fit.replay", 2 + 2 * i, 1, MAIN, t, t + 2e-4),
                 _rec("fit.adam", 3 + 2 * i, 1, MAIN, t + 2e-4, t + 3e-4)]
    recs.append(_rec("fit.loss_fetch", 30, 1, MAIN, 0.004, 0.0045))
    _records(monkeypatch, recs)
    tr = _trace(10, t1=0.01)
    assert readers["fit_replay_us_per_step"].read(tr, None) == pytest.approx(200.0)
    assert readers["fit_adam_us_per_step"].read(tr, None) == pytest.approx(100.0)
    assert readers["fit_loss_wait_us_per_step"].read(tr, None) == pytest.approx(50.0)


def test_readers_read_nothing_where_the_spans_are_absent(monkeypatch, readers):
    _records(monkeypatch, [_rec("cli.request", 1, None, MAIN, 0.0, 1.0)])
    tr = _trace(1000)
    for name in RENDER | FIT:
        assert readers[name].read(tr, None) is None, name
    # A program without the span module, as the parent of this reader has.
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "versatiles_glyphs_tpu_torch.utils.trace", None)
    for name in RENDER | FIT:
        assert readers[name].read(tr, None) is None, name


def test_tile_fill_from_the_counters(readers):
    rd = readers["tile_fill_pct"]
    assert rd.read(_trace(10, {"tiles": 40, "pixels": 2560}), None) == pytest.approx(25.0)
    # Counters of a program that does not count tiles.
    assert rd.read(_trace(10, {"upload_bytes": 5, "fetch_bytes": 7}), None) is None


def test_tiles_per_glyph_from_the_counters(readers):
    rd = readers["tiles_per_glyph"]
    assert rd.read(_trace(10, {"glyphs": 16, "tiles": 40}), None) == pytest.approx(2.5)
    # Counters of a program that does not count glyphs.
    assert rd.read(_trace(10, {"upload_bytes": 5, "fetch_bytes": 7}), None) is None


def _run(defs, cell, tmp):
    work = tempfile.mkdtemp(dir=tmp)
    return harness.run_cell(defs, cell, 20260, 0.5, True, torch.device("cpu"), time.time(), {},
                            work)


def test_traced_runs_report_the_program_span_metrics(tmp_path):
    tiny.make(str(tmp_path))
    defs = harness.Definitions(str(tmp_path))
    res = _run(defs, "tiny_cjk_merge_dir", str(tmp_path))
    assert res["correct"] is True
    assert RENDER <= set(res["metrics"])
    assert 0 < res["metrics"]["tile_fill_pct"]["value"] <= 100
    assert res["metrics"]["tiles_per_glyph"]["value"] >= 1
    # On the CPU `step_many` loops over `step`: no replay or Adam span.
    res = _run(defs, "tiny_fira_fit_flat", str(tmp_path))
    assert res["correct"] is True
    assert FIT & set(res["metrics"]) == {"fit_loss_wait_us_per_step"}
