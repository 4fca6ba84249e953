"""`tools.profile` (the port of the JAX package's ``scripts/profile_tpu.py``,
``scripts/e2e_probe.py`` and ``scripts/e2e_cpuprof.py``) and `tools.check`
(its lint and compile check), on the CPU.

The profile's numbers come only from the card, where `chip_smoke.py`
runs it; here its arithmetic runs on synthetic inputs (the union of
device intervals, a profiled run's record, the stage timer, the top
frames of a cProfile run) and its render and manager paths on the
``torch`` backend with a tiny synthesized font, and it must raise without
a card. The lint finds nothing in the port.
"""

import cProfile
import time

import pytest
import torch

from versatiles_glyphs_tpu_torch.ops import sdf_cuda
from versatiles_glyphs_tpu_torch.tools import check, profile, roofline, session_turns


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(roofline.FONTS, "tiny", (20, 65, 3, 8))
    return "tiny"


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)], 4.0),  # overlap, gap
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 12.0)], 12.0),  # nested, out of order
    ([(3.0, 4.0), (0.0, 1.0), (1.0, 2.0)], 3.0),  # touching
])
def test_union_of_device_intervals(spans, want):
    assert session_turns.union_us(spans) == want


def test_steps_record_from_device_events():
    """Busy share = the union over the wall; event time and counts a
    step by name; None for the device numbers where no event was seen."""
    events = [("k2", 0.0, 40.0), ("k3", 30.0, 50.0), ("adam", 100.0, 110.0),
              ("k2", 200.0, 240.0), ("k3", 240.0, 260.0), ("adam", 300.0, 310.0)]
    rec = profile.steps_record(events, steps=2, seconds=400e-6)
    assert rec["device_busy_ms_a_step"] == pytest.approx(0.13 / 2)
    assert rec["device_busy_share"] == pytest.approx(130 / 400)
    assert rec["device_event_ms_a_step"] == pytest.approx(0.14 / 2)
    assert rec["profiled_wall_ms_a_step"] == pytest.approx(0.2)
    assert rec["device_events_a_step"] == 3.0
    assert rec["device_events_a_step_by_name"] == {"adam": 1.0, "k2": 1.0, "k3": 1.0}
    long = "void at::native::(anonymous namespace)::fill<at::native::FillFunctor<float>>(int)"
    assert profile.short_name(long) == "fill<FillFunctor<float>>(int)"
    assert len(profile.short_name("k" * 500)) == 120
    empty = profile.steps_record([], steps=10, seconds=0.01)
    assert empty["device_busy_share"] is None and empty["device_busy_ms_a_step"] is None
    assert empty["device_events_a_step"] == 0.0


def test_stage_timer_records():
    """Stages in their first order, the warm-up run left out, host times
    measured, no device times without a card."""
    timer = profile.StageTimer(cuda=False)
    for i in range(4):
        with timer("pack"):
            time.sleep(0.002 if i else 0.05)
        with timer("fetch"):
            pass
    recs = timer.records()
    assert [r["stage"] for r in recs] == ["pack", "fetch"]
    assert all(r["runs"] == 3 and len(r["host_ms"]) == 3 for r in recs)
    assert 2.0 <= recs[0]["host_ms_median"] < 50.0
    assert recs[1]["host_ms_median"] < recs[0]["host_ms_median"]
    assert all(r["device_ms_median"] is None for r in recs)


def _busy(n):
    total = 0
    for i in range(n):
        total += i * i
    return total


def test_top_frames_of_a_profile():
    """The frame with the most own time first, at most the asked count,
    each with its calls and own and cumulative seconds."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        _busy(20000)
    prof.disable()
    frames = profile.top_frames(prof, 3)
    assert len(frames) <= 3
    assert any("_busy" in f["function"] for f in frames)
    busy = next(f for f in frames if "_busy" in f["function"])
    assert busy["calls"] == 20 and 0 < busy["own_s"] <= busy["cumulative_s"]
    assert [f["own_s"] for f in frames] == sorted((f["own_s"] for f in frames), reverse=True)
    assert "test_torch_profile.py" in busy["function"]


def test_render_stages_on_the_cpu(tiny):
    """The main path's stages, one at a time, on the CPU: five stages,
    and the staged bitmaps equal the session's (else it raises)."""
    recs = profile.render_stages(roofline.font_preps(tiny), torch.device("cpu"), 2)
    assert [r["stage"] for r in recs] == ["pack", "upload", "decode_and_tile_table",
                                          "kernel", "fetch"]
    assert all(r["runs"] == 2 and r["device_ms_median"] is None for r in recs)


def test_e2e_and_cpuprof_on_the_cpu(tiny):
    """The manager over two copies of the font against the device-only
    render, on the ``torch`` backend: one pair, its ratio, the per-glyph
    prep said; cProfile's frames of the manager's run."""
    rec = profile.e2e(tiny, 2, 1, "torch")
    assert rec["glyphs_a_font"] == rec["preps_a_font"] == 20
    assert len(rec["paired_ratio"]) == 1 and rec["paired_ratio"][0] > 0
    assert "prep_cores" in rec["prep"]
    prof = profile.cpuprof(tiny, 2, "torch")
    assert prof["wall_s_a_font"] > 0 and prof["cpu_s_a_font"] > 0
    assert 0 < len(prof["top_frames"]) <= profile.TOP_FRAMES


def test_profile_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf_cuda.reset_launches()
    for what in ([], ["fit", "--quick"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile.main(what)
    assert capsys.readouterr().out == ""
    assert not any(sdf_cuda.LAUNCHES.values())


def test_port_lint_is_clean():
    """`tools.check`'s lint (its copy of ``scripts/lint.py``) finds
    nothing in the port's files, and finds what it checks for."""
    files = check.targets()
    assert len(files) > 60 and any(f.endswith("chip_smoke.py") for f in files)
    assert check.lint(files) == []
    assert check.byte_compile(files) == []


def test_lint_findings(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport sys  # noqa\n\n\ndef f():\n    pass\n\n\ndef f():\n"
                   "    pass\n")
    got = check.check_file(str(bad))
    assert len(got) == 2
    assert "unused import 'os'" in got[0] and "duplicate definition of 'f'" in got[1]
    (tmp_path / "syntax.py").write_text("def (:\n")
    assert "syntax error" in check.check_file(str(tmp_path / "syntax.py"))[0]
