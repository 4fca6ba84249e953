"""The harness on the CPU: the definitions keep to the contract, a cell
defined only in a temporary directory runs end to end with its result's
keys, planted faults and the lower-precision controls come out as not
correct, the trace arithmetic on hand-made intervals, the import guard,
and no run without a card."""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import tiny
from glyphbench import deploy, harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
pytestmark = pytest.mark.usefixtures("program_on_the_cpu")


@pytest.fixture(scope="module")
def defs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("defs"))
    tiny.make(root)
    return harness.Definitions(root)


def run(defs, cell, trace=False, seed=20260, seconds=0.5, tmp=None):
    work = tempfile.mkdtemp(dir=tmp)
    return harness.run_cell(defs, cell, seed, seconds, trace, torch.device("cpu"), time.time(), {},
                            work)


# -- the definitions -----------------------------------------------------------


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "glyphbench/run.py"] and b["paths"] == ["glyphbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"glyphbench/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = harness.Definitions().cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], 1)
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_every_reader_is_listed_as_it_declares_itself():
    b = _bench()
    listed = {m["name"]: m for m in b["per_layer"]}
    d = harness.Definitions()
    readers = {r.NAME: r for r in d.readers()}
    assert set(readers) == set(listed)
    e2e = {m["name"] for m in b["end_to_end"]}
    for name, r in readers.items():
        m = listed[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            r.UNIT, r.BETTER, r.SOURCE, r.LAYER, r.MOVES)
        assert r.MOVES in e2e and 1 <= len(r.LAYER) <= 200
        assert os.path.basename(r.__file__) == f"{name}.py"
        # Each cell the metric lists reports the end-to-end metric it moves.
        for cell in m["workloads"]:
            assert r.MOVES in d.driver(d.cell(cell)["traffic"]).Driver.END_TO_END


def test_configs_and_workloads_load():
    d = harness.Definitions()
    for path in os.listdir(os.path.join(BENCH, "workloads")):
        cell = d.cell(path[:-5])
        d.config(cell["config"])
        d.driver(cell["traffic"])
        assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())


def test_a_cell_defined_only_in_a_temporary_directory_runs(tmp_path):
    kinds = tiny.make(str(tmp_path))
    d = harness.Definitions(str(tmp_path))
    for cell in kinds:
        res = run(d, cell, tmp=str(tmp_path))
        assert set(res) == RESULT_KEYS, cell
        assert res["correct"] is True, (cell, res["checks"])
        assert res["failed"] == 0 and res["attempted"] > 0
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
        assert list(res)[-1] == "checks"
        for c in res["checks"].values():
            assert set(c) == {"value", "limit"}


def test_a_configuration_of_two_font_kinds_needs_only_new_files(tmp_path):
    """Fonts of two generators in one configuration, each rendered to a
    fontstack of its own and every request's output compared."""
    tiny.make(str(tmp_path))
    text = json.loads((tmp_path / "configs" / "tiny_text.json").read_text())
    cjk = json.loads((tmp_path / "configs" / "tiny_cjk.json").read_text())
    text["fonts"][0]["styles"] = text["fonts"][0]["styles"][:1]
    text["fonts"] += cjk["fonts"]
    (tmp_path / "configs" / "tiny_mixed.json").write_text(json.dumps(text))
    w = json.loads((tmp_path / "workloads" / "tiny_fira_recurse_tar.json").read_text())
    w["config"] = "tiny_mixed"
    (tmp_path / "workloads" / "tiny_mixed_recurse_tar.json").write_text(json.dumps(w))
    res = run(harness.Definitions(str(tmp_path)), "tiny_mixed_recurse_tar", seconds=1.0,
              tmp=str(tmp_path))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 1 and res["checks"]["distinct_outputs"]["value"] == 1
    fonts = deploy.fonts(text, 3)
    assert [f.generator for f in fonts] == ["text_ttf", "cid_cff_otf"]
    assert fonts[1].filename.startswith("01-")


def test_a_traced_run_reports_its_window(defs, tmp_path):
    res = run(defs, "tiny_fira_recurse_tar", trace=True, tmp=str(tmp_path))
    assert set(res) == RESULT_KEYS | {"breakdown"} and res["correct"] is True
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # Host spans and counters are read on the CPU; device numbers are not.
    host = {"prep_ms_per_kglyph", "session_add_ms_per_kglyph", "wire_bytes_per_glyph"}
    assert host <= set(res["metrics"])
    assert "device_idle_pct.render" not in res["metrics"]


# -- faults and controls --------------------------------------------------------


def _drop_half(orig):
    def enc(name, rng, preps, bm_iter):
        h = len(preps) // 2
        data = orig(name, rng, preps[:h], bm_iter)
        for p in preps[h:]:
            if not p.empty:
                next(bm_iter)
        return data
    return enc


def _alter(orig):
    def enc(name, rng, preps, bm_iter):
        def it():
            for i, b in enumerate(bm_iter):
                if i == 0:
                    b = np.array(b, copy=True)
                    b[0] ^= 0x80
                yield b
        return orig(name, rng, preps, it())
    return enc


@pytest.mark.parametrize("fault", ["drop_half", "alter_bitmap"])
@pytest.mark.parametrize("cell", ["tiny_fira_recurse_tar", "tiny_cjk_merge_dir"])
def test_render_faults_are_not_correct(defs, monkeypatch, tmp_path, cell, fault):
    from versatiles_glyphs_tpu_torch.proto import native

    wrap = {"drop_half": _drop_half, "alter_bitmap": _alter}[fault]
    monkeypatch.setattr(native, "encode_block_from_preps", wrap(native.encode_block_from_preps))
    res = run(defs, cell, tmp=str(tmp_path))
    assert res["correct"] is False
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert bad == ({"glyph_mismatches"} if fault == "drop_half" else {"max_abs_byte_diff"})


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "call_takes_one_step"])
def test_fit_faults_are_not_correct(defs, monkeypatch, tmp_path, fault):
    from versatiles_glyphs_tpu_torch.models import fitting

    if fault == "unchanged_state":
        def still(self, params, opt, dev_batch, k):
            loss = float(self.loss(params, dev_batch))
            return params, opt, np.full(k, loss, np.float32)

        monkeypatch.setattr(fitting.FontFitter, "step_many", still)
    elif fault == "half_batch":
        orig = fitting._flat_losses
        monkeypatch.setattr(fitting, "_flat_losses",
                            lambda p, b, d, tp: orig(p, b, d, tp)[: p["curves"].shape[0] // 2])
    else:
        # A call of k steps that takes one: sound where k is 1 alone.
        orig = fitting.FontFitter.step_many

        def one(self, params, opt, dev_batch, k):
            params, opt, losses = orig(self, params, opt, dev_batch, 1)
            return params, opt, np.repeat(losses, k)

        monkeypatch.setattr(fitting.FontFitter, "step_many", one)
    res = run(defs, "tiny_fira_fit_flat", tmp=str(tmp_path))
    assert res["correct"] is False
    if fault == "call_takes_one_step":
        bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
        assert "delta_norm_gap" in bad and not bad & {"loss0_gap", "grad1_norm_gap"}


def test_render_control_in_bfloat16_fails_the_limits(defs, tmp_path):
    for cell in ("tiny_fira_recurse_tar", "tiny_cjk_merge_dir"):
        c = defs.cell(cell)
        exp = deploy.Expected(deploy.fonts(defs.config(c["config"]), 7))
        ref, _ = exp.render("cpu")
        low, _ = exp.render("cpu", dtype=torch.bfloat16)
        d = np.abs(low.astype(np.int16) - ref.astype(np.int16))
        lim = harness.Definitions().cell(cell[5:])["limits"]
        pct = 100 * np.count_nonzero(d) / d.size
        assert d.max() > lim["max_abs_byte_diff"] or pct > lim["pct_pixels_off"]


def test_fit_control_in_tf32_fails_the_limits():
    from glyphbench.reference import fit as rf

    cell = harness.Definitions().cell("fira_fit_flat")
    steps = 1 + cell["params"]["steps_per_call"]
    b = rf.build_batch(5, 6, 12, 8, "cpu")
    ref = rf.run_steps(b, steps, 3, 0.01, "cpu")
    low = rf.run_steps(b, steps, 3, 0.01, "cpu", control=True)
    got = rf.readings({"losses": low["losses"], "grad1": low["grad1"],
                       "delta": {k: low["params"][k] - low["params0"][k] for k in rf.LEAVES}}, ref)
    lim = cell["limits"]
    assert any(got[k] > lim[k] for k in lim)


# -- arithmetic on hand-made traces ----------------------------------------------


def test_union_and_idle_gaps_by_hand():
    assert harness.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert harness.clip([(0, 2), (5, 9)], 1, 6) == [(1, 2), (5, 6)]
    spans = [("request", 1, 0.0, 10.0), ("encode", 1, 2.0, 4.0), ("prep_block", 2, 0.0, 10.0)]
    gaps = harness.idle_gaps([(0.0, 1.0), (3.0, 5.0)], 0.0, 10.0, spans, main=1)
    assert gaps == {"request": 6.0, "encode": 1.0}
    assert harness.idle_gaps([(0.0, 1.0)], 0.0, 2.0, [], main=1) == {"between requests": 1.0}


class _Drv:
    glyphs_per_request = 1000

    def work_per_request(self):
        return {"f32_ops": 67e12 * 0.001, "bytes": 1.0}

    def work_per_step(self):
        return {"f32_ops": 1.0, "bytes": 3.35e12 * 0.0001}


def _trace(events, t0, t1, requests):
    return harness.Trace(events, t0, t1, harness.Spans(), requests)


def test_readers_on_hand_made_traces():
    d = harness.Definitions()
    readers = {r.NAME: r for r in d.readers()}
    events = [("kernel_a", 0.0, 0.002), ("Memcpy HtoD (Pageable -> Device)", 0.002, 0.003),
              ("kernel_b", 0.5, 0.502), ("kernel_c", 5.0, 6.0)]
    tr = _trace(events, 0.0, 1.0, [(0.0, 1.0, 2000, True)])
    assert tr.kernel_s() == pytest.approx(0.004) and tr.busy_s == pytest.approx(0.005)
    assert readers["device_idle_pct.render"].read(tr, _Drv()) == pytest.approx(99.5)
    # 2 requests of 1 ms of bound work each over 4 ms of kernels.
    assert readers["render_roofline_pct"].read(tr, _Drv()) == pytest.approx(50.0)
    steps = _trace(events, 0.0, 1.0, [(0.0, 1.0, 10, True)])
    assert readers["fit_roofline_pct"].read(steps, _Drv()) == pytest.approx(25.0)
    assert readers["fit_events_per_step"].read(steps, _Drv()) == pytest.approx(0.3)
    assert readers["device_idle_pct.fit"].read(_trace([], 0.0, 1.0, []), _Drv()) is None


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["versatiles_glyphs_tpu_torch.cli", "numpy", "torch"]) == []
    assert harness.forbidden_modules(["versatiles_glyphs_tpu.cli"]) == ["versatiles_glyphs_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


# -- no card ---------------------------------------------------------------------


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "glyphbench/run.py", "--workload", "fira_recurse_tar",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_py_refuses_without_a_card():
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_py_needs_the_program(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "glyphbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run_py(str(tmp_path), {"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "glyphbench/run.py", "--workload", "cjk_merge_dir",
                        "--seed", "77", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ["tiny_cjk_merge_dir", "tiny_fira_fit_flat"])
def test_calibration_reads_sound_control_and_faults(defs, capsys, cell):
    from glyphbench import calibrate

    assert calibrate.main(["--workload", cell, "--seeds", "31", "--control", "1", "--faults", "1",
                           "--defs", defs.root, "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    limits = defs.cell(cell)["limits"]
    for r in rows:
        fails = any(r[k] > limits[k] for k in limits if k in r)
        assert fails == (r["kind"] != "sound"), r


def test_counters_cover_the_traced_requests_alone(tmp_path):
    tiny.make(str(tmp_path))
    path = tmp_path / "workloads" / "tiny_cjk_merge_dir.json"
    w = json.loads(path.read_text())
    got = []
    for n in (1, None):
        w["trace_requests"] = n
        path.write_text(json.dumps(w))
        res = run(harness.Definitions(str(tmp_path)), "tiny_cjk_merge_dir", trace=True, seconds=4.0,
                  tmp=str(tmp_path))
        assert res["attempted"] > 1
        got.append(res["metrics"]["wire_bytes_per_glyph"]["value"])
    assert got[0] == got[1]
