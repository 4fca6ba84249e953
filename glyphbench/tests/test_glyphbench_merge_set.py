"""The cell ``noto_regular_set_merge`` on the CPU: its configuration's
claims as configured, a tiny copy of the set (a Latin base, two script
fonts sharing a block and the five shared codepoints, tiny "Noto Sans
JP", "KR" and "SC" CID OTFs, KR's ideographs shadowed by JP's) through
``merge_set_dir`` and its readers, correct; the
claims reversed in the program, not correct; the calibration's control
and faults, not correct; and each new reader on hand-made records."""

import json
import os
import shutil
import tempfile
import time

import pytest
import torch

from glyphbench import deploy, harness
from glyphbench.reference.merge import Claims
from versatiles_glyphs_tpu_torch.utils import trace as program

pytestmark = pytest.mark.usefixtures("program_on_the_cpu")
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "tiny_noto_regular_set_merge"
NEW = {"claim_ms_per_kglyph", "prep_file_ms_per_kglyph", "prep_overlap"}
SHARED = [[32, 32], [160, 160], [8204, 8205], [9676, 9676]]
MAIN, POOL = 1, 2


def tiny_set(config: dict) -> dict:
    """The configuration cut to six fonts of a few dozen glyphs, in the
    set's order: the base, Bengali and Devanagari (block 0x0900 mixed),
    JP (kana, ideographs), KR (the same ideographs, hangul), SC."""
    by_family = {f["family"]: f for f in config["fonts"]}
    cuts = (("Noto Sans", [[32, 60], [160, 165], [8204, 8205], [9676, 9676]], 38),
            ("Noto Sans Bengali", sorted(SHARED + [[2432, 2460]]), 34),
            ("Noto Sans Devanagari", sorted(SHARED + [[2304, 2330]]), 32),
            ("Noto Sans JP", [[0x3041, 0x3048], [0x4E00, 0x4E07]], 16),
            ("Noto Sans KR", [[0x4E00, 0x4E07], [0xAC00, 0xAC07]], 16),
            ("Noto Sans SC", [[13312, 13327]], 16))
    out = dict(config)
    out["fonts"] = [dict(by_family[fam], codepoint_ranges=r, glyphs=n) for fam, r, n in cuts]
    return out


@pytest.fixture(scope="module")
def defs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("defs"))
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(root, d))
    for d in ("traffic", "layers"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, d))
    real = harness.Definitions()
    with open(os.path.join(root, "configs", "tiny_noto_set.json"), "w") as f:
        json.dump(tiny_set(real.config("noto_sans_regular_set")), f)
    w = real.cell("noto_regular_set_merge")
    del w["name"]
    w["config"] = "tiny_noto_set"
    with open(os.path.join(root, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(w, f)
    return harness.Definitions(root)


def run(defs, trace=False, seconds=0.5, seed=20260):
    work = tempfile.mkdtemp()
    try:
        return harness.run_cell(defs, CELL, seed, seconds, trace, torch.device("cpu"), time.time(),
                                {}, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def test_the_configured_set_claims_as_its_records_say():
    config = harness.Definitions().config("noto_sans_regular_set")
    fonts = deploy.fonts(config, 2**31 + 11)
    assert len(fonts) == 23 and {f.fontstack for f in fonts} == {"noto_sans_regular"}
    # The set's files as the name parser's published table lists them, in
    # order: the run of Regular rows from NotoSans-Regular on.
    table = os.path.join(os.path.dirname(BENCH), "tests", "data", "font_name_cases.txt")
    with open(table) as f:
        rows = [line.split(";") for line in f if line.strip() and not line.startswith("#")]
    first = [r[1] for r in rows].index("NotoSans-Regular")
    published = []
    for r in rows[first:]:
        if not (r[1].startswith("NotoSans") and r[1].endswith("-Regular")):
            break
        published.append(r[0])
    assert [f.family for f in fonts] == published
    assert [f.generator for f in fonts].count("cid_cff_otf_ranges") == 2
    assert [f.generator for f in fonts].count("cid_cff_otf") == 1
    c = Claims([f.fontstack for f in fonts], [f.codepoints for f in fonts])
    assert c.stats() == {"files": 23, "fontstacks": 1, "blocks": 202, "mixed_blocks": 12,
                         "claimed": 46574, "shadowed": 42079}
    owned = dict(zip((f.family for f in fonts), (len(ks) for ks in c.owned)))
    assert owned["Noto Sans"] == 3094 and len(fonts[0].codepoints) == 3094
    # JP claims its kana and every ideograph of URO, KR its hangul and jamo, SC Ext A.
    assert (owned["Noto Sans JP"], owned["Noto Sans KR"], owned["Noto Sans SC"]) == (
        21184, 11536, 6592)
    # The shared codepoints are the base's in every script font.
    for cp in (0x20, 0xA0, 0x200C, 0x200D, 0x25CC):
        assert c.owner["noto_sans_regular"][cp][0] == 0
    assert len(c.paths()) == 202 + 2


def test_the_tiny_set_merges_correct(defs):
    res = run(defs)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # The warm-up's output and every timed request's, alike.
    assert res["checks"]["distinct_outputs"]["value"] == 1
    assert set(res["metrics"]) == {"glyphs_per_s", "setup_s"}


def test_a_traced_run_reads_every_new_metric(defs):
    res = run(defs, trace=True)
    assert res["correct"] is True, res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert NEW <= set(m)
    assert m["prep_overlap"] >= 1.0
    assert m["claim_ms_per_kglyph"] > 0 and m["prep_file_ms_per_kglyph"] > 0
    # The render metrics of every render cell are read here too.
    assert {"prep_wait_ms_per_kglyph", "cores_ms_per_kglyph", "wire_bytes_per_glyph"} <= set(m)


def test_claims_reversed_are_not_correct(defs, monkeypatch):
    """A later file's glyph written where the first file claims."""
    from versatiles_glyphs_tpu_torch.font import block

    def last_wins(self, char_index, font):
        self.glyphs[char_index] = font

    monkeypatch.setattr(block.GlyphBlock, "set_glyph_font", last_wins)
    res = run(defs)
    assert res["correct"] is False
    bad = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert "glyph_mismatches" in bad


def test_calibration_reads_sound_control_and_faults(defs, capsys):
    from glyphbench import calibrate

    assert calibrate.main(["--workload", CELL, "--seeds", "31", "--control", "1", "--faults", "1",
                           "--defs", defs.root, "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["kind"] for r in rows] == ["sound", "control", "fault_drop_half", "fault_alter_bitmap"]
    limits = defs.cell(CELL)["limits"]
    for r in rows:
        fails = any(r[k] > limits[k] for k in limits if k in r)
        assert fails == (r["kind"] != "sound"), r


# -- the readers on hand-made records ----------------------------------------------


def _rec(name, id, parent, thread, start, end):
    return program.Record(name, id, parent, 1, thread, start, end)


def _trace(units, counters):
    spans = harness.Spans()
    spans.main = MAIN
    return harness.Trace([], 0.0, 10.0, spans, [(0.0, 10.0, units, True)], counters)


def test_new_readers_on_hand_made_records(monkeypatch):
    readers = {r.NAME: r for r in harness.Definitions().readers()}
    recs = [_rec("cli.request", 1, None, MAIN, 0.0, 9.0),
            _rec("font.claim", 2, 1, MAIN, 0.0, 0.25),
            _rec("font.claim", 3, 1, POOL, 0.0, 5.0),  # not the main thread's: left out
            _rec("manager.prep_file", 4, 1, POOL, 1.0, 3.0),
            _rec("manager.prep_file", 5, 1, POOL + 1, 2.0, 4.0),
            _rec("manager.prep_file", 6, 1, POOL, 3.0, 3.5),
            _rec("manager.prep_file", 7, 1, POOL, 5.0, 5.5),
            _rec("manager.prep_file", 8, None, POOL, 11.0, 12.0)]  # past the window
    monkeypatch.setattr(program, "records", lambda: list(recs))
    tr = _trace(2000, {})
    got = {n: readers[n].read(tr, None) for n in NEW}
    # 5 s of file prep over the 3.5 s in which any ran.
    assert got == pytest.approx({"claim_ms_per_kglyph": 125.0, "prep_file_ms_per_kglyph": 2500.0,
                                 "prep_overlap": 5.0 / 3.5})
    # One file prepped at a time reads 1.
    monkeypatch.setattr(program, "records", lambda: [recs[0], recs[3], recs[6]])
    assert readers["prep_overlap"].read(tr, None) == pytest.approx(1.0)
    # A program without the spans (the parent of the plan a file): nothing.
    monkeypatch.setattr(program, "records", lambda: [])
    assert {n: readers[n].read(tr, None) for n in NEW} == dict.fromkeys(NEW)
