"""The port's merge of several font files into one fontstack, on the CPU:
a tiny copy of the Noto Sans Regular set (a Latin TTF, Bengali and
Devanagari TTFs sharing block 0x0900 and the five codepoints the base
claims, and CID-keyed OTFs "Noto Sans JP", "KR" and "SC", KR's ideographs
shadowed by JP's) through `cli.main` merge, held against the benchmark's
plain reference of first-file-claims (`glyphbench/reference/merge.py`)
and its float64 render: one fontstack, the claims, the files and every
glyph's metrics exactly, the bitmaps within the cell
``noto_regular_set_merge``'s limits, the program's blocks
(`FontWrapper.get_blocks`) counted as the reference counts them. The prep plan (`font.manager._PrepPlan`): one pool
future a file that claims a glyph, the tree byte-equal to one prep
thread's, and a file that fails fails the merge without a hang."""

import concurrent.futures
import io
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from glyphbench import deploy, harness  # noqa: E402
from glyphbench.reference import decode  # noqa: E402
from glyphbench.reference.merge import Claims  # noqa: E402
from versatiles_glyphs_tpu_torch import cli  # noqa: E402
from versatiles_glyphs_tpu_torch.font import entry as tentry  # noqa: E402
from versatiles_glyphs_tpu_torch.font.manager import FontManager  # noqa: E402

SHARED = [[32, 32], [160, 160], [8204, 8205], [9676, 9676]]
SEED = 2**31 + 19


JP = ("Noto Sans JP", [[0x3041, 0x3048], [0x4E00, 0x4E07]], 16)


def _set(extra=()):
    """The cell's configuration cut to a few dozen glyphs a font, in the
    set's order; ``extra``: (family, ranges, glyphs) of further fonts."""
    config = harness.Definitions().config("noto_sans_regular_set")
    by_family = {f["family"]: f for f in config["fonts"]}
    cuts = (("Noto Sans", [[32, 60], [160, 165], [8204, 8205], [9676, 9676]], 38),
            ("Noto Sans Bengali", sorted(SHARED + [[2432, 2460]]), 34),
            ("Noto Sans Devanagari", sorted(SHARED + [[2304, 2330]]), 32),
            JP, ("Noto Sans KR", [[0x4E00, 0x4E07], [0xAC00, 0xAC07]], 16),
            ("Noto Sans SC", [[13312, 13327]], 16), *extra)
    fonts = []
    for fam, ranges, n in cuts:
        spec = dict(by_family[fam], codepoint_ranges=ranges, glyphs=n)
        fonts += deploy.generator(spec["generator"]).fonts(spec, len(fonts), SEED)
    return fonts


def _claim_counts(manager) -> dict:
    """What the program's claim walk made of its fontstacks, counted as
    `Claims.stats` counts: the files, fontstacks and blocks, the blocks
    drawing from several files, the codepoints claimed and shadowed."""
    wrappers = list(manager.fonts.values())
    blocks = [b for w in wrappers for b in w.get_blocks()]
    claimed = sum(len(b) for b in blocks)
    return {"files": sum(len(w.files) for w in wrappers), "fontstacks": len(wrappers),
            "blocks": len(blocks), "mixed_blocks": sum(1 for b in blocks if len(b.files()) > 1),
            "claimed": claimed,
            "shadowed": sum(len(f.metadata.codepoints) for w in wrappers for f in w.files) - claimed}


@pytest.fixture(scope="module")
def fonts_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fonts")
    fonts = _set((JP,))  # JP again, last: every glyph shadowed
    deploy.write(fonts, str(d))
    return d, fonts


def _merge(paths, out):
    cli.main(["merge", *map(str, paths), "-o", str(out), "--renderer", "torch"],
             stdout=io.BytesIO())
    return decode.read_tree(str(out))


def _paths(fonts_dir, n=None):
    d, fonts = fonts_dir
    return [d / f.filename for f in fonts[:n]], fonts[:n]


@pytest.fixture
def submits(monkeypatch):
    """The pool's submissions of each merge, counted (the manager takes
    `ThreadPoolExecutor` from `concurrent.futures` when it runs)."""
    seen = []
    orig = concurrent.futures.ThreadPoolExecutor

    class Counting(orig):
        def submit(self, fn, *a, **k):
            seen.append(getattr(fn, "__name__", fn))
            return super().submit(fn, *a, **k)

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Counting)
    return seen


@pytest.mark.parametrize("n", [6, 7], ids=["set", "set_and_twin"])
def test_the_merge_equals_first_file_claims(fonts_dir, tmp_path, n):
    paths, fonts = _paths(fonts_dir, n)
    c = Claims([f.fontstack for f in fonts], [f.codepoints for f in fonts])
    files = _merge(paths, tmp_path / "out")
    assert c.fontstacks == ["noto_sans_regular"]
    assert set(files) == c.paths()
    assert json.loads(files["index.json"]) == c.index()
    m = FontManager()
    m.add_paths(map(str, paths))
    assert _claim_counts(m) == c.stats()
    assert c.stats()["mixed_blocks"] == 1 and c.stats()["shadowed"] == 10 + 8 + 16 * (n - 6)
    mod = harness.Definitions().driver("merge_set_dir")
    exp = mod.ClaimedExpected(fonts, c)
    ref, starts = exp.render("cpu")
    got, want = [], []
    for b in c.blocks("noto_sans_regular"):
        rng = c.block_range(b)
        [(fs, r, glyphs)] = decode.read_pbf(files[f"noto_sans_regular/{rng}.pbf"])
        assert (fs, r) == ("noto_sans_regular", rng)
        own = {cp: v for cp, v in c.owner[fs].items() if cp // 256 == b}
        assert sorted(g[0] for g in glyphs) == sorted(own)
        for g in glyphs:
            fi, k = own[g[0]]
            p = exp.preps[fi]
            assert tuple(g[1:6]) == (p.pbf_width[k], p.pbf_height[k], p.pbf_left[k],
                                     p.pbf_top[k], p.advance[k]), (fi, g[0])
            s, size = starts[exp.index[fi][k]], int(p.width[k] * p.height[k])
            assert len(g[6] or b"") == (0 if p.empty[k] else size)
            got.append(np.frombuffer(g[6] or b"", np.uint8))
            want.append(ref[s:s + len(g[6] or b"")])
    diff = np.abs(np.concatenate(got).astype(np.int16) - np.concatenate(want).astype(np.int16))
    limits = harness.Definitions().cell("noto_regular_set_merge")["limits"]
    assert diff.max() <= limits["max_abs_byte_diff"]
    assert 100.0 * np.count_nonzero(diff) / diff.size <= limits["pct_pixels_off"]


def test_a_file_that_claims_nothing_gets_no_future(fonts_dir, tmp_path, submits):
    paths, _ = _paths(fonts_dir)
    _merge(paths, tmp_path / "out")
    assert submits == ["_prep_file"] * 6  # seven files, the twin claims nothing


def test_a_one_file_fontstack_plans_one_future(fonts_dir, tmp_path, submits):
    paths, _ = _paths(fonts_dir)
    _merge(paths[:1], tmp_path / "one")
    assert submits == ["_prep_file"]
    # A fontstack of its own a file, as `recurse` of a family: one each.
    submits.clear()
    m = FontManager(parallel=False)
    for i, p in enumerate(paths[:3]):
        m.add_font_with_name(f"Stack {i}", [p])
    from versatiles_glyphs_tpu_torch.render.driver import Renderer
    from versatiles_glyphs_tpu_torch.writer import Writer

    m.render_glyphs(Writer.new_dummy(), Renderer("zeros"))
    assert submits == ["_prep_file"] * 3


def _tree_bytes(out):
    return {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*")) if p.is_file()}


def test_the_tree_equals_one_prep_threads(fonts_dir, tmp_path, monkeypatch):
    paths, _ = _paths(fonts_dir)
    # Two fontstacks of several files each, interleaved on the command line.
    d = tmp_path / "fonts"
    d.mkdir()
    other = [deploy.generator("text_ttf").fonts(
        {"family": "Fira Sans", "styles": [["Regular", "fira_sans_regular"]], "glyphs": 20,
         "codepoint_ranges": [[48 + 12 * i, 67 + 12 * i]], "quads": 8}, 90 + i, SEED)[0]
             for i in range(2)]
    deploy.write(other, str(d))
    mixed = [paths[0], d / other[0].filename, *paths[1:3], d / other[1].filename, *paths[3:]]
    many = _tree_bytes_of(mixed, tmp_path / "many")
    orig = concurrent.futures.ThreadPoolExecutor
    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor",
                        lambda max_workers=None, **k: orig(max_workers=1, **k))
    one = _tree_bytes_of(mixed, tmp_path / "one")
    assert set(many) == set(one) and all(many[k] == one[k] for k in many)
    assert sorted({k.split("/")[0] for k in many if "/" in k}) == ["fira_sans_regular",
                                                                  "noto_sans_regular"]


def _tree_bytes_of(paths, out):
    _merge(paths, out)
    return _tree_bytes(out)


@pytest.mark.parametrize("where", ["file", "block"])
def test_a_failing_prep_fails_the_merge(fonts_dir, tmp_path, monkeypatch, where):
    paths, _ = _paths(fonts_dir)
    if where == "file":
        def boom(self):
            if self.label.endswith("Devanagari"):
                raise RuntimeError("planted")
            return orig_cores(self)

        orig_cores = tentry.FontFileEntry.prep_cores.func
        monkeypatch.setattr(tentry.FontFileEntry, "prep_cores", property(boom))
    else:
        from versatiles_glyphs_tpu_torch.render import driver

        def boom(self, sources):
            raise RuntimeError("planted")

        monkeypatch.setattr(driver.Renderer, "prep_block", boom)
    with pytest.raises(RuntimeError, match="planted"):
        _merge(paths, tmp_path / "out")


def test_merge_stats_of_two_fontstacks(fonts_dir):
    paths, fonts = _paths(fonts_dir, 6)
    m = FontManager()
    m.add_paths(map(str, paths))
    m.add_font_with_name("Other", [str(paths[0])])
    tasks = m.collect_tasks()
    c = Claims([f.fontstack for f in fonts] + ["other"], [f.codepoints for f in fonts]
               + [fonts[0].codepoints])
    assert _claim_counts(m) == c.stats() and len(tasks) == c.stats()["blocks"]
    assert c.stats()["fontstacks"] == 2


def test_the_configured_set_lands_in_one_fontstack(tmp_path):
    """The cell's 23 files at their configured size: the program's
    names and claim walk as the reference counts them."""
    fonts = deploy.fonts(harness.Definitions().config("noto_sans_regular_set"), SEED)
    deploy.write(fonts, str(tmp_path))
    m = FontManager()
    m.add_paths([str(tmp_path / f.filename) for f in fonts])
    assert list(m.fonts) == ["noto_sans_regular"]
    tasks = m.collect_tasks()
    c = Claims([f.fontstack for f in fonts], [f.codepoints for f in fonts])
    assert _claim_counts(m) == c.stats() == {
        "files": 23, "fontstacks": 1, "blocks": 202, "mixed_blocks": 12, "claimed": 46574,
        "shadowed": 42079}
    assert [b.range() for _, b in tasks] == [c.block_range(b) for b in sorted(
        c.blocks("noto_sans_regular"), key=lambda b: min(
            (fi, k) for cp, (fi, k) in c.owner["noto_sans_regular"].items() if cp // 256 == b))]


def test_the_plan_under_many_threads():
    """Many fontstacks of several files, on more pool threads than cores,
    with the interpreter switching threads often: each fontstack's
    blocks prepped once, after every one of its files."""
    import threading
    import types

    from versatiles_glyphs_tpu_torch.font import manager
    from versatiles_glyphs_tpu_torch.font.block import GlyphBlock

    class Entry:
        def __init__(self, n):
            self.metadata = types.SimpleNamespace(codepoints=range(n))
            self.preps = 0

        @property
        def prep_cores(self):
            self.preps += 1

    class Renderer:
        def __init__(self):
            self.lock, self.blocks = threading.Lock(), 0

        def prep_block(self, sources):
            assert all(e.preps == 1 for _, e in sources)
            with self.lock:
                self.blocks += 1
            return [cp for cp, _ in sources]

    tasks, want = [], {}
    for s in range(60):
        files = [Entry(k + 1) for k in range(1 + s % 7)]
        for b in range(3):
            block = GlyphBlock(256 * b)
            for i, e in enumerate(files):
                block.set_glyph_font(i + b, e)
            tasks.append((f"stack_{s}", block))
            want.setdefault(f"stack_{s}", []).append(list(range(256 * b + b, 256 * b + b + len(files))))
    renderer = Renderer()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 2)) as pool:
            plan = manager._PrepPlan(pool, renderer, None)
            runs = manager._fontstack_runs(tasks)
            for run in runs:
                plan.start(run)
            got = {run.name: run.done.result(timeout=120) for run in runs}
            plan.join()
    finally:
        sys.setswitchinterval(old)
    assert got == want and renderer.blocks == len(tasks)
    assert all(e.preps == 1 for _, b in tasks for e in b.files())
