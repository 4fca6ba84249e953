"""The port's CLI reads and writes fonts with fontTools unimportable, and
gives the JAX CLI's results, on the CPU.

(d) One fresh interpreter whose import system refuses fontTools, `jax`,
`jaxlib` and `versatiles_glyphs_tpu` runs the port's ``merge
--renderer torch`` of a font written by `utils.synth_font.
build_ttf_curved`, ``recurse --tar`` over three such fonts, ``debug``
of the merged tree and ``fit --device cpu --backend flat --render`` of
the font and codepoints of `tests/test_torch_fit.py` (4 glyphs, 10
steps, depth 2), where that file's tolerance was set.
This process runs the JAX CLI on the same files (``--renderer tpu
--single-thread``, the JAX twin of the same wire, and ``fit --backend
pallas``, the JAX twin of the flat kernels). The trees, the tar stream
(its clock fixed in both) and the debug rows are byte-equal; the fit
keeps the same codepoints, mask, history steps and atlas files, with
parameters within 0.01 px and losses within 1e-3 relative (the
tolerance of `tests/test_torch_fit.py::test_fit_cli_matches_jax`). That
bound is empirical: a self-fit starts at the optimum, where Adam's
normalized steps move a parameter with a rounding-level gradient by up
to the learning rate either way, so other fonts can exceed it.

(e) Fonts the JAX package reads through fontTools: a CFF2 font, a font
whose only unicode cmap subtable is of format 13, and 64 glyphs of
`utils.synth_font.cjk_outlines` over two blocks as a CID-keyed OTF
(`build_otf_curved`) and as its CFF2 twin (`build_otf2_curved`). The
same refusing interpreter ``merge``s each (``--renderer torch``), and
the trees are the JAX CLI's (``--renderer tpu --single-thread``), byte
for byte.
"""

import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
from fontTools.ttLib import TTFont
from fontTools.ttLib.tables._c_m_a_p import CmapSubtable

from versatiles_glyphs_tpu.cli import main as jax_main
from versatiles_glyphs_tpu.utils.synth_font import build_otf2, build_ttf
from versatiles_glyphs_tpu_torch.utils.synth_font import (
    build_otf2_curved,
    build_otf_curved,
    build_ttf_curved,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("fontTools", "jax", "jaxlib", "versatiles_glyphs_tpu")
FAMILIES = ("Synth Alpha", "Synth Bravo", "Synth Charlie")
FIT = ["--codepoints", "65-68", "--steps", "10", "--depth", "2"]
NOW = 1_700_000_789.0

BLOCKER = (
    "import importlib.abc, io, sys, time\n"
    f"REFUSED = {REFUSED!r}\n"
    "class Refuse(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in REFUSED:\n"
    "            raise ImportError('refused for the test: ' + name)\n"
    "sys.meta_path.insert(0, Refuse())\n"
    "for name in REFUSED:\n"
    "    try:\n"
    "        __import__(name)\n"
    "    except ImportError:\n"
    "        continue\n"
    "    raise SystemExit(name + ' was importable')\n"
    "from versatiles_glyphs_tpu_torch.cli import main\n"
)

PORT_SIDE = BLOCKER + f"""
time.time = lambda: {NOW!r}
font, fonts, fit_font, out = sys.argv[1:5]
main(["merge", font, "-o", out + "/merge", "--renderer", "torch"], stdout=io.BytesIO())
with open(out + "/recurse.tar", "wb") as f:
    main(["recurse", fonts, "--tar", "--renderer", "torch"], stdout=f)
rows = io.StringIO()
main(["debug", out + "/merge/synth_alpha_regular"], stdout=rows)
open(out + "/debug.csv", "w").write(rows.getvalue())
main(["fit", fit_font, *{FIT!r}, "--device", "cpu", "--backend", "flat", "--render",
      "--render-backend", "torch", "-o", out + "/fit"], stdout=io.StringIO())
for path in sys.argv[5:]:
    stem = path.rsplit("/", 1)[-1].split(".")[0]
    main(["merge", path, "-o", out + "/extra/" + stem, "--renderer", "torch"], stdout=io.BytesIO())
bad = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)
assert not bad, bad
print("ALONE")
"""


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's outputs, JAX CLI's outputs): the port's from the refusing
    interpreter, the JAX CLI's from this process."""
    tmp = tmp_path_factory.mktemp("nofonttools")
    fonts = tmp / "fonts"
    fonts.mkdir()
    for seed, family in enumerate(FAMILIES):
        (fonts / f"{family.split()[1].lower()}.ttf").write_bytes(
            build_ttf_curved(24, 0x41, seed=seed + 5, quads=6, family=family))
    font, fit_font = str(fonts / "alpha.ttf"), str(tmp / "fit.ttf")
    (tmp / "fit.ttf").write_bytes(build_ttf_curved(4, 65, seed=1))
    extra = []
    for stem, data in EXTRA_FONTS.items():
        extra.append(tmp / f"{stem}.otf")
        extra[-1].write_bytes(data())
    port, jax = tmp / "port", tmp / "jax"
    proc = subprocess.run([sys.executable, "-c", PORT_SIDE, font, str(fonts), fit_font,
                           str(port), *map(str, extra)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ALONE" in proc.stdout

    mp = pytest.MonkeyPatch()
    mp.setattr("time.time", lambda: NOW)
    try:
        jax_main(["merge", font, "-o", str(jax / "merge"), "--renderer", "tpu",
                  "--single-thread"], stdout=io.BytesIO())
        with open(jax / "recurse.tar", "wb") as f:
            jax_main(["recurse", str(fonts), "--tar", "--renderer", "tpu", "--single-thread"],
                     stdout=f)
    finally:
        mp.undo()
    rows = io.StringIO()
    jax_main(["debug", str(jax / "merge" / "synth_alpha_regular")], stdout=rows)
    (jax / "debug.csv").write_text(rows.getvalue())
    jax_main(["fit", fit_font, *FIT, "--backend", "pallas", "--render", "--render-backend", "tpu",
              "-o", str(jax / "fit")], stdout=io.StringIO())
    for path in extra:
        jax_main(["merge", str(path), "-o", str(jax / "extra" / path.stem), "--renderer", "tpu",
                  "--single-thread"], stdout=io.BytesIO())
    return port, jax


def test_merge_tree_equals_jax(runs):
    port, jax = runs
    got = _tree(port / "merge")
    assert got == _tree(jax / "merge")
    assert sorted(got) == ["font_families.json", "index.json", "synth_alpha_regular/0-255.pbf"]


def test_recurse_tar_equals_jax(runs):
    port, jax = runs
    got = (port / "recurse.tar").read_bytes()
    assert got == (jax / "recurse.tar").read_bytes()
    with tarfile.open(fileobj=io.BytesIO(got)) as tar:
        names = sorted(m.name for m in tar.getmembers() if m.isfile())
    assert names == sorted(["font_families.json", "index.json"] + [
        f"{f.lower().replace(' ', '_')}_regular/0-255.pbf" for f in FAMILIES])


def test_debug_rows_equal_jax(runs):
    port, jax = runs
    got = (port / "debug.csv").read_text()
    assert got == (jax / "debug.csv").read_text()
    assert len(got.splitlines()) == 25


def test_fit_within_tolerance_of_jax(runs):
    port, jax = runs
    got, want = np.load(port / "fit" / "fitted.npz"), np.load(jax / "fit" / "fitted.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in ("codepoints", "curve_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["codepoints"]) == 4
    for k in ("curves", "translate", "log_gain"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.01, err_msg=k)
    hp = json.loads((port / "fit" / "history.json").read_text())
    hj = json.loads((jax / "fit" / "history.json").read_text())
    assert [h["step"] for h in hp] == [h["step"] for h in hj] == list(range(10))
    np.testing.assert_allclose([h["loss"] for h in hp], [h["loss"] for h in hj], rtol=1e-3)
    assert sorted(_tree(port / "fit" / "glyphs")) == sorted(_tree(jax / "fit" / "glyphs"))


def _cmap13_font() -> bytes:
    """A TrueType font whose only unicode cmap subtable is format 13."""
    font = TTFont(io.BytesIO(build_ttf(6, family="Thirteen Sans")))
    sub = CmapSubtable.getSubtableClass(13)(13)
    sub.platformID, sub.platEncID, sub.language = 3, 10, 0
    sub.cmap = {65 + k: f"g{k}" for k in range(6)}
    font["cmap"].tables = [sub]
    buf = io.BytesIO()
    font.save(buf)
    return buf.getvalue()


# The fonts of (e): stem -> bytes. The CJK pair starts at U+34E0, so that
# its 64 glyphs fill two blocks.
EXTRA_FONTS = {
    "cff2": lambda: build_otf2(6, family="Two Sans"),
    "cmap13": _cmap13_font,
    "cjk_cid": lambda: build_otf_curved(64, seed=4, first_cp=0x34E0, family="Synth Ideo"),
    "cjk_cff2": lambda: build_otf2_curved(64, seed=4, first_cp=0x34E0, family="Synth Ideo"),
}


@pytest.mark.parametrize("kind,family,table", [
    ("cff2", "Two Sans", "the outlines of its 'CFF2' table"),
    ("cmap13", "Thirteen Sans", "its 'cmap' subtable (3, 10) of format 13"),
])
def test_font_that_needs_fonttools_fails_in_one_line(runs, kind, family, table):
    """Fonts whose ``table`` the JAX package reads through fontTools
    ``merge`` with fontTools refused, to the JAX CLI's tree."""
    port, jax = runs
    font = TTFont(io.BytesIO(EXTRA_FONTS[kind]()))
    if kind == "cff2":
        assert "CFF2" in font and "CFF " not in font and "glyf" not in font, table
    else:
        assert [(t.platformID, t.platEncID, t.format) for t in font["cmap"].tables] == [(3, 10, 13)]
    got = _tree(port / "extra" / kind)
    assert got == _tree(jax / "extra" / kind)
    stack = family.lower().replace(" ", "_") + "_regular"
    assert sorted(got) == ["font_families.json", "index.json", f"{stack}/0-255.pbf"]


@pytest.mark.parametrize("kind", ["cjk_cid", "cjk_cff2"])
def test_cjk_otf_merge_equals_jax(runs, kind):
    """The CID-keyed OTF and its CFF2 twin, 64 glyphs over two blocks:
    the JAX CLI's tree, and the same tree from both fonts."""
    port, jax = runs
    got = _tree(port / "extra" / kind)
    assert got == _tree(jax / "extra" / kind)
    assert got == _tree(port / "extra" / "cjk_cid")
    assert sorted(got) == ["font_families.json", "index.json", "synth_ideo_regular/13312-13567.pbf",
                           "synth_ideo_regular/13568-13823.pbf"]
