"""The port stands alone: it imports nothing of the JAX package.

(a) No ``.py`` of `versatiles_glyphs_tpu_torch`, and neither
``chip_smoke.py`` nor ``__graft_entry_torch__.py``, holds an import of `versatiles_glyphs_tpu` or of `jax` (an ``ast`` walk,
so imports inside functions count and comments do not).

(b) In a fresh interpreter whose import system refuses
`versatiles_glyphs_tpu`, `jax` and `jaxlib`, the port's ``merge``
(``--renderer torch``, and ``--renderer padded --device cpu``) and
``fit --device cpu --render`` on a synthesized TTF write the trees they
write with nothing refused; the ``torch`` ``merge`` tree is also the
JAX CLI's, byte for byte (tolerance: none; the fit's
agreement with the JAX CLI has its tolerance in ``test_torch_fit.py``).
"""

import ast
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from versatiles_glyphs_tpu.cli import main as jax_main
from versatiles_glyphs_tpu_torch.cli import main as torch_main
from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "versatiles_glyphs_tpu_torch")
REFUSED = ("versatiles_glyphs_tpu", "jax", "jaxlib")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "__graft_entry_torch__.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    """(line, absolute module name) of every import statement of a file;
    relative imports stay inside their package and are left out."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def test_the_walk_sees_the_port():
    files = _port_files()
    names = {os.path.relpath(f, ROOT) for f in files}
    assert len(files) > 40
    for rel in ("chip_smoke.py", "__graft_entry_torch__.py",
                "versatiles_glyphs_tpu_torch/proto/native.py",
                "versatiles_glyphs_tpu_torch/font/entry.py",
                "versatiles_glyphs_tpu_torch/tools/roofline.py"):
        assert rel in names
    # It would catch an import inside a function.
    found = _imports(os.path.join(ROOT, "tests", "test_torch_selfcontained.py"))
    assert any(mod == "versatiles_glyphs_tpu.cli" for _, mod in found)


@pytest.mark.parametrize("refused", REFUSED)
def test_no_file_of_the_port_imports(refused):
    bad = [
        f"{os.path.relpath(path, ROOT)}:{line}: {mod}"
        for path in _port_files()
        for line, mod in _imports(path)
        if mod.split(".")[0] == refused
    ]
    assert not bad, bad


def test_no_module_name_in_importlib_calls():
    """No dynamic import of the JAX package either: its name appears in
    the port's code only in prose (docstrings and comments)."""
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant) \
                    and str(arg.value).split(".")[0] in REFUSED:
                bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert not bad, bad


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


BLOCKER = (
    "import importlib.abc, sys\n"
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


def _run_blocked(argv):
    code = BLOCKER + f"main({argv!r})\n" + (
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)\n"
        "assert not bad, bad\n"
        "print('ALONE')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ALONE" in proc.stdout


@pytest.fixture
def font(tmp_path):
    path = tmp_path / "curved.ttf"
    path.write_bytes(build_ttf_curved(14, 0xF8, seed=11))
    return str(path)


def test_merge_with_the_jax_package_unimportable(tmp_path, font, monkeypatch):
    monkeypatch.setenv("VG_JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    _run_blocked(["merge", font, "-o", str(tmp_path / "blocked"), "--renderer", "torch"])
    torch_main(["merge", font, "-o", str(tmp_path / "open"), "--renderer", "torch"],
               stdout=io.BytesIO())
    jax_main(["merge", font, "-o", str(tmp_path / "jax"), "--renderer", "tpu", "--single-thread"],
             stdout=io.BytesIO())
    got = _tree(tmp_path / "blocked")
    assert got == _tree(tmp_path / "open") == _tree(tmp_path / "jax")
    assert sorted(got) == ["font_families.json", "index.json", "synth_curved_regular/0-255.pbf",
                           "synth_curved_regular/256-511.pbf"]


def test_merge_padded_with_the_jax_package_unimportable(tmp_path, font):
    """``--renderer padded --device cpu`` (the JAX ``jax`` renderer's
    port) with JAX refused writes the tree it writes in this process;
    `tests/test_torch_render_padded.py` holds that tree against the JAX
    CLI's."""
    args = ["merge", font, "--renderer", "padded", "--device", "cpu"]
    _run_blocked(args + ["-o", str(tmp_path / "blocked")])
    torch_main(args + ["-o", str(tmp_path / "open")], stdout=io.BytesIO())
    got = _tree(tmp_path / "blocked")
    assert got == _tree(tmp_path / "open")
    assert sorted(got) == ["font_families.json", "index.json", "synth_curved_regular/0-255.pbf",
                           "synth_curved_regular/256-511.pbf"]


def test_fit_render_with_the_jax_package_unimportable(tmp_path, font):
    args = ["fit", font, "--codepoints", "0xF8-0xFD", "--steps", "4", "--depth", "2",
            "--device", "cpu", "--backend", "flat", "--render", "--render-backend", "torch"]
    _run_blocked(args + ["-o", str(tmp_path / "blocked")])
    torch_main(args + ["-o", str(tmp_path / "open")], stdout=io.StringIO())
    got, want = _tree(tmp_path / "blocked"), _tree(tmp_path / "open")
    assert sorted(got) == sorted(want)
    assert any(name.startswith("glyphs/") and name.endswith(".pbf") for name in want)
    for name in want:
        if name == "checkpoint":  # a pickle: compared through fitted.npz and history.json
            continue
        if name.endswith(".npz"):  # a zip, which stamps its entries with the time
            a, b = np.load(io.BytesIO(got[name])), np.load(io.BytesIO(want[name]))
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert got[name] == want[name], name
