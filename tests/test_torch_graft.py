"""The port's graft entry (`__graft_entry_torch__.py`) against the JAX
package's (`__graft_entry__.py`), on the CPU.

`entry()` without a card returns the plain version of the padded-grid
render on CPU tensors; its bytes equal the JAX entry's jnp twin on every
live pixel (tolerance: none). The twin computes pixel tiles past a
glyph's w·h, where the port writes zeros, a divergence recorded in
ROADMAP. The JAX entry runs in a subprocess with XLA's CPU backend
capped below FMA (``--xla_cpu_max_isa=AVX``), as the other
port-against-JAX tests run it. The card's branch is rehearsed here on
CPU tensors, where the kernel wrapper takes its plain version.

`dryrun_multichip(n)` runs on CPU stand-ins, once in a fresh interpreter
whose import system refuses JAX, the JAX package and fontTools (the
card's machine has neither JAX nor fontTools).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry_torch__ as graft
from versatiles_glyphs_tpu_torch.ops import sdf_torch
from versatiles_glyphs_tpu_torch.ops.sdf_ref import render_sdf_exact
from versatiles_glyphs_tpu_torch.render.metrics import prepare_glyph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_ENTRY = r"""
import sys, numpy as np
import __graft_entry__ as g
fn, args = g.entry()
np.save(sys.argv[1], np.asarray(fn(*args)))
"""


@pytest.fixture(scope="module")
def jax_entry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_entry")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_ENTRY, str(tmp / "out.npy")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(tmp / "out.npy")


def test_entry_matches_jax_on_live_pixels(jax_entry):
    fn, args = graft.entry()
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    got = fn(*args).numpy()
    assert got.dtype == np.uint8 and got.shape == jax_entry.shape == (2, 256)
    _, meta = args
    for g in range(2):
        live = int(meta[g, 2] * meta[g, 3])
        assert live == 256
        np.testing.assert_array_equal(got[g, :live], jax_entry[g, :live])
    assert got.any()


def test_entry_card_branch_rehearsed_on_the_cpu(monkeypatch):
    """The card's branch with the device patched to the CPU: kernel 1's
    wrapper on the i8-delta wire (its plain version here) gives, on each
    glyph's tiles, the bytes of `sdf_torch.render_tiles_pts` on the
    decoded wire, within 1 of the exact renderer."""
    import versatiles_glyphs_tpu_torch.device as device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device, "cuda_device", lambda: torch.device("cpu"))
    fn, args = graft.entry()
    deltas, words, anchors, meta = args
    assert tuple(meta.shape) == (32, 8) and deltas.dtype == torch.int8
    out = fn(*args)
    assert tuple(out.shape) == (256, 256) and out.dtype == torch.uint8
    pts = sdf_torch.dequantize(sdf_torch.reconstruct_delta(deltas, anchors))
    tmeta = sdf_torch.derive_tmeta(meta, 256, 256)
    np.testing.assert_array_equal(out.numpy(), sdf_torch.render_tiles_pts(pts, words, tmeta, 256).numpy())
    preps = [prepare_glyph(65, graft._square_rings(1.0, 5.0), 1000, 500),
             prepare_glyph(66, graft._square_rings(2.0, 9.0), 1000, 600)]
    row = 0
    for p in preps:
        n = p.width * p.height
        tiles = -(-n // 256)
        got = out[row : row + tiles].reshape(-1)[:n].numpy().astype(np.int32)
        want = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0).astype(np.int32)
        assert np.abs(got - want).max() <= 1
        row += tiles


@pytest.mark.parametrize("n", [1, 3])
def test_dryrun_multichip_on_cpu_stand_ins(n):
    res = graft.dryrun_multichip(n)
    assert res["devices"] == ["cpu"] * n
    assert np.isfinite(res["loss_torch"]) and np.isfinite(res["loss_flat"])
    assert res["render_bytes"] > 0


def test_dryrun_multichip_alone():
    """`dryrun_multichip(2)` in a fresh interpreter that refuses JAX, the
    JAX package and fontTools: it runs, and none of them is loaded."""
    refused = ("versatiles_glyphs_tpu", "jax", "jaxlib", "fontTools")
    code = (
        "import importlib.abc, sys\n"
        f"REFUSED = {refused!r}\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in REFUSED:\n"
        "            raise ImportError('refused for the test: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import __graft_entry_torch__ as g\n"
        "res = g.dryrun_multichip(2)\n"
        "fn, args = g.entry()\n"
        "assert fn(*args).any()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)\n"
        "assert not bad, bad\n"
        "print('ALONE', res['devices'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ALONE ['cpu', 'cpu']" in proc.stdout
