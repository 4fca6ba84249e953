"""The port's renders over the flat segment layout against the JAX
package, on the CPU: `render.batch.pack_flat`, the plain versions of
the legacy tile kernel (TPU kernel 6) and the padded-grid kernel (TPU
kernel 7), and their wrappers in `ops.legacy`.

The same numpy arrays, made by the JAX package's packers, go through
the JAX kernels and their counterparts. The JAX side (both Pallas
kernels in interpret mode and their jnp twins) runs in one subprocess
with XLA's CPU backend capped below FMA (``--xla_cpu_max_isa=AVX``), so
that every multiply and add is rounded as on the TPU and in the port:
the bytes must then be equal. The CUDA kernels run only on the card
(`chip_smoke.py`); here the wrappers take their plain versions because
the tensors lie on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu.render.metrics import GlyphPrep
from versatiles_glyphs_tpu.utils import arena
from versatiles_glyphs_tpu_torch.ops import legacy, sdf_cuda, sdf_torch
from versatiles_glyphs_tpu_torch.render import batch as tbatch
from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 256


def _degenerate_preps():
    """Zero-length and horizontal segments, a point, and rings with a
    repeated point."""
    segs = np.array([
        [5.0, 5.0, 5.0, 5.0], [5.0, 5.0, 15.0, 5.0], [15.0, 5.0, 15.0, 15.0],
        [15.0, 15.0, 5.0, 15.0], [5.0, 15.0, 5.0, 5.0], [9.5, 9.5, 9.5, 9.5],
    ])
    box = GlyphPrep(codepoint=65, advance=20, empty=False, width=22, height=22,
                    x0=-1, y0=-1, x1=21, y1=21, segments=segs)
    rings = GlyphPrep(codepoint=66, advance=20, empty=False, width=20, height=20,
                      x0=0, y0=0, x1=20, y1=20,
                      rings_px=[np.array([[3.0, 3.0], [12.0, 3.0], [12.0, 12.0], [3.0, 3.0]]),
                                np.array([[6.0, 6.0], [6.0, 6.0], [7.0, 6.0]])])
    return [box, rings]


def _preps(case):
    return curved_preps(30, 65, seed=3) if case == "curved" else _degenerate_preps()


CASES = ("curved", "degenerate")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_arrays(preps):
    """The JAX packers' arrays of a group: flat, meta, P_pad, the
    row-major tile table, the jnp twins' window and the grid TPs."""
    flat, meta, P = (np.array(a) if isinstance(a, np.ndarray) else a
                     for a in jbatch.pack_flat(preps))
    tmeta, starts, T = jbatch.plan_tiles(preps, meta, TP)
    S_max = jbatch.bucket(int(meta[:, 4].max()), jbatch.S_BUCKETS)
    return {"flat": flat, "meta": meta, "P": P, "tmeta": np.array(tmeta), "starts": starts,
            "T": T, "S_max": S_max, "tps": np.array(sorted({min(1024, P), TP}))}


_JAX_SIDE = r"""
import sys, numpy as np
from versatiles_glyphs_tpu.ops.legacy import render_bitmaps_pallas, render_bitmaps_pallas_tiles
from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_flat_jax, render_bitmaps_tiles_jax
for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
    a = np.load(src)
    flat, meta, tmeta = a["flat"], a["meta"], a["tmeta"]
    P, S_max = int(a["P"]), int(a["S_max"])
    out = {
        "tiles_pallas": render_bitmaps_pallas_tiles(flat, np.ascontiguousarray(tmeta.T), 256,
                                                    interpret=True),
        "tiles_twin": render_bitmaps_tiles_jax(flat, tmeta, 256, S_max),
        "grid_twin": render_bitmaps_flat_jax(flat, meta, P, S_max),
    }
    for tp in a["tps"]:
        out[f"grid_pallas_{tp}"] = render_bitmaps_pallas(flat, meta, P, int(tp), interpret=True)
    np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_renders(tmp_path_factory):
    """Per case: the packed arrays and the JAX package's bytes, from one
    subprocess with XLA's FMA contraction off."""
    tmp = tmp_path_factory.mktemp("jax_legacy")
    cases, argv = {}, []
    for case in CASES:
        preps = _preps(case)
        arrays = _jax_arrays(preps)
        src, dst = tmp / f"{case}_in.npz", tmp / f"{case}_out.npz"
        np.savez(src, **arrays)
        cases[case] = (preps, arrays, dst)
        argv += [str(src), str(dst)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {case: (preps, arrays, dict(np.load(dst))) for case, (preps, arrays, dst) in cases.items()}


@pytest.mark.parametrize("N_pad", [None, 65536])
@pytest.mark.parametrize("case", CASES)
def test_pack_flat_matches_jax(case, N_pad):
    """Array for array, with both packers' arena buffers fresh (lanes
    past each run are zeros then; otherwise they hold stale values)."""
    preps = _preps(case)
    arena.clear()
    want = [np.array(a) if isinstance(a, np.ndarray) else a for a in jbatch.pack_flat(preps, N_pad)]
    got = tbatch.pack_flat(preps, N_pad)
    assert tbatch.P_BUCKETS == jbatch.P_BUCKETS
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_pack_flat_of_no_glyph():
    flat, meta, P = tbatch.pack_flat([])
    assert flat.shape == (4, tbatch.N_BUCKETS[0]) and not meta.any() and meta.shape == (1, 8)
    assert P == tbatch.P_BUCKETS[0]


@pytest.mark.parametrize("case", CASES)
def test_tiles_flat_matches_jax(jax_renders, case):
    """Plain kernel 6 = the Pallas tile kernel (interpret mode) = its
    jnp twin, byte for byte over every row, padding rows included."""
    _, a, want = jax_renders[case]
    got = legacy.render_bitmaps_cuda_tiles(_t(a["flat"]), _t(a["tmeta"].T), TP)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (a["tmeta"].shape[0], TP)
    np.testing.assert_array_equal(got.numpy(), want["tiles_pallas"])
    np.testing.assert_array_equal(got.numpy(), want["tiles_twin"])
    assert got[: a["T"]].sum() > 0 and not got[a["T"] :].any()


@pytest.mark.parametrize("case", CASES)
def test_grid_flat_matches_jax(jax_renders, case):
    """Plain kernel 7 = the Pallas grid kernel (interpret mode) byte for
    byte at TP = min(1024, P) and at TP = 256, where a glyph spans
    several tiles and the tiles at or past w·h are zeros. The jnp twin
    computes every tile, so it agrees on the live ones."""
    _, a, want = jax_renders[case]
    w, h = a["meta"][:, 2], a["meta"][:, 3]
    for tp in a["tps"]:
        tp = int(tp)
        got = legacy.render_bitmaps_cuda_grid(_t(a["flat"]), _t(a["meta"]), a["P"], tp)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (a["meta"].shape[0], a["P"])
        np.testing.assert_array_equal(got.numpy(), want[f"grid_pallas_{tp}"])
        base = np.arange(a["P"]) // tp * tp
        live = base[None, :] < (w * h)[:, None]
        np.testing.assert_array_equal(got.numpy()[live], want["grid_twin"][live])
        if case == "curved" and tp == TP:
            assert (~live).any() and not got.numpy()[~live].any()


@pytest.mark.parametrize("case", CASES)
def test_flat_renders_match_point_chain_render(jax_renders, case):
    """On the same glyphs, each bitmap (its first w·h bytes) from plain
    kernels 6 and 7 equals kernel 1's plain version on the f32 point
    chain: the same f32 endpoints and the same op order."""
    preps, a, _ = jax_renders[case]
    pts, words, pm = tbatch.pack_points(preps, dtype=np.float32, arena_tag="_tlegacy")
    tm, starts, _ = tbatch.plan_tiles(preps, pm, TP)
    pts_bytes = sdf_torch.render_tiles_pts(_t(pts), _t(words), _t(tm.T), TP).reshape(-1)
    tiles = legacy.render_bitmaps_cuda_tiles(_t(a["flat"]), _t(a["tmeta"].T), TP).reshape(-1)
    grid = legacy.render_bitmaps_cuda_grid(_t(a["flat"]), _t(a["meta"]), a["P"], min(1024, a["P"]))
    for g, p in enumerate(preps):
        n = p.width * p.height
        want = pts_bytes[starts[g] * TP : starts[g] * TP + n]
        np.testing.assert_array_equal(tiles[a["starts"][g] * TP : a["starts"][g] * TP + n], want)
        np.testing.assert_array_equal(grid[g, :n], want)


def test_render_chunking_is_exact(monkeypatch):
    """One row per chunk gives the same bytes as one chunk of all."""
    a = _jax_arrays(_preps("curved"))
    args = (_t(a["flat"]), _t(a["tmeta"].T), TP)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1 << 30)
    whole = sdf_torch.render_tiles_flat(*args)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1)
    np.testing.assert_array_equal(sdf_torch.render_tiles_flat(*args).numpy(), whole.numpy())


def test_grid_tmeta_rows():
    """The grid's tile table: each glyph's row once per tile, pix_base
    0, TP, 2·TP, …"""
    meta = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]],
                        dtype=torch.int32)
    rows = sdf_torch.grid_tmeta(meta, 1024, 256)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (8, 8)
    np.testing.assert_array_equal(rows[6].numpy(), [0, 256, 512, 768] * 2)
    np.testing.assert_array_equal(rows[:6, :4].numpy(), meta[0, :6, None].expand(6, 4).numpy())
    np.testing.assert_array_equal(rows[:6, 4:].numpy(), meta[1, :6, None].expand(6, 4).numpy())


def test_cpu_wrappers_count_no_launches():
    a = _jax_arrays(_degenerate_preps())
    sdf_cuda.reset_launches()
    legacy.render_bitmaps_cuda_tiles(_t(a["flat"]), _t(a["tmeta"].T), TP)
    legacy.render_bitmaps_cuda_grid(_t(a["flat"]), _t(a["meta"]), a["P"], TP)
    assert sdf_cuda.LAUNCHES == dict.fromkeys(sdf_cuda.KERNELS, 0)


@pytest.mark.parametrize("bad", ["flat_dtype", "flat_rows", "tmeta_dtype", "tp"])
def test_tiles_wrapper_rejects_bad_inputs(bad):
    a = _jax_arrays(_degenerate_preps())
    args = {"flat": _t(a["flat"]), "tmeta": _t(a["tmeta"].T), "TP": TP}
    if bad == "flat_dtype":
        args["flat"] = args["flat"].double()
    elif bad == "flat_rows":
        args["flat"] = args["flat"][:3]
    elif bad == "tmeta_dtype":
        args["tmeta"] = args["tmeta"].long()
    else:
        args["TP"] = 100
    with pytest.raises(ValueError):
        legacy.render_bitmaps_cuda_tiles(**args)


@pytest.mark.parametrize("bad", ["flat_dtype", "meta_dtype", "meta_cols", "P_not_multiple", "tp"])
def test_grid_wrapper_rejects_bad_inputs(bad):
    a = _jax_arrays(_degenerate_preps())
    args = {"flat": _t(a["flat"]), "meta": _t(a["meta"]), "P": a["P"], "TP": TP}
    if bad == "flat_dtype":
        args["flat"] = args["flat"].half()
    elif bad == "meta_dtype":
        args["meta"] = args["meta"].long()
    elif bad == "meta_cols":
        args["meta"] = args["meta"][:, :6]
    elif bad == "P_not_multiple":
        args["P"] = a["P"] + 32
    else:
        args["TP"] = 2048
    with pytest.raises(ValueError):
        legacy.render_bitmaps_cuda_grid(**args)
