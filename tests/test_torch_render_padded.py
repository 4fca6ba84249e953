"""The port's padded-layout renderer (``--renderer padded``) against the
JAX package's ``--renderer jax``, on the CPU.

`render.batch.pack_segments` / `pack_block` must equal the JAX packers
exactly; `ops.sdf_torch.render_bitmaps_padded` must give the bytes of
`ops.sdf_jax.render_bitmaps_jax(..., sequential=True)` at every chunk
size; the port's ``merge``/``recurse`` with ``--renderer padded
--device cpu`` must write the JAX CLI's ``--renderer jax`` tree byte for
byte. Tolerance: none. The JAX renders run in one subprocess with XLA's
CPU backend capped below FMA (``--xla_cpu_max_isa=AVX``): jitted XLA
code on the CPU contracts multiply-adds, the port never does. The
fitted atlas of ``fit --render-backend padded`` is held to the exact
renderer's contract (integer metrics equal, bitmaps within 1 on at most
5 % of pixels).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu_torch.cli import main as torch_main
from versatiles_glyphs_tpu_torch.ops import sdf_torch
from versatiles_glyphs_tpu_torch.proto.pbf import decode_glyphs
from versatiles_glyphs_tpu_torch.render import batch
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.render.metrics import GlyphPrep
from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved, curved_preps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soups(seed: int = 3) -> list:
    """Random segment soups: one empty, the others with zero-length and
    horizontal segments among random ones."""
    rng = np.random.default_rng(seed)
    out = [np.zeros((0, 4))]
    for n in (1, 7, 40, 130):
        s = rng.uniform(-3.0, 20.0, size=(n, 4))
        s[::3, 2:] = s[::3, :2]  # zero length
        s[1::4, 3] = s[1::4, 1]  # horizontal
        out.append(s)
    return out


def _soup_preps(seed: int = 3) -> list:
    """Non-empty preps carrying `_soups`, with bitmaps of odd sizes."""
    rng = np.random.default_rng(seed + 1)
    preps = []
    for k, segs in enumerate(_soups(seed)):
        w, h = int(rng.integers(3, 23)), int(rng.integers(2, 19))
        x0, y0 = int(rng.integers(-4, 4)), int(rng.integers(-4, 4))
        preps.append(GlyphPrep(codepoint=65 + k, advance=20, empty=False, width=w, height=h,
                               x0=x0, y0=y0, x1=x0 + w, y1=y0 + h, segments=segs))
    return preps


def _block_preps() -> list:
    return curved_preps(9, 65, seed=6) + _soup_preps()


@pytest.mark.parametrize("S_pad", [None, 256])
def test_pack_segments_matches_jax(S_pad):
    got = batch.pack_segments(_soups(), S_pad=S_pad)
    want = jbatch.pack_segments(_soups(), S_pad=S_pad)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[0].any()  # the empty soup's rows stay zero


@pytest.mark.parametrize("P_pad,S_pad", [(None, None), (2048, 512), (None, 1024), (4096, None)])
def test_pack_block_matches_jax(P_pad, S_pad):
    preps = _block_preps()
    segs, meta, P = batch.pack_block(preps, P_pad=P_pad, S_pad=S_pad)
    jsegs, jmeta, jP = jbatch.pack_block(preps, P_pad=P_pad, S_pad=S_pad)
    assert P == jP and segs.shape == jsegs.shape and meta.dtype == jmeta.dtype
    np.testing.assert_array_equal(segs.view(np.int32), jsegs.view(np.int32))
    np.testing.assert_array_equal(meta, jmeta)


def test_pixel_coords_match_the_field_rows():
    """`pixel_coords` is the flat PBF order, Y flipped, valid below w·h."""
    meta = torch.tensor([[2, -1, 3, 2, 0], [0, 0, 0, 0, 0]], dtype=torch.int32)
    px, py, valid = sdf_torch.pixel_coords(meta, 8)
    np.testing.assert_array_equal(px[0, :6].numpy(), [2.5, 3.5, 4.5, 2.5, 3.5, 4.5])
    np.testing.assert_array_equal(py[0, :6].numpy(), [0.5, 0.5, 0.5, -0.5, -0.5, -0.5])
    assert valid[0].tolist() == [True] * 6 + [False] * 2 and not valid[1].any()


_JAX_SIDE = r"""
import io, os, sys, numpy as np
from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_jax
from versatiles_glyphs_tpu.cli import main
src, dst, tree, fonts_dir = sys.argv[1:5]
a = np.load(src)
out = np.asarray(render_bitmaps_jax(a["segs"], a["meta"], int(a["P"]), sequential=True))
np.save(dst, out)
fonts = sorted(f for f in os.listdir(fonts_dir) if f.endswith(".ttf"))
main(["merge", *[fonts_dir + "/" + f for f in fonts], "-o", tree + "/merge", "--renderer", "jax"],
     stdout=io.BytesIO())
main(["recurse", fonts_dir, "-o", tree + "/recurse", "--renderer", "jax"], stdout=io.BytesIO())
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's padded render of `_block_preps` and its
    ``merge`` and ``recurse`` trees (``--renderer jax``) of two
    synthesized TTFs, from one no-FMA subprocess."""
    tmp = tmp_path_factory.mktemp("jax_padded")
    fonts = tmp / "fonts"
    fonts.mkdir()
    (fonts / "a.ttf").write_bytes(build_ttf_curved(12, 0xF8, seed=11))
    (fonts / "b.ttf").write_bytes(build_ttf_curved(5, 0x2FE, seed=4, quads=3))
    segs, meta, P = batch.pack_block(_block_preps())
    np.savez(tmp / "in.npz", segs=segs, meta=meta, P=P)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"), str(tmp / "out.npy"), str(tmp),
         str(fonts)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (segs, meta, P), np.load(tmp / "out.npy"), tmp


@pytest.mark.parametrize("chunk", [1, 3, None, 1000])
def test_render_bitmaps_padded_matches_jax(jax_side, chunk):
    """Byte for byte over every glyph and every padded pixel, at chunks
    of 1 and 3 glyphs, the default budget and the whole block."""
    (segs, meta, P), want, _ = jax_side
    got = sdf_torch.render_bitmaps_padded(torch.from_numpy(segs), torch.from_numpy(meta), P,
                                          chunk=chunk)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # The empty soup's glyph: no segment, every byte 0.
    assert not got[9].any() and got[10:].any()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("command", ["merge", "recurse"])
def test_padded_cli_tree_matches_jax_cli(tmp_path, jax_side, command):
    _, _, tmp = jax_side
    fonts = tmp / "fonts"
    inputs = [str(fonts / "a.ttf"), str(fonts / "b.ttf")] if command == "merge" else [str(fonts)]
    torch_main([command, *inputs, "-o", str(tmp_path / "port"), "--renderer", "padded",
                "--device", "cpu"], stdout=io.BytesIO())
    want = _tree(tmp / command)
    got = _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([f for f in want if f.endswith(".pbf")]) >= 3
    for name in want:
        assert got[name] == want[name], name


def test_fit_render_padded_within_the_exact_contract(tmp_path):
    font = tmp_path / "curved.ttf"
    font.write_bytes(build_ttf_curved(6, 65, seed=1))
    base = ["fit", str(font), "--codepoints", "65-70", "--steps", "3", "--depth", "2",
            "--device", "cpu", "--backend", "flat", "--render"]
    torch_main(base + ["-o", str(tmp_path / "pad"), "--render-backend", "padded"],
               stdout=io.StringIO())
    torch_main(base + ["-o", str(tmp_path / "exact"), "--render-backend", "exact"],
               stdout=io.StringIO())
    got, want = _tree(tmp_path / "pad" / "glyphs"), _tree(tmp_path / "exact" / "glyphs")
    pbfs = sorted(f for f in want if f.endswith(".pbf"))
    assert sorted(got) == sorted(want) and pbfs
    n_pix = n_diff = 0
    for f in pbfs:
        a, b = decode_glyphs(got[f]), decode_glyphs(want[f])
        assert [(g.id, g.width, g.height, g.left, g.top, g.advance) for g in a] == [
            (g.id, g.width, g.height, g.left, g.top, g.advance) for g in b]
        for ga, gb in zip(a, b):
            if gb.bitmap is None:
                assert ga.bitmap is None
                continue
            d = np.abs(np.frombuffer(ga.bitmap, np.uint8).astype(int)
                       - np.frombuffer(gb.bitmap, np.uint8).astype(int))
            assert d.max(initial=0) <= 1
            n_pix += d.size
            n_diff += int((d > 0).sum())
    assert n_pix > 1000 and n_diff <= 0.05 * n_pix


def test_padded_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), ("cuda",)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer("padded", device=args[0] if args else None)
    assert Renderer("padded", device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("backend", ["cuda", "torch", "exact", "zeros", "auto"])
def test_device_is_refused_with_the_fixed_backends(tmp_path, backend):
    with pytest.raises(ValueError, match="fixed device"):
        Renderer(backend, device="cpu")
    font = tmp_path / "curved.ttf"
    font.write_bytes(build_ttf_curved(2, 65, seed=1))
    with pytest.raises(ValueError, match="fixed device"):
        torch_main(["merge", str(font), "-o", str(tmp_path / "out"), "--renderer", backend,
                    "--device", "cpu"], stdout=io.BytesIO())


def test_padded_session_places_each_add_in_order():
    """Each `add` renders its preps as one batch; results come back in
    add order, and an empty add changes nothing."""
    preps = _block_preps()
    r = Renderer("padded", device="cpu")
    with r.start_session() as s:
        s.add(preps[:4])
        s.add([])
        s.add(preps[4:])
        got = list(s.results())
    segs, meta, P = batch.pack_block(preps)
    whole = sdf_torch.render_bitmaps_padded(torch.from_numpy(segs), torch.from_numpy(meta), P)
    assert len(got) == len(preps)
    for g, (bm, p) in enumerate(zip(got, preps)):
        np.testing.assert_array_equal(bm, whole[g, : p.width * p.height].numpy())
