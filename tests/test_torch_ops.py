"""The port's device ops against the JAX package, on the CPU.

Same wire arrays (made once with numpy by the JAX packers) go through
the JAX function and its PyTorch counterpart. Every tolerance here is
exact: integer ops must be equal, and the f32 render must agree byte
for byte (same op order, every op separately rounded on both sides).
The CUDA kernel itself runs only on the card (`chip_smoke.py`); here
the wrappers take their plain versions because the tensors are on the
CPU.
"""

import jax
import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.font.entry import FontFileEntry
from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_pts_jax
from versatiles_glyphs_tpu.ops.sdf_pallas import (
    derive_tmeta as jax_derive_tmeta,
    reconstruct_delta_jit,
    render_bitmaps_pallas_delta,
)
from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu.render.driver import Renderer as JaxRenderer
from versatiles_glyphs_tpu.render.metrics import Q16_SCALE, GlyphPrep
from versatiles_glyphs_tpu.utils.synth_font import build_ttf
from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

TP = 256


@pytest.fixture(scope="module")
def preps():
    return curved_preps(10, 65, seed=3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_pts(preps, wire):
    """The JAX package's point array of a group on one wire, with its
    mask words and row-major tile table."""
    if wire == "i8":
        deltas, words, anchors, meta = jbatch.pack_points_delta(preps, arena_tag="_tops")
        q = np.asarray(reconstruct_delta_jit(deltas, anchors))
        pts = (q.astype(np.float32) * np.float32(1.0 / Q16_SCALE)).astype(np.float32)
    else:
        dt = np.int16 if wire == "i16" else np.float32
        pts, words, meta, _ = jbatch.pack_points(preps, dtype=dt, arena_tag="_tops")
    tmeta, starts, T = jbatch.plan_tiles(preps, meta, TP)
    return np.array(pts), np.array(words), np.array(tmeta), T


def _jax_render(pts, words, tmeta):
    L_max = jbatch.bucket(int(tmeta[:, 4].max()), jbatch.S_BUCKETS)
    return np.asarray(render_bitmaps_pts_jax(pts, words, tmeta, TP, L_max))


def test_reconstruct_delta_matches_jax(preps):
    deltas, _, anchors, _ = jbatch.pack_points_delta(preps, arena_tag="_tops")
    # Duplicate anchors must accumulate, like `.at[].add`.
    anchors = np.array(anchors)
    anchors[:, -1] = anchors[:, 1]
    want = np.asarray(reconstruct_delta_jit(deltas, anchors))
    got = sdf_torch.reconstruct_delta(_t(deltas), _t(anchors))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequantize_matches_jax(preps):
    q = np.array(jbatch.pack_points(preps, dtype=np.int16, arena_tag="_tops")[0])
    want = np.asarray(jax.numpy.asarray(q).astype(np.float32) * np.float32(1.0 / Q16_SCALE))
    got = sdf_torch.dequantize(_t(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "G_pad,T_pad",
    [
        (16, 64),  # zero meta rows and padding rows past the used tiles
        (None, None),  # G == G_pad, T_pad == the tiles used: no padding
        (None, 64),  # G == G_pad: padding repeats the last real glyph
        (16, 8),  # T_pad below the tiles: truncated like jnp.repeat
    ],
)
def test_derive_tmeta_matches_jax(preps, G_pad, T_pad):
    meta = np.array(jbatch.pack_points(preps, arena_tag="_tops")[2])
    G = len(preps)
    if G_pad is not None:
        meta_p = np.zeros((G_pad, 8), np.int32)
        meta_p[:G] = meta[:G]
        meta = meta_p
    if T_pad is None:
        T_pad = jbatch.tile_starts(meta, G, TP)[1]
    want = np.asarray(jax.jit(jax_derive_tmeta, static_argnums=(1, 2))(meta, TP, T_pad))
    got = sdf_torch.derive_tmeta(_t(meta), TP, T_pad)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, T_pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wire", ["i8", "i16", "f32"])
def test_render_tiles_matches_jax_twin(preps, wire):
    pts, words, tmeta, T = _jax_pts(preps, wire)
    want = _jax_render(pts, words, tmeta)
    got = sdf_cuda.render_bitmaps_cuda_pts(_t(pts), _t(words), _t(tmeta.T), TP)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:T].sum() > 0


def test_render_chunking_is_exact(preps, monkeypatch):
    """One tile per chunk gives the same bytes as one chunk of all."""
    pts, words, tmeta, _ = _jax_pts(preps, "f32")
    args = (_t(pts), _t(words), _t(tmeta.T), TP)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1 << 30)
    whole = sdf_torch.render_tiles_pts(*args)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1)
    np.testing.assert_array_equal(sdf_torch.render_tiles_pts(*args).numpy(), whole.numpy())


def test_render_delta_matches_pallas_interpret():
    """The real Pallas kernel, in interpret mode, on 4 synth glyphs."""
    entry = FontFileEntry(build_ttf(4, 65))
    preps = JaxRenderer("exact").prep_block([(65 + k, entry) for k in range(4)])
    deltas, words, anchors, meta = (
        np.array(a) for a in jbatch.pack_points_delta(preps, arena_tag="_tops")
    )
    want = np.asarray(
        render_bitmaps_pallas_delta(deltas, words, anchors, meta, TP, T_pad=16, interpret=True)
    )
    got = sdf_cuda.render_bitmaps_cuda_delta(
        _t(deltas), _t(words), _t(anchors), _t(meta), TP, T_pad=16
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_degenerate_segments_match_jax_twin():
    """Zero-length segments, horizontal (dy = 0) segments and masked
    ring ends."""
    segs = np.array(
        [
            [5.0, 5.0, 5.0, 5.0],  # zero length
            [5.0, 5.0, 15.0, 5.0],  # dy = 0
            [15.0, 5.0, 15.0, 15.0],
            [15.0, 15.0, 5.0, 15.0],  # dy = 0
            [5.0, 15.0, 5.0, 5.0],
            [9.5, 9.5, 9.5, 9.5],  # a point
        ]
    )
    p = GlyphPrep(codepoint=65, advance=20, empty=False, width=22, height=22,
                  x0=-1, y0=-1, x1=21, y1=21, segments=segs)
    ring = GlyphPrep(codepoint=66, advance=20, empty=False, width=20, height=20,
                     x0=0, y0=0, x1=20, y1=20,
                     rings_px=[np.array([[3.0, 3.0], [12.0, 3.0], [12.0, 12.0], [3.0, 3.0]]),
                               np.array([[6.0, 6.0], [6.0, 6.0], [7.0, 6.0]])])
    pts, words, tmeta, _ = _jax_pts([p, ring], "f32")
    want = _jax_render(pts, words, tmeta)
    got = sdf_torch.render_tiles_pts(_t(pts), _t(words), _t(tmeta.T), TP)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_count_no_launches(preps):
    sdf_cuda.reset_launches()
    pts, words, tmeta, _ = _jax_pts(preps, "i16")
    sdf_cuda.render_bitmaps_cuda_pts(_t(pts), _t(words), _t(tmeta.T), TP)
    assert not any(sdf_cuda.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["pts_dtype", "words_shape", "tmeta_dtype", "tp"])
def test_wrapper_rejects_bad_inputs(preps, bad):
    pts, words, tmeta, _ = _jax_pts(preps, "f32")
    args = {"pts": _t(pts), "mask_words": _t(words), "tmeta": _t(tmeta.T), "TP": TP}
    if bad == "pts_dtype":
        args["pts"] = args["pts"].double()
    elif bad == "words_shape":
        args["mask_words"] = args["mask_words"][:-1]
    elif bad == "tmeta_dtype":
        args["tmeta"] = args["tmeta"].long()
    else:
        args["TP"] = 100
    with pytest.raises(ValueError):
        sdf_cuda.render_bitmaps_cuda_pts(**args)
