"""The port's packers against `versatiles_glyphs_tpu.render.batch`.

The wire is the state that crosses between the two packages, so the
port's copies of the packers must return the JAX packers' arrays
exactly (tolerance: none). Outputs are copied before the next pack,
since both packers hand out reused arena buffers.
"""

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.font.entry import FontFileEntry
from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu.render.driver import Renderer as JaxRenderer
from versatiles_glyphs_tpu.utils.synth_font import build_ttf
from versatiles_glyphs_tpu_torch.render import batch as tbatch
from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

TP = 256


def _copy(t):
    return [np.array(a) for a in t]


@pytest.fixture(scope="module", params=["curved", "squares"])
def preps(request):
    if request.param == "curved":
        return curved_preps(12, 65, seed=5)
    entry = FontFileEntry(build_ttf(24, 65))
    return JaxRenderer("exact").prep_block([(65 + k, entry) for k in range(24)])


def test_constants_match():
    from versatiles_glyphs_tpu.ops.sdf_pallas import WINDOW_LANES

    assert tbatch.WINDOW_LANES == WINDOW_LANES
    assert tbatch.SC == jbatch.SC
    for name in ("S_BUCKETS", "N_BUCKETS", "T_BUCKETS", "K_BUCKETS"):
        assert getattr(tbatch, name) == getattr(jbatch, name)


@pytest.mark.parametrize("value", [1, 128, 129, 16384, 70000, 5_000_000])
def test_bucket_matches(value):
    for buckets in (tbatch.S_BUCKETS, tbatch.N_BUCKETS, tbatch.K_BUCKETS):
        assert tbatch.bucket(value, buckets) == jbatch.bucket(value, buckets)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("N_pad", [None, 65536])
def test_pack_points_matches(preps, dtype, N_pad):
    want = _copy(jbatch.pack_points(preps, N_pad=N_pad, dtype=dtype, arena_tag="_tb")[:3])
    got = _copy(tbatch.pack_points(preps, N_pad=N_pad, dtype=dtype, arena_tag="_tb"))
    N = sum(p.npts for p in preps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    # Lanes past the runs are stale by contract; compare the used ones.
    np.testing.assert_array_equal(got[0][:, :N], want[0][:, :N])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("N_pad", [None, 65536])
def test_pack_points_delta_matches(preps, N_pad):
    want = _copy(jbatch.pack_points_delta(preps, N_pad=N_pad, arena_tag="_tb"))
    got = _copy(tbatch.pack_points_delta(preps, N_pad=N_pad, arena_tag="_tb"))
    N = sum(p.npts for p in preps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[0][:, :N], want[0][:, :N])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("T_pad", [None, "used", 4096])
def test_plan_tiles_matches(preps, T_pad):
    meta = np.array(jbatch.pack_points(preps, arena_tag="_tb")[2])
    G = len(preps)
    starts_w, T_w = jbatch.tile_starts(meta, G, TP)
    starts_g, T_g = tbatch.tile_starts(meta, G, TP)
    np.testing.assert_array_equal(starts_g, starts_w)
    assert T_g == T_w
    pad = T_w if T_pad == "used" else T_pad
    want = _copy(jbatch.plan_tiles(preps, meta, TP, T_pad=pad)[:2])
    got = _copy(tbatch.plan_tiles(preps, meta, TP, T_pad=pad)[:2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plan_tiles_rejects_overflow(preps):
    meta = np.array(tbatch.pack_points(preps, arena_tag="_tb")[2])
    with pytest.raises(ValueError):
        tbatch.plan_tiles(preps, meta, TP, T_pad=1)


def test_packers_do_not_share_arena_buffers(preps):
    a = tbatch.pack_points(preps, arena_tag="_tb")[0]
    b = jbatch.pack_points(preps, arena_tag="_tb")[0]
    assert not np.shares_memory(a, b)


def test_wire_to_device_copies(preps):
    wire = tbatch.pack_points_delta(preps, arena_tag="_tb")
    tensors = tbatch.wire_to_device(wire, torch.device("cpu"))
    assert [t.dtype for t in tensors] == [torch.int8, torch.int32, torch.int32, torch.int32]
    for t, a in zip(tensors, wire):
        np.testing.assert_array_equal(t.numpy(), a)
        assert t.is_contiguous() and not np.shares_memory(t.numpy(), a)
    # A transposed table arrives contiguous.
    (tm,) = tbatch.wire_to_device((np.zeros((5, 8), np.int32).T,), torch.device("cpu"))
    assert tm.shape == (8, 5) and tm.is_contiguous()
