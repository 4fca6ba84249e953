"""The fused flat-fit loss (`ops.sdf_grad.FlatFitLoss`, `ops.flat_loss`):
its plain versions on the CPU against the unfused decomposition
(`models.fitting.flat_losses_reference`: PyTorch ops and autograd around
the min-field pair), and on the card its four kernels against their
plain versions.

The fused node sums in a fixed order of its own (a thread's strided
partial, then the block's partials pairwise), so against the reference's
sums it differs by round-off: 1e-6 of the largest magnitude of each
compared tensor. Against its own plain versions a kernel differs by
nothing.

Tests marked ``chip`` need a CUDA device and skip without one. On the
card, from the root of a checkout (this file imports no JAX, and the
suite's conftest does, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flat_loss.py -q
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu_torch.constants import SDF_RADIUS
from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.models.glyph_model import sdf_loss
from versatiles_glyphs_tpu_torch.ops import flat_loss, sdf_cuda
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

KEYS = fitting.PARAM_KEYS
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "versatiles_glyphs_tpu_torch", "csrc")
TP = 256


def _batch(n=6, seed=1, quads=8):
    return synth_fit_batch(n, 65, seed=seed, quads=quads, perturb=0.3)


def _setup(batch, depth, device="cpu", devices=None, moved=True):
    """(fitter, params, device batch), the parameters moved off the start
    (translate and log_gain non-zero) where ``moved``."""
    kw = {"devices": devices} if devices else {"device": device}
    fitter = fitting.FontFitter(depth=depth, backend="flat", **kw)
    params, _, db = fitter.init(batch)
    if moved:
        rng = np.random.default_rng(3)
        with torch.no_grad():
            params["translate"].add_(torch.from_numpy(
                rng.normal(0, 0.3, tuple(params["translate"].shape)).astype(np.float32)
            ).to(params["translate"].device))
            params["log_gain"].fill_(0.05)
    return fitter, params, db


def _close(got, want, what, rel=1e-6):
    """Within ``rel`` of ``want``'s largest magnitude."""
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: {err} against {scale}"


def _reference(params, db, batch, depth):
    plan = fitting.build_flat_plan(batch.curve_mask, batch.meta, depth, batch.target.shape[1])
    padded = fitting.padded_batch(batch, params["curves"].device)
    losses = fitting.flat_losses_reference(params, db, padded, plan, depth)
    loss = torch.mean(losses)
    return losses, loss, torch.autograd.grad(loss, [params[k] for k in KEYS])


def _fused_chain(db):
    """`flat_chain_points` as the fused chain computes it (its plain
    version, under autograd): the reference at the fused node's points."""
    N = db["plan_words"].shape[0] * 32
    return lambda c, t, depth, chunk_map: flat_loss.chain_fwd_plain(
        c, t, flat_loss.bernstein_matrix(depth, c.device), chunk_map, db["glyph_rows"], N)


@pytest.mark.parametrize("depth,n,seed,quads", [(2, 6, 1, 8), (3, 9, 4, 12), (3, 5, 7, 24)])
def test_fused_matches_reference(monkeypatch, depth, n, seed, quads):
    """Per-glyph losses, the mean and the gradients of ``curves``,
    ``translate`` and ``log_gain`` against the decomposition's autograd
    at the same chain points, within 1e-6: the sums' order alone
    differs. Against the decomposition's own chain (an einsum, summed in
    another order), the losses within 1e-6 and the gradients within
    1e-4, as against the JAX package: a chain point's round-off moves a
    pixel's q = p − (v + tc·d) by ~1e-6 px, a large share of it where
    the pixel lies on the curve."""
    batch = _batch(n, seed, quads)
    fitter, p, db = _setup(batch, depth)
    losses = fitting._flat_losses(p, db, depth, TP)
    assert type(losses.grad_fn).__name__ == "FlatFitLossBackward"
    loss, grads = fitter.value_and_grad(p, db)
    own_losses, own_loss, own_grads = _reference(p, db, batch, depth)
    monkeypatch.setattr(fitting, "flat_chain_points", _fused_chain(db))
    want_losses, want_loss, want_grads = _reference(p, db, batch, depth)
    for got, want, own, what in ((losses, want_losses, own_losses, "losses"),
                                 (loss, want_loss, own_loss, "loss")):
        _close(got, want, what)
        _close(got, own, what)
    for k, w, own in zip(KEYS, want_grads, own_grads):
        assert grads[k].shape == w.shape
        _close(grads[k], w, k)
        _close(grads[k], own, k, rel=1e-4)


def test_sharded_sum_matches_one_device_mean():
    """Over two CPU stand-ins the shards' sums over B equal the one-device
    mean, and the gradients its gradients, up to round-off; the padded
    glyph (5 glyphs over 2 shards) adds nothing."""
    batch = _batch(5, seed=2)
    one, p1, d1 = _setup(batch, 3)
    sh, ps, ds = _setup(batch, 3, devices=["cpu", "cpu"])
    with torch.no_grad():
        for k in KEYS:
            ps[k].copy_(torch.cat([p1[k], ps[k][5:]]) if ps[k].dim() else p1[k])
    l1, g1 = one.value_and_grad(p1, d1)
    ls, gs = sh.value_and_grad(ps, ds)
    _close(ls, l1, "loss")
    for k in KEYS:
        got = gs[k][:5] if gs[k].dim() else gs[k]
        _close(got, g1[k], k)
        if gs[k].dim():
            assert not gs[k][5:].any(), k


def _pixels(d2, wn, target, log_gain=0.0):
    """Device-batch pieces of one glyph of len(d2) pixels in one tile row,
    and two padding rows."""
    n = len(d2)
    field = torch.zeros((3, TP))
    field[0, :n] = torch.tensor(d2, dtype=torch.float32)
    winding = torch.zeros((3, TP), dtype=torch.int32)
    winding[0, :n] = torch.tensor(wn, dtype=torch.int32)
    tiles = torch.zeros((3, TP))
    tiles[0, :n] = torch.tensor(target, dtype=torch.float32)
    rows = torch.tensor([[0, n, 0, 9]], dtype=torch.int32)
    return field, winding, tiles, rows, torch.tensor(log_gain)


def test_clip_tie_gets_half_gradient():
    """A prediction exactly at ±SDF_RADIUS gets half the gradient, one
    beyond none, one inside all: the gradients of `torch.minimum` and
    `torch.maximum` at equality, as the reference's clip has them."""
    r = SDF_RADIUS
    d2 = [r * r, r * r, (r + 1) ** 2, (r - 1) ** 2, 0.25]
    wn = [0, 1, 0, 1, 0]
    target = [0.0, 0.0, 0.0, 0.0, -0.5]
    field, winding, tiles, rows, lg = _pixels(d2, wn, target)
    n = len(d2)
    ct_d2, part = flat_loss.loss_bwd_plain(torch.tensor([float(n)]), field, winding, tiles,
                                           rows, lg, TP)  # each pixel's term: cotangent 1
    sd = torch.tensor([r, -r, r + 1, -(r - 1), 0.5])
    full = 2 * (torch.clamp(sd, -r, r) - torch.tensor(target))
    dpred = full * torch.tensor([0.5, 0.5, 0.0, 1.0, 1.0])
    want = dpred * torch.sign(sd) * (0.5 / sd.abs())
    np.testing.assert_array_equal(ct_d2[0, :n].numpy(), want.numpy())
    assert not ct_d2[:, n:].any() and not ct_d2[1:].any()
    # The reference's clip under autograd gives the same halves.
    pred = sd.clone().requires_grad_()
    loss = sdf_loss(pred[None], torch.tensor([target]), torch.ones(1, n)).sum() * n
    (g,) = torch.autograd.grad(loss, pred)
    np.testing.assert_array_equal(g.numpy(), dpred.numpy())
    assert float(part[0]) == float((dpred * sd).sum())


def test_padding_tiles_and_dead_lanes_carry_zero():
    """The chain's dead lanes (past a glyph's chain, slack chunks) are 0;
    the cotangent of d² is 0 past each glyph's w·h and on the table's
    padding rows; curves past a glyph's chain get 0 gradient, and so do
    the padded glyph of a sharded batch."""
    depth = 3
    batch = _batch(7, seed=5, quads=12)
    _, p, db = _setup(batch, depth)
    rows = db["glyph_rows"].long()
    N = db["plan_words"].shape[0] * 32
    pts = flat_loss.chain_fwd_plain(p["curves"].detach(), p["translate"].detach(),
                                    flat_loss.bernstein_matrix(depth, torch.device("cpu")),
                                    db["chunk_map"], db["glyph_rows"], N)
    live = torch.zeros(N, dtype=torch.bool)
    for lane0, npts in rows[:, 2:].tolist():
        live[lane0 : lane0 + npts] = True
    assert not pts[:, ~live].any() and pts[:, live].any()
    T_pad = db["plan_tmeta"].shape[1]
    T = int(rows[-1, 0] + max(1, -(-int(rows[-1, 1]) // TP)))
    assert T < T_pad  # the table has padding rows
    field = torch.rand(T_pad, TP) * 30
    winding = (torch.rand(T_pad, TP) < 0.3).to(torch.int32)
    ct = torch.rand(rows.shape[0]) + 0.5
    ct_d2, _ = flat_loss.loss_bwd_plain(ct, field, winding, db["target_tiles"], db["glyph_rows"],
                                        p["log_gain"].detach(), TP)
    owned = torch.zeros(T_pad * TP, dtype=torch.bool)
    for tile0, npix in rows[:, :2].tolist():
        owned[tile0 * TP : tile0 * TP + npix] = True
    flat = ct_d2.reshape(-1)
    assert not flat[~owned].any() and flat[owned].any()
    dpts = torch.rand(2, N)
    dcurves, _, _ = flat_loss.chain_bwd_plain(dpts, flat_loss.bernstein_matrix(
        depth, torch.device("cpu")), db["glyph_rows"], p["curves"].shape[1],
        torch.zeros(rows.shape[0]), p["log_gain"].detach())
    ncurves = torch.as_tensor(batch.curve_mask.sum(1))
    beyond = torch.arange(p["curves"].shape[1])[None, :] >= ncurves[:, None]
    assert beyond.any() and not dcurves[beyond].any() and dcurves[~beyond].any()
    sh, ps, ds = _setup(batch, depth, devices=["cpu", "cpu"], moved=False)
    _, gs = sh.value_and_grad(ps, ds)
    assert ps["curves"].shape[0] == 8
    assert not gs["curves"][7:].any() and not gs["translate"][7:].any()


def test_finite_differences():
    """The fused node's gradient against a central difference of its
    loss along a random direction (loose: the hard min has kinks)."""
    depth = 2
    fitter, p, db = _setup(_batch(4, seed=9), depth)
    _, grads = fitter.value_and_grad(p, db)
    rng = np.random.default_rng(21)
    v = {k: torch.from_numpy(rng.normal(size=tuple(p[k].shape)).astype(np.float32)) for k in KEYS}
    norm = float(torch.sqrt(sum((x * x).sum() for x in v.values())))
    eps = 1e-2
    with torch.no_grad():
        lp = fitter.loss({k: p[k] + eps * v[k] / norm for k in KEYS}, db)
        lm = fitter.loss({k: p[k] - eps * v[k] / norm for k in KEYS}, db)
    fd = float(lp - lm) / (2 * eps)
    an = float(sum((grads[k] * v[k] / norm).sum() for k in KEYS))
    assert abs(fd - an) < 0.1 * max(abs(fd), 1e-3), (fd, an)


def test_chain_matches_flat_chain_points():
    """Live lanes within 1e-6 of `flat_chain_points` (the einsum sums in
    another order), chain ends equal to control point + translate bit for
    bit."""
    depth = 3
    _, p, db = _setup(_batch(6, seed=11), depth)
    c, t = p["curves"].detach(), p["translate"].detach()
    N = db["plan_words"].shape[0] * 32
    pts = flat_loss.chain_fwd_plain(c, t, flat_loss.bernstein_matrix(depth, torch.device("cpu")),
                                    db["chunk_map"], db["glyph_rows"], N)
    want = fitting.flat_chain_points(c, t, depth, db["chunk_map"])
    K = (1 << depth) + 1
    for g, (lane0, npts) in enumerate(db["glyph_rows"][:, 2:].tolist()):
        got = pts[:, lane0 : lane0 + npts]
        _close(got, want[:, lane0 : lane0 + npts], f"glyph {g}")
        q = (c[g] + t[g]).reshape(-1, 4, 2)[: npts // K]
        np.testing.assert_array_equal(got[:, 0::K].T.numpy(), q[:, 0].numpy())
        np.testing.assert_array_equal(got[:, K - 1 :: K].T.numpy(), q[:, 3].numpy())


def test_fitted_atlas_chain_is_the_fit_chain():
    """`models.render_fitted.fit_chain`, the outline a fitted atlas
    renders, is the fused chain's live lanes of each glyph bit for bit."""
    from versatiles_glyphs_tpu_torch.models.render_fitted import fit_chain

    depth = 3
    batch = _batch(6, seed=11)
    _, p, db = _setup(batch, depth)
    c, t = p["curves"].detach(), p["translate"].detach()
    N = db["plan_words"].shape[0] * 32
    pts = flat_loss.chain_fwd_plain(c, t, flat_loss.bernstein_matrix(depth, torch.device("cpu")),
                                    db["chunk_map"], db["glyph_rows"], N)
    for g, (lane0, npts) in enumerate(db["glyph_rows"][:, 2:].tolist()):
        live = batch.curve_mask[g]
        got = fit_chain(c[g].numpy()[live], t[g].numpy(), depth).reshape(-1, 2)
        assert got.shape[0] == npts
        np.testing.assert_array_equal(got, pts[:, lane0 : lane0 + npts].T.double().numpy())


def test_fixed_sums_follow_the_kernel_order():
    """`_strided_sum` then `_block_sum` is the kernels' order: a thread's
    values t, t + 256, ... from 0 in order, then halves added pairwise,
    each add one f32 rounding (a loop in numpy f32 gives its bits)."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 4 * flat_loss.THREADS)) * 10.0 ** rng.integers(-6, 6, (3, 1024)))
    x = x.astype(np.float32)
    got = flat_loss._block_sum(flat_loss._strided_sum(torch.from_numpy(x))).numpy()
    for row, g in zip(x, got):
        part = np.zeros(flat_loss.THREADS, np.float32)
        for k in range(0, row.size, flat_loss.THREADS):
            part = (part + row[k : k + flat_loss.THREADS]).astype(np.float32)
        s = flat_loss.THREADS
        while s > 1:
            s //= 2
            part = (part[:s] + part[s : 2 * s]).astype(np.float32)
        assert part[0].view(np.int32) == np.float32(g).view(np.int32)


def test_target_tiles_and_glyph_rows():
    """`tile_target` puts glyph g's pixel i at row tstart_g + i // TP,
    slot i % TP; `glyph_rows` holds tstart, w·h, the lane run's start and
    its chain points, as the tile table's rows say."""
    batch = _batch(7, seed=5, quads=12)
    plan = fitting.build_flat_plan(batch.curve_mask, batch.meta, 3, batch.target.shape[1])
    tiles = fitting.tile_target(plan, batch.target).reshape(-1)
    for g, (tile0, npix, lane0, npts) in enumerate(plan.glyph_rows.tolist()):
        np.testing.assert_array_equal(tiles[tile0 * TP : tile0 * TP + npix],
                                      batch.target[g, :npix])
        row = plan.tmeta[tile0]
        assert (row[2] * row[3], row[4], row[5], row[6]) == (npix, npts, lane0, 0)
    assert np.array_equal(plan.glyph_rows[:, 0], plan.row_map[:, 0])


def test_check_plan_refuses_a_broken_table():
    _, _, db = _setup(_batch(4, seed=1), 3, moved=False)
    C = _batch(4, seed=1).curve_mask.shape[1]
    flat_loss.check_plan(db, C, 9, TP)
    for key, fix in (("glyph_rows", lambda r: r.__setitem__((1, 0), 99)),
                     ("glyph_rows", lambda r: r.__setitem__((0, 3), 10**6)),
                     ("chunk_map", lambda m: m.__setitem__(0, 10**6))):
        bad = dict(db)
        bad[key] = db[key].clone()
        fix(bad[key])
        with pytest.raises(ValueError, match="leaves the plan"):
            flat_loss.check_plan(bad, C, 9, TP)
    with pytest.raises(ValueError, match="target_tiles"):
        flat_loss.check_plan({**db, "target_tiles": db["target_tiles"][:-1]}, C, 9, TP)


def _extern_params(name: str) -> int:
    """Parameters of ``csrc/<name>.cu``'s extern "C" entry point."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int vg_' + name + r"\((.*?)\)\s*\{", src, re.S)
    return len(m[1].split(","))


def test_kernels_registered_with_their_signatures_and_constants():
    """The four kernels count launches like every other (`sdf_cuda.KERNELS`),
    their ctypes signatures have their C entry points' arity, and the
    Python constants are the header's."""
    assert set(flat_loss.KERNELS) <= set(sdf_cuda.KERNELS)
    assert set(flat_loss.STEP_KERNELS) == {*flat_loss.KERNELS, "sdf_min_field_pts",
                                           "sdf_min_field_bwd"}
    for name in flat_loss.KERNELS:
        symbol, argtypes = sdf_cuda._SIGNATURES[name]
        assert symbol == f"vg_{name}" and _extern_params(name) == len(argtypes), name
    with open(os.path.join(CSRC, "flat_loss.cuh")) as f:
        cuh = f.read()
    assert f"kThreads = {flat_loss.THREADS};" in cuh
    assert f"kLaneChunk = {flat_loss.LANE_CHUNK};" in cuh
    assert f"kRadius = {SDF_RADIUS:.1f}f;" in cuh
    assert f"kD2Floor = {flat_loss.D2_FLOOR!r}f;" in cuh


def test_cpu_runs_no_kernel():
    """On the CPU a step of the fused loss counts no launch."""
    fitter, p, db = _setup(_batch(4), 2)
    sdf_cuda.reset_launches()
    fitter.value_and_grad(p, db)
    assert not any(sdf_cuda.LAUNCHES.values())


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _smoke_batch():
    """`chip_smoke.py`'s fit batch: every glyph of the text font."""
    return synth_fit_batch(1700, 32, seed=0, quads=8, perturb=0.35)


def _bits_equal(got, want, what):
    got = got.detach().cpu().contiguous()
    want = want.detach().cpu().contiguous()
    assert got.shape == want.shape, what
    n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert n == 0, f"{what}: {n} values differ in their bits"


@pytest.mark.chip
def test_kernels_equal_plain_on_the_card(card):
    """Each of the four kernels on the smoke's fit batch (depth 3, moved
    translate and log_gain) against its plain version on CPU copies of
    the same inputs, bit for bit; each launches once."""
    depth = 3
    _, p, db = _setup(_smoke_batch(), depth, device=card)
    cpu = {k: v.cpu() for k, v in db.items()}
    bern = flat_loss.bernstein_matrix(depth, card)
    c, t, lg = p["curves"].detach(), p["translate"].detach(), p["log_gain"].detach()
    N = db["plan_words"].shape[0] * 32
    sdf_cuda.reset_launches()
    pts = flat_loss.chain_fwd(c, t, bern, db["chunk_map"], db["glyph_rows"], N)
    _bits_equal(pts, flat_loss.chain_fwd_plain(c.cpu(), t.cpu(), bern.cpu(), cpu["chunk_map"],
                                               cpu["glyph_rows"], N), "flat_chain_fwd")
    d2, wn, am = sdf_cuda.launch_min_field_pts(pts, db["plan_words"], db["plan_tmeta"], TP)
    losses = flat_loss.loss_fwd(d2, wn, db["target_tiles"], db["glyph_rows"], lg, TP)
    _bits_equal(losses, flat_loss.loss_fwd_plain(d2.cpu(), wn.cpu(), cpu["target_tiles"],
                                                 cpu["glyph_rows"], lg.cpu(), TP), "flat_loss_fwd")
    B = c.shape[0]
    gen = torch.Generator().manual_seed(3)
    for ct in (torch.rand(B, generator=gen) / B, torch.full((), 1.0 / B).expand(B)):
        got = flat_loss.loss_bwd(ct.to(card), d2, wn, db["target_tiles"], db["glyph_rows"], lg, TP)
        want = flat_loss.loss_bwd_plain(ct, d2.cpu(), wn.cpu(), cpu["target_tiles"],
                                        cpu["glyph_rows"], lg.cpu(), TP)
        for g, w, name in zip(got, want, ("ct_d2", "gain_part")):
            _bits_equal(g, w, f"flat_loss_bwd {name} (stride {ct.stride(0)})")
    ct_d2, part = got
    dpts = sdf_cuda.launch_min_field_bwd(pts, am, ct_d2, db["plan_tmeta"], TP)
    got = flat_loss.chain_bwd(dpts, bern, db["glyph_rows"], c.shape[1], part, lg)
    want = flat_loss.chain_bwd_plain(dpts.cpu(), bern.cpu(), cpu["glyph_rows"], c.shape[1],
                                     part.cpu(), lg.cpu())
    for g, w, name in zip(got, want, ("dcurves", "dtranslate", "dlog_gain")):
        _bits_equal(g, w, f"flat_chain_bwd {name}")
    torch.cuda.synchronize()
    assert {k: sdf_cuda.LAUNCHES[k] for k in flat_loss.KERNELS} == {
        "flat_chain_fwd": 1, "flat_loss_fwd": 1, "flat_loss_bwd": 2, "flat_chain_bwd": 1}
    sdf_cuda.reset_launches()


@pytest.mark.chip
def test_graph_replays_are_bit_equal_and_equal_eager(card):
    """Two replays of the step's graph give the same loss and gradients
    bit for bit, equal to an eager forward and backward at the same
    parameters; a replay runs each of the step's six kernels once."""
    depth = 3
    fitter, p, db = _setup(_smoke_batch(), depth, device=card)
    graph = fitting.StepGraph(fitter._loss, p, db)
    assert {k: v for k, v in graph.launches.items() if v} == dict.fromkeys(
        flat_loss.STEP_KERNELS, 1)
    sdf_cuda.reset_launches()

    def replay():
        loss, grads = graph.replay()
        return [loss.clone(), *(g.clone() for g in grads)]

    first, second = replay(), replay()
    torch.cuda.synchronize()
    assert {k: v for k, v in sdf_cuda.LAUNCHES.items() if v} == dict.fromkeys(
        flat_loss.STEP_KERNELS, 2)
    loss, grads = fitter.value_and_grad(p, db)
    for a, b, e, name in zip(first, second, (loss, *(grads[k] for k in KEYS)), ("loss", *KEYS)):
        _bits_equal(a, b, f"replays: {name}")
        _bits_equal(a, e, f"graph against eager: {name}")
    sdf_cuda.reset_launches()


@pytest.mark.chip
def test_fused_matches_reference_on_the_card(card, monkeypatch):
    """On the card, the fused loss against the decomposition's autograd
    (the reference, itself through kernels 2 and 3) as on the CPU: at the
    same chain points within 1e-6, at its own chain (cuBLAS's einsum)
    the gradients within 1e-4; and the sharded step over the card listed
    twice against one device."""
    depth = 3
    batch = _smoke_batch()
    fitter, p, db = _setup(batch, depth, device=card)
    losses = fitting._flat_losses(p, db, depth, TP)
    loss, grads = fitter.value_and_grad(p, db)
    own_losses, own_loss, own_grads = _reference(p, db, batch, depth)
    monkeypatch.setattr(fitting, "flat_chain_points", _fused_chain(db))
    want_losses, want_loss, want_grads = _reference(p, db, batch, depth)
    for got, want, own, what in ((losses, want_losses, own_losses, "losses"),
                                 (loss, want_loss, own_loss, "loss")):
        _close(got, want, what)
        _close(got, own, what)
    for k, w, own in zip(KEYS, want_grads, own_grads):
        _close(grads[k], w, k)
        _close(grads[k], own, k, rel=1e-4)
    half = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:851]
                                         for f in dataclasses.fields(batch)})
    one, p1, d1 = _setup(half, depth, device=card)
    sh, ps, ds = _setup(half, depth, devices=[card, card])
    with torch.no_grad():
        for k in KEYS:
            ps[k].copy_(torch.cat([p1[k], ps[k][851:]]) if ps[k].dim() else p1[k])
    l1, g1 = one.value_and_grad(p1, d1)
    ls, gs = sh.value_and_grad(ps, ds)
    _close(ls, l1, "sharded loss")
    for k in KEYS:
        _close(gs[k][:851] if gs[k].dim() else gs[k], g1[k], f"sharded {k}")
