"""The fitter's Adam update (`ops.adam`): its plain version on the CPU,
and on the card the kernel ``csrc/adam_flat.cu`` against it.

The plain version computes `torch.optim.Adam`'s single-tensor formula
in f32 with each operation rounded once, which the kernel reproduces bit
for bit. ATen's CPU lerp fuses its multiply and add, so against
``opt.step()`` on the CPU the plain version is held to a tolerance: 4
f32 ulps of each leaf's largest magnitude, and for the first moment of
its gradient's too (the lerp's terms, whose sum may cancel).

Tests marked ``chip`` need a CUDA device and skip without one. On the
card, from the root of a checkout (this file imports no JAX, and the
suite's conftest does, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam.py -q
"""

import types

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.ops import adam, sdf_cuda
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

DEPTH = 2
KEYS = fitting.PARAM_KEYS
ULPS = 4


def _batch():
    return synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)


def _state(opt, p):
    s = opt.state[p]
    return s["exp_avg"], s["exp_avg_sq"]


def _within_ulps(want, got, what, terms=()):
    """``got`` within `ULPS` f32 ulps of the largest magnitude of
    ``want`` and of ``terms`` (what the update adds into it)."""
    want, got = want.detach().double(), got.detach().double()
    big = max(float(t.detach().abs().max()) for t in (want, *terms))
    scale = np.finfo(np.float32).eps * max(big, np.finfo(np.float32).tiny)
    err = float((want - got).abs().max())
    assert err <= ULPS * scale, f"{what}: {err / scale:.2f} ulps"


def _resume(start, fitter, tmp_path, like):
    """Bring ``like = (params, opt)`` to the start named ``start``: a
    fresh init, a checkpoint after 5 `torch.optim.Adam` steps, or an
    optax state after 5 steps (count, mu, nu as numpy)."""
    if start == "fresh":
        return
    params, opt = like
    if start == "checkpoint":
        p0, o0, d0 = fitter.init(_batch())
        for _ in range(5):
            o0.zero_grad(set_to_none=True)
            fitter.loss(p0, d0).backward()
            o0.step()
        path = str(tmp_path / "ckpt")
        fitting.FontFitter.save_checkpoint(path, p0, o0)
        fitting.FontFitter.restore_checkpoint(path, like=like)
    else:
        rng = np.random.default_rng(7)
        shapes = {k: tuple(params[k].shape) for k in KEYS}
        state = types.SimpleNamespace(
            count=np.asarray(5, np.int32),
            mu={k: rng.normal(0, 0.05, shapes[k]).astype(np.float32) for k in KEYS},
            nu={k: rng.uniform(0, 0.01, shapes[k]).astype(np.float32) for k in KEYS},
        )
        opt.load_state_dict(fitting.adam_state_from_optax((state,), opt))


@pytest.mark.parametrize("backend", ["flat", "torch"])
@pytest.mark.parametrize("start", ["fresh", "checkpoint", "optax"])
def test_plain_adam_follows_torch_adam(backend, start, tmp_path):
    """20 steps of `adam_step` against 20 of ``opt.step()`` on the same
    gradients: the parameters and both moments within the tolerance at
    every step, and the state of the same form (a CPU ``step`` equal to
    torch's), from the first step's state, a checkpoint and an optax
    state."""
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, device="cpu")
    p1, o1, d1 = fitter.init(_batch())
    p2, o2, _ = fitter.init(_batch())
    _resume(start, fitter, tmp_path, (p1, o1))
    _resume(start, fitter, tmp_path, (p2, o2))
    for i in range(20):
        o1.zero_grad(set_to_none=True)
        fitter.loss(p1, d1).backward()
        for k in KEYS:
            p2[k].grad = p1[k].grad.clone()
        o1.step()
        adam.adam_step(o2)
        for k in KEYS:
            _within_ulps(p1[k], p2[k], f"{k} at step {i}")
            (m1, v1), (m2, v2) = _state(o1, p1[k]), _state(o2, p2[k])
            _within_ulps(m1, m2, f"{k} m at step {i}", (p1[k].grad,))
            _within_ulps(v1, v2, f"{k} v at step {i}")
            s1, s2 = o1.state[p1[k]]["step"], o2.state[p2[k]]["step"]
            assert s2.device.type == "cpu" and s2.dtype == s1.dtype and s2.shape == ()
            assert float(s2) == float(s1)


@pytest.mark.parametrize("beta1", [0.9, 0.3])
def test_plain_update_rounds_each_op_once(beta1):
    """`adam_update_plain` gives the bits of the formula computed op by
    op in numpy f32 (one rounding an op, the kernel's intrinsics), on
    both branches of the lerp (w = 1 − β1 below and above 0.5)."""
    rng = np.random.default_rng(3)
    n = 4099
    p = rng.normal(0, 10, n).astype(np.float32)
    g = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-12, 3, n)).astype(np.float32)
    m = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-12, 2, n)).astype(np.float32)
    v = np.abs(rng.normal(0, 1, n) * 10.0 ** rng.integers(-20, 2, n)).astype(np.float32)
    g[:4], m[:4], v[:4] = 0.0, 0.0, 0.0
    sc = adam.step_scalars(0.01, (beta1, 0.999), 1e-8, 7.0)
    w, omw, b2, c2, bc2s, eps, ns = sc
    d = g - m
    m_want = m + w * d if abs(w) < 0.5 else g - d * omw
    v_want = v * b2 + (c2 * g) * g
    p_want = p + (ns * m_want) / (np.sqrt(v_want) / bc2s + eps)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    adam.adam_update_plain(tp, torch.from_numpy(g), tm, tv, sc)
    for want, got in ((p_want, tp), (m_want, tm), (v_want, tv)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_step_scalars_are_torch_adams():
    """The seven scalars at step 3: torch's doubles, rounded to f32."""
    got = adam.step_scalars(0.01, (0.9, 0.999), 1e-8, 3.0)
    want = [0.1, np.float32(1) - np.float32(0.1), 0.999, 1 - 0.999, (1 - 0.999**3) ** 0.5,
            1e-8, -(0.01 / (1 - 0.9**3))]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("bad", ["amsgrad", "maximize", "weight_decay", "capturable", "f64"])
def test_adam_step_refuses_what_it_does_not_compute(bad):
    """Options the update does not compute raise before any state or
    parameter changes: nothing falls back to ``opt.step()``."""
    dtype = torch.float64 if bad == "f64" else torch.float32
    p = torch.ones(5, dtype=dtype, requires_grad=True)
    kw = {"weight_decay": 0.1} if bad == "weight_decay" else {bad: True} if bad != "f64" else {}
    opt = torch.optim.Adam([p], lr=0.01, **kw)
    p.grad = torch.ones_like(p)
    with pytest.raises(ValueError):
        adam.adam_step(opt)
    assert not opt.state and torch.equal(p.detach(), torch.ones(5, dtype=dtype))


def test_fitter_never_calls_torch_adam_step(monkeypatch):
    """`FontFitter.step` and the graphed steps' decomposition step Adam
    through `adam_step` alone, and leave no gradient behind."""

    def refuse(*a, **k):
        raise AssertionError("torch.optim.Adam.step called")

    monkeypatch.setattr(torch.optim.Adam, "step", refuse)
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    p, o, d = fitter.init(_batch())
    fitter.step(p, o, d)
    fitter._graphed_steps(p, o, d, 2)
    assert all(float(o.state[p[k]]["step"]) == 3 for k in KEYS)
    assert all(p[k].grad is None for k in KEYS)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# Leaf shapes: the fit cell's (1,686 glyphs, 16 curves), ragged counts
# (n % 4 != 0, one element), one leaf, and more leaves than one launch
# takes.
CARD_CASES = {
    "fit_cell": [(1686, 16, 4, 2), (1686, 2), ()],
    "ragged": [(1001,), (3,), (7, 5), ()],
    "one_leaf": [(257, 3)],
    "many_leaves": [(i + 1, 3) for i in range(adam.MAX_LEAVES + 3)],
}


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("beta1", [0.9, 0.3])
def test_kernel_equals_plain_on_the_card(card, case, beta1):
    """Five steps of `adam_step` on the card (the kernel) against the
    plain version on CPU copies of the same leaves and gradients, bit
    for bit: parameters and both moments; one launch a step up to
    `MAX_LEAVES` leaves. A leaf at an odd offset takes the element path."""
    rng = np.random.default_rng(11)
    shapes = CARD_CASES[case]
    host = [torch.from_numpy(rng.normal(0, 5, s).astype(np.float32)) for s in shapes]
    on_card = [t.to(card) for t in host]
    if case == "ragged":  # not 16-byte aligned: a view one element in
        on_card[0] = torch.empty(host[0].numel() + 1, device=card)[1:].view(host[0].shape)
        on_card[0].copy_(host[0])
    on_card = [t.requires_grad_() for t in on_card]
    on_cpu = [t.clone().requires_grad_() for t in host]
    o_card = torch.optim.Adam(on_card, lr=0.01, betas=(beta1, 0.999))
    o_cpu = torch.optim.Adam(on_cpu, lr=0.01, betas=(beta1, 0.999))
    sdf_cuda.reset_launches()
    for _ in range(5):
        grads = [torch.from_numpy(np.asarray(rng.normal(0, 1, s) * 10.0 ** rng.integers(-8, 2, s),
                                             np.float32)) for s in shapes]
        for pc, pg, g in zip(on_cpu, on_card, grads):
            pc.grad, pg.grad = g, g.to(card)
        adam.adam_step(o_cpu)
        adam.adam_step(o_card)
    torch.cuda.synchronize()
    assert sdf_cuda.LAUNCHES["adam_flat"] == 5 * -(-len(shapes) // adam.MAX_LEAVES)
    sdf_cuda.reset_launches()
    for pc, pg in zip(on_cpu, on_card):
        for want, got in ((pc, pg), *zip(_state(o_cpu, pc), _state(o_card, pg))):
            np.testing.assert_array_equal(got.detach().cpu().numpy().view(np.int32),
                                          want.detach().numpy().view(np.int32))
        assert o_card.state[pg]["step"].device.type == "cpu"


@pytest.mark.chip
def test_step_many_launches_adam_once_a_step(card):
    """Through `step_many` on the card, one ``adam_flat`` launch a step
    and no call of ``torch.optim.Adam.step``."""
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device=card)
    p, o, d = fitter.init(_batch())
    fitter.step_many(p, o, d, 2)  # captures the graph
    sdf_cuda.reset_launches()
    fitter.step_many(p, o, d, 7)
    torch.cuda.synchronize()
    assert sdf_cuda.LAUNCHES["adam_flat"] == 7
    assert sdf_cuda.LAUNCHES["sdf_min_field_pts"] == sdf_cuda.LAUNCHES["sdf_min_field_bwd"] == 7
    sdf_cuda.reset_launches()


@pytest.mark.chip
@pytest.mark.parametrize("backend", ["flat", "torch"])
def test_step_many_equals_step_on_the_card(card, backend):
    """10 graphed steps equal 10 `step` calls on the card bit for bit:
    losses, parameters and Adam's state."""
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, device=card)
    p1, o1, d1 = fitter.init(_batch())
    want = torch.stack([fitter.step(p1, o1, d1)[2] for _ in range(10)]).cpu().numpy()
    p2, o2, d2 = fitter.init(_batch())
    _, _, got = fitter.step_many(p2, o2, d2, 10)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for k in KEYS:
        for a, b in ((p1[k], p2[k]), *zip(_state(o1, p1[k]), _state(o2, p2[k]))):
            np.testing.assert_array_equal(a.detach().cpu().numpy().view(np.int32),
                                          b.detach().cpu().numpy().view(np.int32))
        assert float(o1.state[p1[k]]["step"]) == float(o2.state[p2[k]]["step"]) == 10
