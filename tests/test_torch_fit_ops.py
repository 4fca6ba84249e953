"""The fitting path's device ops of the port against the JAX package, on
the CPU: the min field (TPU kernel 2), its backward reduction (TPU
kernel 3) and `ops.sdf_grad.signed_field_flat`.

The wrappers of `ops.sdf_cuda` take their plain versions here because
the tensors lie on the CPU; the CUDA kernels are held against those on
the card by `chip_smoke.py`.

Bit-level references run in a subprocess with XLA's CPU backend capped
below FMA (``--xla_cpu_max_isa=AVX``): jitted XLA code on the CPU
contracts multiply-adds into FMAs, while the port (and its kernels,
built with ``--fmad=false``) rounds every multiply and add, as the TPU
does. With that flag the min field's d² is bit-equal and its winding
and argmin exact. Gradients are compared in this process, within a
stated tolerance.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.ops import sdf_grad as jax_grad
from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_grad, sdf_torch
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 256
DEPTH = 2


def _synth_case():
    """4 curved glyphs, perturbed start, depth 2: the flat plan and the
    point chain of the initial parameters."""
    b = synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)
    return b.curve_mask, b.meta, b.curves0, b.target.shape[1]


def _degenerate_case():
    """Zero-length curves, a horizontal line, a square, and a glyph with
    no live segment (every pixel keeps the sentinel)."""
    sq = [((2, 2), (6, 2)), ((6, 2), (6, 6)), ((6, 6), (2, 6)), ((2, 6), (2, 2))]
    lines = [((3, 4), (7, 4))] + sq  # the first is horizontal
    curves = np.zeros((3, 8, 4, 2), np.float32)
    mask = np.zeros((3, 8), bool)
    for c, (s, e) in enumerate(lines):
        s, e = np.array(s, np.float32), np.array(e, np.float32)
        curves[0, c] = [s, s + (e - s) / 3, s + 2 * (e - s) / 3, e]
    curves[0, 5:7] = 4.5  # two zero-length curves
    mask[0, :7] = True
    curves[1, :2] = [[[1, 1], [1, 1], [1, 1], [1, 1]], [[1, 1], [3, 1], [5, 1], [7, 1]]]
    mask[1, :2] = True
    meta = np.array([[0, 0, 10, 9, 0, 0, 0, 0], [-2, -1, 12, 6, 0, 0, 0, 0],
                     [0, 0, 17, 17, 0, 0, 0, 0]], np.int32)[:, :4]
    return mask, meta, curves, 512


CASES = {"synth": _synth_case, "degenerate": _degenerate_case}


def _inputs(case):
    mask, meta, curves, P = CASES[case]()
    plan = fitting.build_flat_plan(mask, meta, DEPTH, P)
    params = fitting.init_params(curves, device="cpu")
    pts = fitting.flat_chain_points(
        params["curves"], params["translate"], DEPTH, torch.as_tensor(plan.chunk_map).long()
    ).detach().numpy()
    return plan, np.ascontiguousarray(pts, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_JAX_SIDE = r"""
import sys, numpy as np
from versatiles_glyphs_tpu.ops.sdf_pallas import min_field_pallas_pts
from versatiles_glyphs_tpu.ops.sdf_jax import min_field_pts_jax
from versatiles_glyphs_tpu.ops.sdf_grad import signed_field_flat
for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
    a = np.load(src)
    pts, words, tmeta, L_max = a["pts"], a["words"], a["tmeta"], int(a["L_max"])
    pal = min_field_pallas_pts(pts, words, np.ascontiguousarray(tmeta.T), 256, interpret=True)
    twin = min_field_pts_jax(pts, words, tmeta, 256, L_max)
    sd = signed_field_flat(pts, words, tmeta, 256, L_max, interpret=True)
    out = {"sd": np.asarray(sd)}
    for name, res in (("pallas", pal), ("twin", twin)):
        out.update({f"{name}_{k}": np.asarray(v) for k, v in zip(("d2", "wn", "am"), res)})
    np.savez(dst, **out)
"""


def no_fma_env(tmp_path) -> dict:
    """Environment of a JAX subprocess whose XLA CPU code has no FMA."""
    return dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
                VG_JAX_CACHE_DIR=str(tmp_path / "jax_cache"))


@pytest.fixture(scope="module")
def jax_min_field(tmp_path_factory):
    """The JAX package's min field (Pallas kernel 2 in interpret mode and
    its jnp twin) and flat signed field on both cases, from one
    subprocess with XLA's FMA contraction off."""
    tmp = tmp_path_factory.mktemp("jax_min_field")
    cases, argv = {}, []
    for case in CASES:
        plan, pts = _inputs(case)
        src, dst = tmp / f"{case}_in.npz", tmp / f"{case}_out.npz"
        np.savez(src, pts=pts, words=plan.mask_words, tmeta=plan.tmeta, L_max=plan.L_max)
        cases[case] = (plan, pts, dst)
        argv += [str(src), str(dst)]
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, *argv], cwd=ROOT,
                          env=no_fma_env(tmp), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {case: (plan, pts, dict(np.load(dst))) for case, (plan, pts, dst) in cases.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["pallas", "twin"])
def test_min_field_matches_jax(jax_min_field, case, ref):
    """d² bit for bit, winding and argmin lanes exactly, skip rows 0."""
    plan, pts, want = jax_min_field[case]
    d2, wn, am = sdf_cuda.min_field_cuda_pts(_t(pts), _t(plan.mask_words), _t(plan.tmeta.T), TP)
    assert d2.dtype == torch.float32 and wn.dtype == am.dtype == torch.int32
    np.testing.assert_array_equal(d2.numpy().view(np.int32), want[f"{ref}_d2"].view(np.int32))
    np.testing.assert_array_equal(wn.numpy(), want[f"{ref}_wn"])
    np.testing.assert_array_equal(am.numpy(), want[f"{ref}_am"])
    assert not am[plan.T :].any() and not d2[plan.T :].any()
    if case == "degenerate":
        # Glyph 2 has no live segment: every pixel of it is the sentinel.
        g2 = plan.tmeta[: plan.T, 4] == 0
        assert g2.sum() == 2 and (am.numpy()[: plan.T][g2] == sdf_torch._BIGI).all()


@pytest.mark.parametrize("case", list(CASES))
def test_signed_field_flat_matches_jax(jax_min_field, case):
    """The forward value: bit-equal on real tiles."""
    plan, pts, want = jax_min_field[case]
    sd = sdf_grad.signed_field_flat(_t(pts), _t(plan.mask_words), _t(plan.tmeta.T), TP)
    np.testing.assert_array_equal(sd.numpy()[: plan.T], want["sd"][: plan.T])


def test_min_field_chunking_is_exact(monkeypatch):
    plan, pts = _inputs("synth")
    args = (_t(pts), _t(plan.mask_words), _t(plan.tmeta.T), TP)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1 << 30)
    whole = sdf_torch.min_field_pts(*args)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1)
    for a, b in zip(sdf_torch.min_field_pts(*args), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _masked_cotangent(plan, seed):
    """A seeded cotangent of sd, zero where the loss masks: rows past
    the real tiles and pixels past w·h."""
    ct = np.random.default_rng(seed).normal(size=(plan.tmeta.shape[0], TP)).astype(np.float32)
    i = plan.tmeta[:, 6:7] + np.arange(TP)[None, :]
    ct[i >= plan.tmeta[:, 2:3] * plan.tmeta[:, 3:4]] = 0.0
    return ct


@pytest.mark.parametrize("case", list(CASES))
def test_flat_grad_matches_jax(case):
    """Gradient of sum(sd·ct) w.r.t. the points against `jax.grad` of the
    JAX `signed_field_flat` (interpret: the gather-recompute autodiff).
    Tolerance 1e-4·max|g|: the JAX path also differentiates through tc,
    whose extra term is 0 only up to f32 rounding, and sums in another
    order."""
    plan, pts = _inputs(case)
    ct = _masked_cotangent(plan, seed=3)

    def loss(p):
        sd = jax_grad.signed_field_flat(p, plan.mask_words, plan.tmeta, TP, plan.L_max,
                                        interpret=True)
        return jnp.sum(sd * ct)

    want = np.asarray(jax.grad(loss)(jnp.asarray(pts)))
    p = _t(pts).requires_grad_()
    sd = sdf_grad.signed_field_flat(p, _t(plan.mask_words), _t(plan.tmeta.T), TP)
    (sd * _t(ct)).sum().backward()
    got = p.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_bwd_drops_masked_pixels():
    """Pixels past w·h, skip rows and sentinel pixels add nothing,
    whatever their cotangent."""
    plan, pts = _inputs("degenerate")
    tm = _t(plan.tmeta.T)
    _, _, am = sdf_torch.min_field_pts(_t(pts), _t(plan.mask_words), tm, TP)
    ct = np.random.default_rng(5).normal(size=am.shape).astype(np.float32)
    full = sdf_cuda.min_field_bwd_cuda(_t(pts), am, _t(ct), tm, TP)
    i = plan.tmeta[:, 6:7] + np.arange(TP)[None, :]
    keep = (i < plan.tmeta[:, 2:3] * plan.tmeta[:, 3:4]) & (am.numpy() != sdf_torch._BIGI)
    assert (~keep).any() and (am.numpy() == sdf_torch._BIGI).any()
    ct_kept = _t(np.where(keep, ct, 0.0).astype(np.float32))
    masked = sdf_cuda.min_field_bwd_cuda(_t(pts), am, ct_kept, tm, TP)
    np.testing.assert_array_equal(full.numpy(), masked.numpy())
    assert np.abs(full.numpy()).max() > 0


def test_flat_loss_finite_differences():
    """Directional derivative of the port's flat loss against a central
    difference (as `tests/test_grad_kernel.py` does for the JAX pair)."""
    b = synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    params, _, dev = fitter.init(b)
    _, grads = fitter.value_and_grad(params, dev)
    rng = np.random.default_rng(11)
    v = {k: torch.from_numpy(rng.normal(size=tuple(params[k].shape)).astype(np.float32))
         for k in fitting.PARAM_KEYS}
    norm = float(torch.sqrt(sum((x * x).sum() for x in v.values())))
    v = {k: x / norm for k, x in v.items()}
    eps = 1e-2
    with torch.no_grad():
        lp = fitter.loss({k: params[k] + eps * v[k] for k in v}, dev)
        lm = fitter.loss({k: params[k] - eps * v[k] for k in v}, dev)
    fd = float(lp - lm) / (2 * eps)
    an = float(sum((grads[k] * v[k]).sum() for k in v))
    # Loose: the hard-min loss has kinks (argmin switches, clip
    # saturation) inside the stencil.
    assert abs(fd - an) < 0.1 * max(abs(fd), 1e-3), (fd, an)


def test_cpu_wrappers_count_no_launches():
    plan, pts = _inputs("synth")
    sdf_cuda.reset_launches()
    p = _t(pts).requires_grad_()
    sd = sdf_grad.signed_field_flat(p, _t(plan.mask_words), _t(plan.tmeta.T), TP)
    sd.sum().backward()
    assert p.grad.abs().max() > 0
    assert sdf_cuda.LAUNCHES == dict.fromkeys(sdf_cuda.KERNELS, 0)


def test_plan_rows_suit_the_backward_kernel():
    """The backward kernel's row check accepts the flat plan's table and
    refuses one whose rows of a glyph are not consecutive."""
    plan, _ = _inputs("synth")
    tm = _t(plan.tmeta.T)
    N = plan.N
    assert not sdf_cuda._bad_glyph_rows(tm, N, TP).any()
    swapped = tm.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    assert sdf_cuda._bad_glyph_rows(swapped, N, TP).any()
    short = tm.clone()
    short[5, 0] = N  # lanes out of bounds
    assert sdf_cuda._bad_glyph_rows(short, N, TP).any()


@pytest.mark.parametrize("bad", ["pts_dtype", "am_dtype", "ct_shape", "tp"])
def test_bwd_wrapper_rejects_bad_inputs(bad):
    plan, pts = _inputs("synth")
    T = plan.tmeta.shape[0]
    args = {"pts": _t(pts), "am": torch.zeros((T, TP), dtype=torch.int32),
            "ct_d2": torch.zeros((T, TP)), "tmeta": _t(plan.tmeta.T), "TP": TP}
    if bad == "pts_dtype":
        args["pts"] = args["pts"].double()
    elif bad == "am_dtype":
        args["am"] = args["am"].long()
    elif bad == "ct_shape":
        args["ct_d2"] = args["ct_d2"][:-1]
    else:
        args["TP"] = 100
    with pytest.raises(ValueError):
        sdf_cuda.min_field_bwd_cuda(**args)



@pytest.mark.parametrize("bad", [None, "swapped_rows", "lanes", "words_shape", "words_dtype", "tp"])
def test_check_flat_plan_holds_both_wrappers_checks(bad):
    """`check_flat_plan` accepts the flat plan and refuses what either
    wrapper's per-call check refuses."""
    plan, _ = _inputs("synth")
    N, words, tm, tp = plan.N, _t(plan.mask_words), _t(plan.tmeta.T), TP
    if bad is None:
        sdf_cuda.check_flat_plan(N, words, tm, tp)
        sdf_cuda.check_flat_plan(N, words, tm[:, :0].contiguous(), tp)  # an empty table
        return
    if bad == "swapped_rows":
        tm = tm.clone()
        tm[:, [0, 1]] = tm[:, [1, 0]]
    elif bad == "lanes":
        tm = tm.clone()
        tm[5, 0] = N
    elif bad == "words_shape":
        words = words[:-1]
    elif bad == "words_dtype":
        words = words.long()
    else:
        tp = 100
    with pytest.raises(ValueError):
        sdf_cuda.check_flat_plan(N, words, tm, tp)


def test_checked_signed_field_is_the_unchecked_one():
    """``checked=True`` changes which checks run, never the values."""
    plan, pts = _inputs("synth")
    ct = _t(_masked_cotangent(plan, seed=3))
    out = []
    for checked in (False, True):
        p = _t(pts).requires_grad_()
        sd = sdf_grad.signed_field_flat(p, _t(plan.mask_words), _t(plan.tmeta.T), TP,
                                        checked=checked)
        (sd * ct).sum().backward()
        out.append((sd.detach().numpy(), p.grad.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert np.abs(out[0][1]).max() > 0


def test_fitter_checks_its_plan_once(monkeypatch):
    """`FontFitter.init` runs the plan's check once; the steps run none
    of the wrappers' per-call table checks when the launch goes alone
    (on the CPU the wrappers still serve, so only the count at init is
    held here)."""
    calls = []
    real = sdf_cuda.check_flat_plan
    monkeypatch.setattr(sdf_cuda, "check_flat_plan",
                        lambda *a: (calls.append(a[0]), real(*a))[1])
    b = synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    params, opt, dev = fitter.init(b)
    assert calls == [dev["plan_words"].shape[0] * 32]
    fitter.step_many(params, opt, dev, 2)
    assert len(calls) == 1
    # A plan that the kernels cannot take is refused at init.
    monkeypatch.setattr(fitting, "build_flat_plan", lambda *a, **k: _broken_plan(*a, **k))
    with pytest.raises(ValueError, match="tile table"):
        fitter.init(b)


_real_build_flat_plan = fitting.build_flat_plan


def _broken_plan(*args, **kwargs):
    plan = _real_build_flat_plan(*args, **kwargs)
    plan.tmeta[[0, 1]] = plan.tmeta[[1, 0]]  # a glyph's rows out of order
    return plan
