"""The padded-layout fitting ops of the port against the JAX package, on
the CPU: the padded min field (TPU kernel 4), its backward (TPU kernel
5), `ops.sdf_grad.signed_field_padded` and
`models.fitting.batch_loss_kernel`.

The wrappers of `ops.sdf_cuda` take their plain versions here because
the tensors lie on the CPU; the CUDA kernels are held against those on
the card by `chip_smoke.py`.

The JAX side (`_run_fwd` and `_run_bwd` in Pallas interpret mode,
`signed_field_pallas` and `batch_loss_kernel` with their gradients) runs
in one subprocess with XLA's CPU backend capped below FMA
(``--xla_cpu_max_isa=AVX``): jitted XLA code on the CPU contracts
multiply-adds into FMAs, while the port rounds every multiply and add,
as the TPU does. With that flag d² is bit-equal and the winding and
argmin exact. Sums of the backward are taken in another order on the
two sides, so gradients agree within 1e-4 of their largest magnitude.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.models.glyph_model import curves_to_segments
from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_grad, sdf_torch
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2


def _segments(curves, curve_mask):
    segs = curves_to_segments(torch.from_numpy(curves), DEPTH).numpy()
    mask = np.repeat(curve_mask, 2**DEPTH, axis=-1).astype(np.float32)
    return np.ascontiguousarray(segs, np.float32), mask


def _synth_case():
    """4 curved glyphs of a self-fit batch at depth 2, perturbed start."""
    b = synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)
    segs, mask = _segments(b.curves0, b.curve_mask)
    return segs, mask, b.meta.astype(np.int32), b.target.shape[1]


def _degenerate_case():
    """Zero-length and horizontal segments, a square, a glyph with no
    live segment (every pixel keeps the sentinel), negative origins and
    a pixel count that no tile size divides."""
    segs = np.zeros((3, 8, 4), np.float32)
    segs[0, :6] = [[3, 4, 7, 4], [2, 2, 6, 2], [6, 2, 6, 6], [6, 6, 2, 6], [2, 6, 2, 2],
                   [4.5, 4.5, 4.5, 4.5]]
    segs[1, :3] = [[1, 1, 1, 1], [1, 1, 7, 1], [7, 1, 4, 5]]
    segs[2, :2] = [[0, 0, 5, 5], [5, 5, 0, 0]]  # masked below
    mask = np.zeros((3, 8), np.float32)
    mask[0, :6] = 1.0
    mask[1, :3] = 1.0
    meta = np.array([[0, 0, 10, 9], [-2, -1, 12, 6], [0, 0, 17, 17]], np.int32)
    return segs, mask, meta, 300


CASES = {"synth": _synth_case, "degenerate": _degenerate_case}


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch_params(b):
    """Parameters as numpy (as they cross from the JAX package): the
    perturbed start, a small seeded translate and a gain."""
    rng = np.random.default_rng(4)
    return {"curves": b.curves0,
            "translate": rng.normal(0.0, 0.2, (b.curves0.shape[0], 2)).astype(np.float32),
            "log_gain": np.float32(0.1)}


_JAX_SIDE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from versatiles_glyphs_tpu.ops.sdf_grad import _run_bwd, _run_fwd, signed_field_pallas
from versatiles_glyphs_tpu.models.fitting import batch_loss_kernel

def up(n, m):
    return max(-(-n // m) * m, m)

for src, dst in zip(sys.argv[1::2], sys.argv[2::2]):
    a = dict(np.load(src))
    segs, mask, meta, P = a["segs"], a["mask"], a["meta"], int(a["P"])
    B, S, _ = segs.shape
    Sp, Pp = up(S, 128), up(P, 1024)
    segp = np.pad(segs, ((0, 0), (0, Sp - S), (0, 0)))
    maskp = np.pad(mask, ((0, 0), (0, Sp - S)))
    meta8 = np.zeros((B, 8), np.int32)
    meta8[:, :4] = meta
    d2, wn, am = _run_fwd(jnp.transpose(segp, (0, 2, 1)), maskp[:, None, :], meta8, Pp, Sp, True)
    gd = np.zeros((B, Pp), np.float32)
    gd[:, :P] = a["ct_d2"]
    segt = np.pad(segp, ((0, 0), (0, 0), (0, 124)))
    dsegt = _run_bwd(segt, meta8, am, gd, Pp, Sp, True)
    field = lambda s: signed_field_pallas(s, mask, meta, P, interpret=True)
    out = {"d2": np.asarray(d2)[:, :P], "wn": np.asarray(wn)[:, :P],
           "am": np.asarray(am)[:, :P], "dsegs": np.asarray(dsegt)[:, :S, :4],
           "sd": np.asarray(field(segs)),
           "g_sd": np.asarray(jax.grad(lambda s: jnp.sum(field(s) * a["ct_sd"]))(segs))}
    if "curves" in a:
        params = {k: jnp.asarray(a[k]) for k in ("curves", "translate", "log_gain")}
        batch = {k: jnp.asarray(a[k]) for k in ("curve_mask", "pix_mask", "target")}
        batch["meta"] = jnp.asarray(meta)
        loss, g = jax.value_and_grad(batch_loss_kernel)(params, batch, 2, True)
        out["loss"] = np.asarray(loss)
        out.update({f"g_{k}": np.asarray(v) for k, v in g.items()})
    np.savez(dst, **out)
"""


@pytest.fixture(scope="module")
def jax_padded(tmp_path_factory):
    """The JAX package's padded pair on both cases (and its
    `batch_loss_kernel` on the synth batch), from one subprocess with
    XLA's FMA contraction off. The backward gets the forward's own
    argmin and a seeded cotangent over every pixel."""
    tmp = tmp_path_factory.mktemp("jax_padded")
    cases, argv = {}, []
    for k, (case, make) in enumerate(CASES.items()):
        segs, mask, meta, P = make()
        B = segs.shape[0]
        arrays = {"segs": segs, "mask": mask, "meta": meta, "P": P,
                  "ct_d2": _cotangent((B, P), 10 + k), "ct_sd": _cotangent((B, P), 20 + k)}
        if case == "synth":
            b = synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)
            arrays.update(_batch_params(b), curve_mask=b.curve_mask,
                          pix_mask=b.pix_mask, target=b.target)
        src, dst = tmp / f"{case}_in.npz", tmp / f"{case}_out.npz"
        np.savez(src, **arrays)
        cases[case] = (arrays, dst)
        argv += [str(src), str(dst)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {case: (arrays, dict(np.load(dst))) for case, (arrays, dst) in cases.items()}


def _close(got, want, rel=1e-4):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_min_field_padded_matches_pallas(jax_padded, case):
    """Plain kernel 4 against `_run_fwd` in interpret mode: d² bit for
    bit, winding and argmin exactly, on every one of the P pixels."""
    a, want = jax_padded[case]
    d2, wn, am = sdf_cuda.min_field_cuda_padded(_t(a["segs"]), _t(a["mask"]), _t(a["meta"]), a["P"])
    assert d2.dtype == torch.float32 and wn.dtype == am.dtype == torch.int32
    assert tuple(d2.shape) == want["d2"].shape == (a["segs"].shape[0], a["P"])
    np.testing.assert_array_equal(d2.numpy().view(np.int32), want["d2"].view(np.int32))
    np.testing.assert_array_equal(wn.numpy(), want["wn"])
    np.testing.assert_array_equal(am.numpy(), want["am"])
    if case == "degenerate":
        assert (am.numpy()[2] == sdf_torch._BIGI).all() and (am.numpy()[:2] < 8).all()
        assert (wn.numpy()[0] != 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_min_field_padded_bwd_matches_pallas(jax_padded, case):
    """Plain kernel 5 against `_run_bwd` in interpret mode, on the same
    argmin and cotangent (pixels past w·h included): within 1e-4·max."""
    a, want = jax_padded[case]
    got = sdf_cuda.min_field_padded_bwd_cuda(_t(a["segs"]), _t(a["meta"]), _t(want["am"]),
                                             _t(a["ct_d2"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want["dsegs"].shape
    _close(got.numpy(), want["dsegs"])
    if case == "degenerate":
        assert not got[2].any() and not got[0, 6:].any()  # no live segment, masked tail


@pytest.mark.parametrize("case", list(CASES))
def test_signed_field_padded_matches_pallas(jax_padded, case):
    """Values bit-equal to `signed_field_pallas(interpret=True)`; the
    gradient of sum(sd·ct) within 1e-4·max of `jax.grad`'s."""
    a, want = jax_padded[case]
    segs = _t(a["segs"]).requires_grad_()
    sd = sdf_grad.signed_field_padded(segs, _t(a["mask"]), _t(a["meta"]), a["P"])
    np.testing.assert_array_equal(sd.detach().numpy().view(np.int32), want["sd"].view(np.int32))
    (sd * _t(a["ct_sd"])).sum().backward()
    _close(segs.grad.numpy(), want["g_sd"])


def test_batch_loss_kernel_matches_jax(jax_padded):
    """`batch_loss_kernel` at parameters carried by `params_from_numpy`:
    loss within 1e-6 relative, every gradient within 1e-4·max."""
    a, want = jax_padded["synth"]
    params = fitting.params_from_numpy(a, device="cpu")
    batch = {"curve_mask": _t(a["curve_mask"]), "pix_mask": _t(a["pix_mask"]),
             "target": _t(a["target"]), "meta": _t(a["meta"])}
    loss = fitting.batch_loss_kernel(params, batch, DEPTH)
    assert abs(float(loss.detach()) - float(want["loss"])) <= 1e-6 * abs(float(want["loss"]))
    loss.backward()
    for k in fitting.PARAM_KEYS:
        _close(params[k].grad.numpy(), want[f"g_{k}"])


def test_flat_backend_batch_carries_meta():
    """`FontFitter.init` of the flat backend puts meta into the device
    batch, so `batch_loss_kernel` runs on it; its loss equals the flat
    loss (both take the first argmin of the same d²)."""
    b = synth_fit_batch(3, 65, seed=2, depth=DEPTH, perturb=0.3)
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    params, _, dev = fitter.init(b)
    assert dev["meta"].dtype == torch.int32 and tuple(dev["meta"].shape) == (3, 4)
    with torch.no_grad():
        lk = float(fitting.batch_loss_kernel(params, dev, DEPTH))
        lf = float(fitter.loss(params, dev))
    assert abs(lk - lf) <= 1e-5 * lf


@pytest.fixture(scope="module")
def soup():
    """A random soup, as `tests/test_grad_kernel.py` draws it."""
    rng = np.random.default_rng(7)
    B, S, w, h = 4, 70, 19, 23
    segs = rng.uniform(-2.0, 22.0, size=(B, S, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, S)) > 0.15).astype(np.float32)
    meta = np.tile(np.array([[-3, -3, w, h]], np.float32), (B, 1))
    return segs, mask, meta, w * h


def test_signed_field_padded_finite_differences(soup):
    """Directional derivative against a central difference (as
    `tests/test_grad_kernel.py::test_grad_finite_differences`)."""
    segs, mask, meta, P = soup
    rng = np.random.default_rng(11)
    wts = _t(rng.normal(size=(segs.shape[0], P)).astype(np.float32))

    def loss(s):
        return (sdf_grad.signed_field_padded(s, _t(mask), _t(meta), P) * wts).sum()

    s = _t(segs).requires_grad_()
    loss(s).backward()
    v = rng.normal(size=segs.shape).astype(np.float32)
    v = _t(v / np.linalg.norm(v))
    eps = 1e-2
    with torch.no_grad():
        fd = float(loss(_t(segs) + eps * v) - loss(_t(segs) - eps * v)) / (2 * eps)
    an = float((s.grad * v).sum())
    assert abs(fd - an) < 5e-3 * max(abs(fd), 1.0)


def test_winding_sign_inside_negative():
    """A 4×4 square in a 10×10 grid (`tests/test_grad_kernel.py::
    test_winding_sign_inside_negative`): negative inside, positive on
    the border rows and columns; the winding carries no gradient."""
    sq = np.array([[3, 3, 3, 7], [3, 7, 7, 7], [7, 7, 7, 3], [7, 3, 3, 3]], np.float32)
    segs = _t(sq[None]).requires_grad_()
    mask, meta = torch.ones(1, 4), torch.tensor([[0, 0, 10, 10]])
    grid = sdf_grad.signed_field_padded(segs, mask, meta, 100).detach().numpy().reshape(10, 10)
    assert (grid[4:6, 4:6] < 0).all()
    assert (grid[0, :] > 0).all() and (grid[:, 0] > 0).all()
    d2, wn = sdf_grad.MinD2Padded.apply(segs, mask, meta, 100)
    assert d2.requires_grad and not wn.requires_grad and wn.dtype == torch.int32


def test_chunking_is_exact(monkeypatch):
    """One glyph per chunk gives the same min field as one chunk of all."""
    segs, mask, meta, P = _synth_case()
    args = (_t(segs), _t(mask), _t(meta), P)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1 << 30)
    whole = sdf_torch.min_field_padded(*args)
    monkeypatch.setattr(sdf_torch, "_chunk_elems", lambda dev: 1)
    for a, b in zip(sdf_torch.min_field_padded(*args), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_wrappers_count_no_launches():
    segs, mask, meta, P = _synth_case()
    sdf_cuda.reset_launches()
    s = _t(segs).requires_grad_()
    sdf_grad.signed_field_padded(s, _t(mask), _t(meta), P).sum().backward()
    assert s.grad.abs().max() > 0
    assert sdf_cuda.LAUNCHES == dict.fromkeys(sdf_cuda.KERNELS, 0)


@pytest.mark.parametrize(
    "bad", ["segs_dtype", "segs_shape", "mask_shape", "meta_shape", "P_bound", "P_negative"]
)
def test_forward_wrapper_rejects_bad_inputs(bad):
    segs, mask, meta, P = _synth_case()
    args = {"segs": _t(segs), "mask": _t(mask), "meta": _t(meta), "P": P}
    if bad == "segs_dtype":
        args["segs"] = args["segs"].double()
    elif bad == "segs_shape":
        args["segs"] = args["segs"][..., :3].contiguous()
    elif bad == "mask_shape":
        args["mask"] = args["mask"][:, :-1]
    elif bad == "meta_shape":
        args["meta"] = args["meta"][:, :3]
    elif bad == "P_bound":
        args["P"] = sdf_cuda.MAX_PADDED_PIXELS + 1
    else:
        args["P"] = -1
    with pytest.raises(ValueError):
        sdf_cuda.min_field_cuda_padded(**args)


@pytest.mark.parametrize("bad", ["segs_dtype", "meta_rows", "am_dtype", "am_shape", "ct_shape"])
def test_backward_wrapper_rejects_bad_inputs(bad):
    segs, _, meta, P = _synth_case()
    B = segs.shape[0]
    args = {"segs": _t(segs), "meta": _t(meta), "am": torch.zeros((B, P), dtype=torch.int32),
            "ct_d2": torch.zeros((B, P))}
    if bad == "segs_dtype":
        args["segs"] = args["segs"].double()
    elif bad == "meta_rows":
        args["meta"] = args["meta"][:-1]
    elif bad == "am_dtype":
        args["am"] = args["am"].long()
    elif bad == "am_shape":
        args["am"] = args["am"][:-1]
    else:
        args["ct_d2"] = args["ct_d2"][:, :-1]
    with pytest.raises(ValueError):
        sdf_cuda.min_field_padded_bwd_cuda(**args)
