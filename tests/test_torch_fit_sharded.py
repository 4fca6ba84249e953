"""The port's sharded fitting against the JAX package's mesh path and
against its own one-device fitter, on the CPU.

`FontFitter(devices=...)` shards the batch over a list of devices; here
they are stand-ins of the one CPU device (`parallel.mesh.local_devices(2,
"cpu")`), as the JAX side runs on two of XLA's virtual CPU devices
(``--xla_force_host_platform_device_count``). The batch has an odd glyph
count, so the ``flat`` backend pads a glyph, as the JAX ``pallas`` mesh
path does.

The JAX side (the ``pallas`` mesh fitter's `_kernel_loss`, whose Pallas
kernels run in interpret mode off the TPU; `make_sharded_kernel_loss`;
the ``jnp`` backend on the mesh) runs in one subprocess with XLA's CPU
backend capped below FMA (``--xla_cpu_max_isa=AVX``), as the other
port-against-JAX tests run it. Tolerances are stated at each test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.models import fitting as jfit
from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.parallel import mesh
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2
CPU2 = mesh.local_devices(2, "cpu")


def _odd_batch():
    """5 glyphs: the flat backend pads a sixth over two devices."""
    return synth_fit_batch(5, 65, seed=1, depth=DEPTH, perturb=0.3)


def _even_batch():
    """4 glyphs, for the torch backend (which shards only an even split)."""
    return synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)


def _save(path, b):
    np.savez(path, **{k: v for k, v in vars(b).items() if v is not None})


_JAX_SIDE = r"""
import sys, numpy as np, jax
from versatiles_glyphs_tpu.models import fitting as jf
from versatiles_glyphs_tpu.parallel.mesh import make_mesh
odd, even, out = sys.argv[1:4]
load = lambda p: jf.FitBatch(**{k: v for k, v in np.load(p).items()})
mesh = make_mesh(jax.devices()[:2])
res = {}

def put(name, loss, grads):
    res[name + "_loss"] = np.asarray(loss)
    res.update({f"{name}_g_{k}": np.asarray(v) for k, v in grads.items()})

f = jf.FontFitter(mesh=mesh, depth=2, backend="pallas")
p, _, d = f.init(load(odd))
put("flat", *jax.value_and_grad(f._kernel_loss)(p, d))
put("padded", *jax.value_and_grad(jf.make_sharded_kernel_loss(mesh, 2, 5))(p, d))
for name, s in (("torch", None), ("torch_soft", 2.0)):
    f = jf.FontFitter(mesh=mesh, depth=2, backend="jnp", sharpness=s)
    p, _, d = f.init(load(even))
    put(name, *jax.value_and_grad(jf.batch_loss)(p, d, 2, s))
# k = 3 steps in one dispatch (`_step_k` over the mesh), from the start.
for name, backend, path in (("flat", "pallas", odd), ("torch", "jnp", even)):
    f = jf.FontFitter(mesh=mesh, depth=2, backend=backend)
    p, o, d = f.init(load(path))
    p, o, losses = f.step_many(p, o, d, 3)
    res[name + "_k3_losses"] = np.asarray(losses)
    res.update({f"{name}_k3_{k}": np.asarray(v) for k, v in p.items()})
try:
    jf.FontFitter(mesh=mesh, depth=2, backend="jnp").init(load(odd))
    res["uneven"] = np.asarray("accepted")
except ValueError as e:
    res["uneven"] = np.asarray("ValueError: " + str(e))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX package's sharded losses and gradients over a two-device
    mesh, and what its jnp mesh path does with an odd batch."""
    tmp = tmp_path_factory.mktemp("jax_mesh")
    _save(tmp / "odd.npz", _odd_batch())
    _save(tmp / "even.npz", _even_batch())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 --xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "odd.npz"), str(tmp / "even.npz"),
         str(tmp / "out.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


# name -> (port backend, sharpness, batch, padded-layout loss)
CASES = {
    "flat": ("flat", None, _odd_batch, False),
    "padded": ("flat", None, _odd_batch, True),
    "torch": ("torch", None, _even_batch, False),
    "torch_soft": ("torch", 2.0, _even_batch, False),
}


def _sharded(name, devices=CPU2):
    """(fitter, params, opt, shards, loss_fn, B_real) of a case."""
    backend, sharpness, make, padded = CASES[name]
    b = make()
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, sharpness=sharpness, devices=devices)
    params, opt, shards = fitter.init(b)
    B_real = b.curves0.shape[0]
    if padded:  # the pair's own batch a shard, on the rows the flat fitter gives each
        shards = [fitting.padded_batch(part, dev)
                  for part, dev in zip(fitting.split_batch(b, len(devices))[1], devices)]
    loss_fn = (fitting.make_sharded_kernel_loss(devices, DEPTH, B_real) if padded
               else fitter.loss)
    return fitter, params, opt, shards, loss_fn, B_real


def _value_and_grad(loss_fn, params, shards):
    loss = loss_fn(params, shards)
    grads = torch.autograd.grad(loss, [params[k] for k in fitting.PARAM_KEYS])
    return loss.detach(), dict(zip(fitting.PARAM_KEYS, grads))


# -- devices --------------------------------------------------------------


def test_local_devices(monkeypatch):
    """CPU stand-ins listed n times; CUDA raises without a card and never
    falls back; n below 1 and other kinds are refused."""
    assert mesh.local_devices(3, "cpu") == [torch.device("cpu")] * 3
    for bad in ((0, "cpu"), (2, "mps")):
        with pytest.raises(ValueError):
            mesh.local_devices(*bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_devices(2)


def test_local_devices_takes_what_is_visible(monkeypatch):
    """``jax.devices()[:n]``: the first n CUDA devices, or every visible one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.local_devices(8) == [torch.device("cuda", i) for i in range(3)]


def test_fitter_rejects_bad_device_lists():
    with pytest.raises(ValueError, match="not both"):
        fitting.FontFitter(device="cpu", devices=CPU2)
    with pytest.raises(ValueError, match="at least one"):
        fitting.FontFitter(devices=[])


# -- against the JAX package ----------------------------------------------


def test_shard_plans_match_jax():
    """Each shard's plan arrays (on its device, as the loss reads them)
    equal JAX `build_flat_plan` on the same slice of the padded batch,
    array for array; the fused loss's target tiles hold each glyph's
    target at the rows the JAX plan's ``row_map`` gives its tiles, and
    its glyph table starts each glyph at its first. `split_batch` gives
    the padded pair's shards the same rows."""
    from versatiles_glyphs_tpu.parallel.mesh import pad_to_multiple

    b = _odd_batch()
    _, _, shards = fitting.FontFitter(depth=DEPTH, backend="flat", devices=CPU2).init(b)
    parts = fitting.split_batch(b, 2)[1]
    mask, meta = pad_to_multiple(b.curve_mask, 2), pad_to_multiple(b.meta, 2)
    assert mask.shape[0] == 6 and not mask[5].any() and not meta[5].any()
    for d, shard in enumerate(shards):
        rows = slice(3 * d, 3 * d + 3)
        want = jfit.build_flat_plan(mask[rows], meta[rows], DEPTH, b.target.shape[1])
        np.testing.assert_array_equal(shard["plan_tmeta"].numpy(), want.tmeta.T)
        np.testing.assert_array_equal(shard["plan_words"].numpy(), want.mask_words)
        tiles = shard["target_tiles"].numpy()
        for g in range(3):
            npix = int(want.tmeta[want.row_map[g, 0], 2] * want.tmeta[want.row_map[g, 0], 3])
            ntiles = max(1, -(-npix // want.TP))
            target = np.zeros(ntiles * want.TP, np.float32)
            target[:npix] = pad_to_multiple(b.target, 2)[rows][g, :npix]
            np.testing.assert_array_equal(tiles[want.row_map[g, :ntiles]].reshape(-1), target)
        np.testing.assert_array_equal(shard["glyph_rows"].numpy()[:, 0], want.row_map[:, 0])
        np.testing.assert_array_equal(shard["chunk_map"].numpy(), want.chunk_map)
        np.testing.assert_array_equal(fitting.padded_batch(parts[d], "cpu")["meta"].numpy(),
                                      meta[rows])


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_and_grads_match_jax(jax_mesh, name):
    """The sharded flat loss against the JAX ``pallas`` mesh fitter's
    `_kernel_loss`, the padded one against JAX `make_sharded_kernel_loss`,
    the torch backend against the JAX ``jnp`` backend on the mesh: loss
    within 1e-5 relative, every gradient (its first B_real rows) within
    1e-4·max|g|, as `test_backend_loss_and_grads_match_jax` holds the
    one-device backends."""
    _, params, _, shards, loss_fn, B_real = _sharded(name)
    loss, grads = _value_and_grad(loss_fn, params, shards)
    want = float(jax_mesh[f"{name}_loss"])
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    for k in fitting.PARAM_KEYS:
        w = jax_mesh[f"{name}_g_{k}"]
        g = grads[k].numpy()
        if g.ndim:
            assert g.shape == w.shape
            g, w = g[:B_real], w[:B_real]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_torch_backend_uneven_batch_refused_like_jax(jax_mesh):
    """An odd batch over two devices: the JAX jnp mesh path refuses it
    (its ``device_put`` onto the mesh needs an even split), and so does
    the port's torch backend; the flat backend pads it in both."""
    assert str(jax_mesh["uneven"]).startswith("ValueError")
    with pytest.raises(ValueError, match="divide evenly"):
        fitting.FontFitter(depth=DEPTH, backend="torch", devices=CPU2).init(_odd_batch())


# -- against the one-device fitter ------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_one_device(name):
    """The same batch sharded two ways and on one device: loss within
    1e-6 relative and gradients within 1e-5·max|g| (the shards' sums are
    added in another order than one mean); the padded glyph's gradient
    rows are exactly 0."""
    backend, sharpness, make, padded = CASES[name]
    _, params, _, shards, loss_fn, B_real = _sharded(name)
    loss, grads = _value_and_grad(loss_fn, params, shards)
    one = fitting.FontFitter(depth=DEPTH, backend=backend, sharpness=sharpness, device="cpu")
    p1, _, d1 = one.init(make())
    if padded:
        l1 = fitting.batch_loss_kernel(p1, fitting.padded_batch(make(), "cpu"), DEPTH)
        g1 = dict(zip(fitting.PARAM_KEYS, torch.autograd.grad(l1, [p1[k] for k in fitting.PARAM_KEYS])))
    else:
        l1, g1 = one.value_and_grad(p1, d1)
    assert abs(loss.item() - l1.item()) <= 1e-6 * abs(l1.item())
    for k in fitting.PARAM_KEYS:
        w = g1[k].numpy()
        g = grads[k].numpy()
        if g.ndim:
            assert not g[B_real:].any(), k  # padded rows
            g = g[:B_real]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    if backend == "flat":
        assert params["curves"].shape[0] == 6 and len(shards) == 2


@pytest.mark.parametrize("backend,make", [("flat", _odd_batch), ("torch", _even_batch)])
def test_sharded_steps_match_one_device(backend, make):
    """10 Adam steps sharded two ways land within 1e-5 px of 10 steps on
    one device; padded rows never move."""
    sh = fitting.FontFitter(depth=DEPTH, backend=backend, devices=CPU2)
    p, o, s = sh.init(make())
    p, o, losses = sh.step_many(p, o, s, 10)
    one = fitting.FontFitter(depth=DEPTH, backend=backend, device="cpu")
    p1, o1, d1 = one.init(make())
    p1, o1, losses1 = one.step_many(p1, o1, d1, 10)
    B = p1["curves"].shape[0]
    np.testing.assert_allclose(losses, losses1, rtol=1e-5)
    for k in fitting.PARAM_KEYS:
        got = p[k].detach().numpy()
        if got.ndim:
            assert not got[B:].any(), k
            got = got[:B]
        np.testing.assert_allclose(got, p1[k].detach().numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_sharded_resume_is_exact(tmp_path):
    """5 + 5 sharded steps through a checkpoint equal 10 (Δ = 0). The
    checkpoint holds the padded rows; a fitter over another device count
    (another padding) refuses it."""
    sh = fitting.FontFitter(depth=DEPTH, backend="flat", devices=CPU2)
    p10, o10, s10 = sh.init(_odd_batch())
    sh.step_many(p10, o10, s10, 10)
    pa, oa, sa = sh.init(_odd_batch())
    sh.step_many(pa, oa, sa, 5)
    path = str(tmp_path / "ckpt")
    fitting.FontFitter.save_checkpoint(path, pa, oa)
    pb, ob, sb = sh.init(_odd_batch())
    pb, ob = fitting.FontFitter.restore_checkpoint(path, like=(pb, ob))
    sh.step_many(pb, ob, sb, 5)
    for k in fitting.PARAM_KEYS:
        np.testing.assert_array_equal(pb[k].detach().numpy(), p10[k].detach().numpy(), err_msg=k)
    assert torch.load(path, weights_only=True)["params"]["curves"].shape[0] == 6
    one = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    like = one.init(_odd_batch())[:2]
    with pytest.raises(ValueError, match="same number of devices"):
        fitting.FontFitter.restore_checkpoint(path, like=like)


@pytest.mark.parametrize("n", [1, 3])
def test_fit_over_other_device_counts(n):
    """`FontFitter.fit` over one device listed alone (the sharded path,
    as the JAX package takes it for a one-device mesh) and over three:
    the history's steps and, within 1e-5 px, the one-device fit."""
    sh = fitting.FontFitter(depth=DEPTH, backend="flat", devices=mesh.local_devices(n, "cpu"))
    params, history = sh.fit(_odd_batch(), steps=4, log_every=2)
    one = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    p1, h1 = one.fit(_odd_batch(), steps=4, log_every=2)
    assert [s for s, _ in history] == [s for s, _ in h1] == [0, 2, 3]
    np.testing.assert_allclose([v for _, v in history], [v for _, v in h1], rtol=1e-5)
    assert params["curves"].shape[0] == -(-5 // n) * n
    np.testing.assert_allclose(params["curves"].detach().numpy()[:5],
                               p1["curves"].detach().numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,make", [("flat", _odd_batch), ("torch", _even_batch)])
def test_sharded_graph_steps_match_jax_step_many(jax_mesh, name, make):
    """3 steps through the sharded step's graph decomposition
    (`models.fitting.ShardedStepGraph` without the capture, which
    `step_many` replays on CUDA devices) against the JAX mesh fitter's
    `step_many` (`_step_k` over `shard_map`, one dispatch) from the same
    start: losses within 1e-5 relative and parameters (the first B_real
    rows) within 1e-5 px, the tolerance of
    `test_sharded_steps_match_one_device` (optax and `torch.optim.Adam`
    round the same update differently in f32)."""
    b = make()
    B = b.curves0.shape[0]
    fitter = fitting.FontFitter(depth=DEPTH, backend=name, devices=CPU2)
    p, o, s = fitter.init(b)
    losses = fitter._graphed_steps(p, o, s, 3).numpy()
    assert isinstance(fitter._graph, fitting.ShardedStepGraph)
    np.testing.assert_allclose(losses, jax_mesh[f"{name}_k3_losses"], rtol=1e-5)
    for k in fitting.PARAM_KEYS:
        got, want = p[k].detach().numpy(), jax_mesh[f"{name}_k3_{k}"]
        if got.ndim:
            got, want = got[:B], want[:B]
        start = b.curves0[:B] if k == "curves" else 0.0
        assert np.abs(want - start).max() > 1e-3, k  # it moved
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
