"""The port's fitting slice against the JAX package, on the CPU: the
glyph model, both gradient backends, the flat plan, Adam state carried
across, the ``fit`` CLI with ``--resume`` and ``--render``, the fitted
atlas, the synthesized fit batch and `Renderer.render_bitmaps`.

Small sizes: 4 glyphs of `utils.synth_font.build_ttf_curved` at depth 2.
Trajectories (several Adam steps) of the JAX package come from one
subprocess whose XLA CPU code has no FMA (``--xla_cpu_max_isa=AVX``):
jitted XLA code contracts multiply-adds into FMAs, which moves hard-min
argmins at near-ties and with them Adam's sign-like first steps; the
port rounds every multiply and add, as the TPU and the CUDA kernels do.
Tolerances are stated at each test.
"""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.font.entry import FontFileEntry
from versatiles_glyphs_tpu.models import fitting as jfit
from versatiles_glyphs_tpu.models import glyph_model as jgm
from versatiles_glyphs_tpu.render.driver import Renderer as JaxRenderer
from versatiles_glyphs_tpu_torch.cli import main as torch_main
from versatiles_glyphs_tpu_torch.models import fitting, glyph_model
from versatiles_glyphs_tpu_torch.models.render_fitted import render_fitted_pbfs
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.utils.synth_font import (
    SynthEntry,
    build_ttf_curved,
    curved_preps,
    synth_fit_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2
CPS = "65-68"
FONT = dict(n_glyphs=4, first_cp=65, seed=1)


def _batch(perturb=0.3):
    return synth_fit_batch(**FONT, depth=DEPTH, perturb=perturb)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


_JAX_SIDE = r"""
import sys, io, numpy as np, jax
from versatiles_glyphs_tpu.models import fitting as jf
from versatiles_glyphs_tpu.cli import main
batch_npz, font, out = sys.argv[1:4]
a = np.load(batch_npz)
batch = jf.FitBatch(**{k: a[k] for k in a.files})
res = {}
for backend in ("jnp", "pallas"):
    fitter = jf.FontFitter(depth=2, backend=backend, learning_rate=0.01)
    p, o, d = fitter.init(batch)
    p, o, _ = fitter.step_many(p, o, d, 5)
    adam = jax.tree.map(np.asarray, o)[0]
    res.update({f"{backend}_p5_{k}": np.asarray(v) for k, v in p.items()})
    res.update({f"{backend}_mu_{k}": adam.mu[k] for k in p})
    res.update({f"{backend}_nu_{k}": adam.nu[k] for k in p})
    res[f"{backend}_count"] = adam.count
    p, o, _ = fitter.step_many(p, o, d, 5)
    res.update({f"{backend}_p10_{k}": np.asarray(v) for k, v in p.items()})
np.savez(out + "/carry.npz", **res)
main(["fit", font, "--codepoints", "65-68", "--steps", "10", "--depth", "2",
      "-o", out + "/cli", "--render", "--render-backend", "tpu"], stdout=io.StringIO())
main(["fit", font, "--codepoints", "65-68", "--steps", "10", "--depth", "2", "--mesh", "2",
      "-o", out + "/cli_mesh", "--render", "--render-backend", "tpu"], stdout=io.StringIO())
"""


@pytest.fixture(scope="module")
def synth_font(tmp_path_factory):
    path = tmp_path_factory.mktemp("font") / "curved.ttf"
    path.write_bytes(build_ttf_curved(**FONT))
    return str(path)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, synth_font):
    """The JAX package's trajectories: 5 and 10 Adam steps of both
    backends from the perturbed synth batch, and its ``fit --render``
    CLI on the synth font (10 steps, the ``tpu`` renderer's CPU twin),
    on one device and over a mesh of two virtual CPU devices."""
    tmp = tmp_path_factory.mktemp("jax_fit")
    b = _batch()
    np.savez(tmp / "batch.npz", **{k: v for k, v in vars(b).items() if v is not None})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 --xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(tmp / "batch.npz"), synth_font, str(tmp)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "carry.npz")), tmp / "cli"


# -- glyph model ----------------------------------------------------------


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(7)
    curves = rng.uniform(-2.0, 14.0, size=(3, 5, 4, 2)).astype(np.float32)
    mask = rng.uniform(size=(3, 5)) > 0.2
    px = rng.uniform(-3.0, 16.0, size=(3, 60)).astype(np.float32)
    py = rng.uniform(-3.0, 16.0, size=(3, 60)).astype(np.float32)
    return curves, mask, px, py


@pytest.mark.parametrize("sharpness", [None, 4.0])
def test_glyph_field_matches_jax(soup, sharpness):
    """Field values within 1e-5 (XLA and PyTorch sum the softmin in
    another order) and the gradient w.r.t. the curves within
    1e-4·max|g| against the vmapped JAX model."""
    curves, mask, px, py = soup
    tr = np.array([[0.25, -0.5]] * 3, np.float32)
    wts = np.random.default_rng(2).normal(size=px.shape).astype(np.float32)

    def jloss(c):
        f = jax.vmap(lambda c, m, t, x, y: jgm.glyph_field(c, m, t, x, y, depth=DEPTH,
                                                          sharpness=sharpness))(c, mask, tr, px, py)
        return (f * wts).sum(), f

    (_, jf), jg = jax.value_and_grad(jloss, has_aux=True)(curves)
    c = torch.tensor(curves, requires_grad=True)
    f = glyph_model.glyph_field(c, torch.tensor(mask), torch.tensor(tr), torch.tensor(px),
                                torch.tensor(py), depth=DEPTH, sharpness=sharpness)
    (f * torch.tensor(wts)).sum().backward()
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(c.grad.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_curve_helpers_match_jax(soup):
    """Degree elevation, subdivision and chords: exact (same op order);
    quantization and its inverse: exact."""
    curves = soup[0]
    s, c, e = curves[..., 0, :], curves[..., 1, :], curves[..., 2, :]
    np.testing.assert_array_equal(
        glyph_model.elevate_quadratic(*map(torch.tensor, (s, c, e))).numpy(),
        np.asarray(jgm.elevate_quadratic(s, c, e)))
    np.testing.assert_array_equal(
        glyph_model.curves_to_segments(torch.tensor(curves), 3).numpy(),
        np.asarray(jgm.curves_to_segments(curves, 3)))
    field = np.linspace(-9.0, 9.0, 501, dtype=np.float32)
    np.testing.assert_array_equal(glyph_model.field_to_bytes(torch.tensor(field)).numpy(),
                                  np.asarray(jgm.field_to_bytes(field)))
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(glyph_model.bytes_to_field(torch.tensor(b)).numpy(),
                                  np.asarray(jgm.bytes_to_field(b)))


def test_sdf_loss_matches_jax():
    rng = np.random.default_rng(4)
    pred, tgt = (rng.uniform(-12, 12, size=(3, 40)).astype(np.float32) for _ in range(2))
    pred[0, :3] = [8.0, -8.0, 12.0]  # clip edges
    mask = (rng.uniform(size=(3, 40)) > 0.3).astype(np.float32)
    want = np.asarray(jax.vmap(jgm.sdf_loss)(pred, tgt, mask))
    got = glyph_model.sdf_loss(torch.tensor(pred), torch.tensor(tgt), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = glyph_model.sdf_loss(torch.tensor(pred[0]), torch.tensor(tgt[0]))
    np.testing.assert_allclose(one.item(), float(jgm.sdf_loss(pred[0], tgt[0])), rtol=1e-6)


# -- backends, plan, optimizer -------------------------------------------


def test_flat_plan_matches_jax():
    b = _batch()
    want = jfit.build_flat_plan(b.curve_mask, b.meta, DEPTH, b.target.shape[1])
    got = fitting.build_flat_plan(b.curve_mask, b.meta, DEPTH, b.target.shape[1])
    for f in ("K", "N", "T", "TP", "L_max"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("tmeta", "mask_words", "row_map", "chunk_map"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_flat_chain_points_matches_jax():
    """Within 1e-5 px: both are one f32 matmul, summed in another order."""
    b = _batch()
    plan = jfit.build_flat_plan(b.curve_mask, b.meta, DEPTH, b.target.shape[1])
    tr = np.random.default_rng(1).normal(size=(b.curves0.shape[0], 2)).astype(np.float32)
    want = np.asarray(jfit.flat_chain_points(b.curves0, tr, DEPTH, plan.chunk_map, plan.inv_chunk))
    got = fitting.flat_chain_points(torch.tensor(b.curves0), torch.tensor(tr), DEPTH,
                                    torch.as_tensor(plan.chunk_map).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "jax_backend,backend,sharpness",
    [("jnp", "torch", None), ("jnp", "torch", 2.0), ("pallas", "flat", None)],
)
def test_backend_loss_and_grads_match_jax(jax_backend, backend, sharpness):
    """Loss within 1e-5 relative and every gradient within 1e-4·max|g|
    of the JAX package's backend on the same parameters."""
    b = _batch()
    jf = jfit.FontFitter(depth=DEPTH, backend=jax_backend, sharpness=sharpness)
    jp, _, jd = jf.init(b)
    if jax_backend == "pallas":
        lj, gj = jax.value_and_grad(jf._kernel_loss)(jp, jd)
    else:
        lj, gj = jax.value_and_grad(jfit.batch_loss)(jp, jd, DEPTH, sharpness)
    tf = fitting.FontFitter(depth=DEPTH, backend=backend, sharpness=sharpness, device="cpu")
    tp, _, td = tf.init(b)
    lt, gt = tf.value_and_grad(tp, td)
    assert abs(lt.item() - float(lj)) <= 1e-5 * abs(float(lj))
    for k in fitting.PARAM_KEYS:
        want = np.asarray(gj[k])
        np.testing.assert_allclose(gt[k].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_torch_backend_finite_differences():
    b = _batch()
    fitter = fitting.FontFitter(depth=DEPTH, backend="torch", device="cpu")
    params, _, dev = fitter.init(b)
    _, grads = fitter.value_and_grad(params, dev)
    rng = np.random.default_rng(12)
    v = {k: torch.from_numpy(rng.normal(size=tuple(params[k].shape)).astype(np.float32))
         for k in fitting.PARAM_KEYS}
    norm = float(torch.sqrt(sum((x * x).sum() for x in v.values())))
    eps = 1e-2
    with torch.no_grad():
        lp = fitter.loss({k: params[k] + eps * v[k] / norm for k in v}, dev)
        lm = fitter.loss({k: params[k] - eps * v[k] / norm for k in v}, dev)
    fd = float(lp - lm) / (2 * eps)
    an = float(sum((grads[k] * v[k] / norm).sum() for k in v))
    # Loose, as for the flat loss: the hard min has kinks in the stencil.
    assert abs(fd - an) < 0.1 * max(abs(fd), 1e-3), (fd, an)


@pytest.mark.parametrize("jax_backend,backend", [("jnp", "torch"), ("pallas", "flat")])
def test_carried_jax_state_continues(jax_runs, jax_backend, backend):
    """The JAX package takes 5 Adam steps; `params_from_numpy` and
    `adam_state_from_optax` carry its parameters and optax state to the
    port, which takes 5 more. The result matches the JAX package's 10
    steps within 1e-5 px: optax and `torch.optim.Adam` round the same
    update differently in f32 (measured: ≤ 1e-6)."""
    carry, _ = jax_runs
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, device="cpu")
    _, _, dev = fitter.init(_batch())
    params = fitting.params_from_numpy(
        {k: carry[f"{jax_backend}_p5_{k}"] for k in fitting.PARAM_KEYS}, device="cpu"
    )
    opt = torch.optim.Adam([params[k] for k in fitting.PARAM_KEYS], lr=0.01)

    class Adam:  # optax's ScaleByAdamState, as numpy
        count = carry[f"{jax_backend}_count"]
        mu = {k: carry[f"{jax_backend}_mu_{k}"] for k in fitting.PARAM_KEYS}
        nu = {k: carry[f"{jax_backend}_nu_{k}"] for k in fitting.PARAM_KEYS}

    opt.load_state_dict(fitting.adam_state_from_optax((Adam, ()), opt))
    assert int(opt.state_dict()["state"][0]["step"]) == 5
    params, opt, losses = fitter.step_many(params, opt, dev, 5)
    assert np.isfinite(losses).all()
    for k in fitting.PARAM_KEYS:
        want = carry[f"{jax_backend}_p10_{k}"]
        assert np.abs(want - carry[f"{jax_backend}_p5_{k}"]).max() > 1e-3  # it moved
        np.testing.assert_allclose(params[k].detach().numpy(), want, rtol=0, atol=1e-5, err_msg=k)


def test_step_many_matches_sequential():
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    p1, o1, dev = fitter.init(_batch())
    seq = [fitter.step(p1, o1, dev)[2].item() for _ in range(4)]
    p2, o2, _ = fitter.init(_batch())
    p2, o2, losses = fitter.step_many(p2, o2, dev, 4)
    np.testing.assert_array_equal(losses, np.asarray(seq, np.float32))
    np.testing.assert_array_equal(p2["curves"].detach().numpy(), p1["curves"].detach().numpy())


def test_fit_logs_history():
    """`FontFitter.fit` steps in chunks and logs every ``log_every``-th
    step and the last one; the losses are those of `step_many`."""
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    params, history = fitter.fit(_batch(), steps=5, log_every=2)
    p, o, dev = fitter.init(_batch())
    _, _, losses = fitter.step_many(p, o, dev, 5)
    assert history == [(s, float(losses[s])) for s in (0, 2, 4)]
    np.testing.assert_array_equal(params["curves"].detach().numpy(), p["curves"].detach().numpy())


def test_checkpoint_roundtrip(tmp_path):
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    params, opt, dev = fitter.init(_batch())
    params, opt, _ = fitter.step_many(params, opt, dev, 2)
    path = str(tmp_path / "ckpt")
    fitting.FontFitter.save_checkpoint(path, params, opt)
    p2, o2, _ = fitter.init(_batch())
    p2, o2 = fitting.FontFitter.restore_checkpoint(path, like=(p2, o2))
    for k in fitting.PARAM_KEYS:
        np.testing.assert_array_equal(p2[k].detach().numpy(), params[k].detach().numpy())
        for s in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(o2.state[p2[k]][s].numpy(),
                                          opt.state[params[k]][s].numpy())
    assert torch.load(path, weights_only=True)["step"] == 2


def test_fitter_rejects_bad_config(monkeypatch):
    with pytest.raises(ValueError):
        fitting.FontFitter(backend="flat", sharpness=8.0, device="cpu")
    with pytest.raises(ValueError):
        fitting.FontFitter(backend="pallas", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fitting.FontFitter(backend="flat")


# -- batches --------------------------------------------------------------


def test_synth_fit_batch_equals_make_fit_batch():
    """The fontTools-free batch equals the one built from the same
    outlines as a TTF, array for array, and so does the JAX package's."""
    entry = FontFileEntry(build_ttf_curved(**FONT))
    want = fitting.make_fit_batch(entry, range(65, 69), depth=DEPTH)
    jax_batch = jfit.make_fit_batch(entry, list(range(65, 69)), depth=DEPTH)
    got = synth_fit_batch(**FONT, depth=DEPTH)
    for f in ("curves0", "curve_mask", "px", "py", "pix_mask", "target", "meta", "codepoints"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(getattr(jax_batch, f), getattr(want, f), err_msg=f)
    noisy = synth_fit_batch(**FONT, depth=DEPTH, perturb=0.3)
    moved = noisy.curves0 != got.curves0
    assert moved[got.curve_mask].any() and not moved[~got.curve_mask].any()


def test_synth_entry_matches_font_entry():
    entry = FontFileEntry(build_ttf_curved(**FONT))
    synth = SynthEntry(**FONT)
    assert synth.units_per_em == entry.units_per_em
    for cp in range(60, 72):
        name = entry.glyph_name(cp)
        assert synth.glyph_name(cp) == name
        if name is not None:
            assert synth.hor_advance(name) == entry.hor_advance(name)
    a, b = entry.metadata, synth.metadata
    assert (a.family, a.style, a.weight, a.width, list(a.codepoints), a.generate_name()) == (
        b.family, b.style, b.weight, b.width, b.codepoints, b.generate_name())


# -- renderer and atlas ---------------------------------------------------


def test_render_bitmaps_matches_jax():
    """`Renderer.render_bitmaps` with the torch backend equals the JAX
    renderer's (``tpu``, its CPU twin) byte for byte."""
    preps = curved_preps(7, 65, seed=5)
    want = JaxRenderer("tpu").render_bitmaps(preps, parallel=False)
    got = Renderer("torch").render_bitmaps(preps)
    assert len(got) == len(want) == 7 and Renderer("torch").render_bitmaps([]) == []
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_fitted_matches_jax(jax_runs, synth_font):
    """The port renders the JAX CLI's fitted parameters into the same
    atlas tree, byte for byte, as the JAX CLI's ``fit --render``."""
    _, cli = jax_runs
    fitted = dict(np.load(cli / "fitted.npz"))
    entry = FontFileEntry(open(synth_font, "rb").read())
    batch = fitting.make_fit_batch(entry, range(65, 69), depth=DEPTH)
    np.testing.assert_array_equal(batch.codepoints, fitted["codepoints"])
    out = cli.parent / "port_glyphs"
    name = os.listdir(cli / "glyphs")
    name = next(n for n in name if os.path.isdir(cli / "glyphs" / n))
    written = render_fitted_pbfs(fitted, batch, entry, DEPTH, str(out), name,
                                 renderer=Renderer("torch"))
    assert written == ["0-255.pbf"]
    want = _tree(cli / "glyphs")
    assert _tree(out) == want and len(want) == 3


# -- CLI ------------------------------------------------------------------


def test_fit_cli_matches_jax(tmp_path, jax_runs, synth_font):
    """The port's ``fit --render`` (torch backend, on the CPU) against the
    JAX CLI's (jnp backend): the same fitted.npz keys, shapes, codepoints
    and curve mask, the same history steps and atlas files. Parameters
    within 0.01 px (one learning-rate step) and losses within 1e-3
    relative after 10 steps: a self-fit starts at the optimum, where many
    gradients are at rounding level, and Adam's normalized steps move
    such a parameter by up to the learning rate either way (measured:
    0.0048 px). The tight trajectory check, from a perturbed start, is
    `test_carried_jax_state_continues`."""
    _, cli = jax_runs
    out = tmp_path / "port"
    torch_main(["fit", synth_font, "--codepoints", CPS, "--steps", "10", "--depth", "2",
                "-o", str(out), "--device", "cpu", "--render", "--render-backend", "torch"],
               stdout=io.StringIO())
    want, got = np.load(cli / "fitted.npz"), np.load(out / "fitted.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("codepoints", "curve_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("curves", "translate", "log_gain"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.01, err_msg=k)
    hj = json.loads((cli / "history.json").read_text())
    hp = json.loads((out / "history.json").read_text())
    assert [h["step"] for h in hp] == [h["step"] for h in hj] == list(range(10))
    np.testing.assert_allclose([h["loss"] for h in hp], [h["loss"] for h in hj], rtol=1e-3)
    assert os.path.isfile(out / "checkpoint")
    assert sorted(_tree(out / "glyphs")) == sorted(_tree(cli / "glyphs"))


@pytest.mark.parametrize("backend", ["torch", "flat"])
def test_fit_cli_resume(tmp_path, synth_font, backend):
    """Two 5-step runs, the second resumed from the first's checkpoint,
    land exactly where one 10-step run does."""
    base = ["fit", synth_font, "--codepoints", CPS, "--depth", "2", "--device", "cpu",
            "--backend", backend]
    torch_main(base + ["--steps", "10", "-o", str(tmp_path / "one")], stdout=io.StringIO())
    torch_main(base + ["--steps", "5", "-o", str(tmp_path / "a")], stdout=io.StringIO())
    torch_main(base + ["--steps", "5", "-o", str(tmp_path / "b"),
                       "--resume", str(tmp_path / "a" / "checkpoint")], stdout=io.StringIO())
    a, b = np.load(tmp_path / "one" / "fitted.npz"), np.load(tmp_path / "b" / "fitted.npz")
    for k in ("curves", "translate", "log_gain"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["curves"], np.load(tmp_path / "a" / "fitted.npz")["curves"])


def test_fit_cli_mesh_matches_jax(tmp_path, jax_runs, synth_font):
    """``fit --mesh 2 --render`` of the port (torch backend, two CPU
    stand-ins) against the JAX CLI's ``fit --mesh 2`` (jnp backend, two
    virtual CPU devices): ``fitted.npz`` has the real batch's rows and
    agrees within `test_fit_cli_matches_jax`'s tolerance (0.01 px, losses
    within 1e-3 relative), with the same history steps and atlas files."""
    _, cli = jax_runs
    want_dir = cli.parent / "cli_mesh"
    out = tmp_path / "port"
    torch_main(["fit", synth_font, "--codepoints", CPS, "--steps", "10", "--depth", "2",
                "--mesh", "2", "-o", str(out), "--device", "cpu", "--render",
                "--render-backend", "torch"], stdout=io.StringIO())
    want, got = np.load(want_dir / "fitted.npz"), np.load(out / "fitted.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["curves"].shape[0] == 4
    for k in ("codepoints", "curve_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("curves", "translate", "log_gain"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.01, err_msg=k)
    hj = json.loads((want_dir / "history.json").read_text())
    hp = json.loads((out / "history.json").read_text())
    assert [h["step"] for h in hp] == [h["step"] for h in hj] == list(range(10))
    np.testing.assert_allclose([h["loss"] for h in hp], [h["loss"] for h in hj], rtol=1e-3)
    assert sorted(_tree(out / "glyphs")) == sorted(_tree(want_dir / "glyphs"))


@pytest.mark.parametrize("backend", ["torch", "flat"])
def test_fit_cli_mesh_resume_and_render(tmp_path, synth_font, backend):
    """After ``fit --mesh 2``: two 5-step runs, the second resumed from
    the first's checkpoint, land exactly where one 10-step run does
    (3 glyphs for the flat backend, so a fourth is padded and sliced off
    ``fitted.npz``); ``--render`` of the resumed run is the atlas of its
    ``fitted.npz``, byte for byte; resuming over one device is refused
    where the padding differs."""
    cps = "65-67" if backend == "flat" else CPS
    base = ["fit", synth_font, "--codepoints", cps, "--depth", "2", "--device", "cpu",
            "--backend", backend, "--mesh", "2"]
    torch_main(base + ["--steps", "10", "-o", str(tmp_path / "one")], stdout=io.StringIO())
    torch_main(base + ["--steps", "5", "-o", str(tmp_path / "a")], stdout=io.StringIO())
    torch_main(base + ["--steps", "5", "-o", str(tmp_path / "b"), "--render",
                       "--render-backend", "torch",
                       "--resume", str(tmp_path / "a" / "checkpoint")], stdout=io.StringIO())
    a, b = np.load(tmp_path / "one" / "fitted.npz"), np.load(tmp_path / "b" / "fitted.npz")
    assert b["curves"].shape[0] == len(b["codepoints"]) == (3 if backend == "flat" else 4)
    for k in ("curves", "translate", "log_gain"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    entry = FontFileEntry(open(synth_font, "rb").read())
    batch = fitting.make_fit_batch(entry, range(65, 65 + len(b["codepoints"])), depth=DEPTH)
    name = next(n for n in os.listdir(tmp_path / "b" / "glyphs")
                if os.path.isdir(tmp_path / "b" / "glyphs" / n))
    render_fitted_pbfs(dict(b), batch, entry, DEPTH, str(tmp_path / "again"), name,
                       renderer=Renderer("torch"))
    assert _tree(tmp_path / "again") == _tree(tmp_path / "b" / "glyphs")
    if backend == "flat":
        with pytest.raises(ValueError, match="same number of devices"):
            torch_main(base[:-2] + ["--steps", "1", "-o", str(tmp_path / "c"),
                                    "--resume", str(tmp_path / "a" / "checkpoint")],
                       stdout=io.StringIO())


def test_fit_path_never_loads_jax(tmp_path):
    """The fit path below the CLI in a fresh interpreter (this process has
    JAX loaded): a synthesized batch, flat steps and the padded-layout
    `batch_loss_kernel` on the CPU, the segment-layout renders of
    `ops.legacy`, the fitted atlas through the torch renderer; no JAX,
    optax, orbax or fontTools."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from versatiles_glyphs_tpu_torch.models.fitting import FontFitter, batch_loss_kernel\n"
        "from versatiles_glyphs_tpu_torch.models.render_fitted import render_fitted_pbfs\n"
        "from versatiles_glyphs_tpu_torch.ops import legacy\n"
        "from versatiles_glyphs_tpu_torch.render.batch import pack_flat\n"
        "from versatiles_glyphs_tpu_torch.render.driver import Renderer\n"
        "from versatiles_glyphs_tpu_torch.utils.synth_font import SynthEntry, curved_preps, synth_fit_batch\n"
        "import torch\n"
        "b = synth_fit_batch(3, 65, seed=2, depth=2, perturb=0.3)\n"
        "f = FontFitter(depth=2, backend='flat', device='cpu')\n"
        "p, o, d = f.init(b)\n"
        "lk = batch_loss_kernel(p, d, 2)\n"
        "lk.backward()\n"
        "assert torch.isfinite(lk) and p['curves'].grad.abs().max() > 0\n"
        "flat, meta, P = pack_flat(curved_preps(3, 65, seed=2))\n"
        "g = legacy.render_bitmaps_cuda_grid(torch.from_numpy(flat), torch.from_numpy(meta), P,\n"
        "                                    min(1024, P))\n"
        "assert g.shape == (3, P) and g.any()\n"
        "p, o, losses = f.step_many(p, o, d, 2)\n"
        f"w = render_fitted_pbfs(p, b, SynthEntry(3, 65, seed=2), 2, {str(tmp_path / 'out')!r},\n"
        "                       'synth', renderer=Renderer('torch'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'orbax', 'fontTools', 'versatiles_glyphs_tpu'))\n"
        "assert not bad, bad\n"
        "print('CLEAN', w)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN ['0-255.pbf']" in proc.stdout
