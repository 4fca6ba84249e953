"""The graphed `FontFitter.step_many` (the port of the JAX `_step_k`), on
the CPU.

On one CUDA device `step_many` replays a CUDA graph of the step's
forward and backward (`models.fitting.StepGraph`) and runs Adam outside
it. The CPU has no graphs, so these tests run the same decomposition
without the capture: `StepGraph(..., capture=False)` computes the loss
and `torch.autograd.grad` of it at each replay, and
`FontFitter._graphed_steps` sets each ``.grad`` from them and steps
Adam, as on the card. It must be bit-equal to `FontFitter.step`
(tolerance: none). `step_many` itself loops over `step` on the CPU and
on a sharded fitter. `chip_smoke.py` phase 5 holds the captured graph
against `step` on the card, bit for bit.
"""

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.ops import sdf_cuda
from versatiles_glyphs_tpu_torch.parallel import mesh
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

DEPTH = 2
KEYS = fitting.PARAM_KEYS


def _batch():
    return synth_fit_batch(4, 65, seed=1, depth=DEPTH, perturb=0.3)


def _assert_same_state(p1, o1, p2, o2):
    for k in KEYS:
        np.testing.assert_array_equal(p1[k].detach().numpy(), p2[k].detach().numpy(), err_msg=k)
        for s in ("exp_avg", "exp_avg_sq", "step"):
            np.testing.assert_array_equal(o1.state[p1[k]][s].numpy(), o2.state[p2[k]][s].numpy())


@pytest.mark.parametrize("backend", ["torch", "flat"])
def test_graph_decomposition_equals_step(backend):
    """10 steps through the graph's decomposition equal 10 `step` calls
    bit for bit: losses, parameters and Adam's state. A loss graph the
    caller still holds on the parameters changes nothing."""
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, device="cpu")
    p1, o1, d1 = fitter.init(_batch())
    want = torch.stack([fitter.step(p1, o1, d1)[2] for _ in range(10)])
    p2, o2, d2 = fitter.init(_batch())
    held = fitter.loss(p2, d2)
    got = fitter._graphed_steps(p2, o2, d2, 10)
    assert held.requires_grad and fitter._graph.graph is None
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    _assert_same_state(p1, o1, p2, o2)
    # The static gradients stay the graph's: no parameter keeps one.
    assert all(p2[k].grad is None for k in KEYS)


@pytest.mark.parametrize("backend", ["torch", "flat"])
@pytest.mark.parametrize("sharded", [False, True])
def test_step_many_equals_steps_on_cpu(backend, sharded):
    """On the CPU, and over devices (two stand-ins of the CPU device),
    `step_many` is k calls of `step`: no graph is made."""
    kw = {"devices": mesh.local_devices(2, "cpu")} if sharded else {"device": "cpu"}
    fitter = fitting.FontFitter(depth=DEPTH, backend=backend, **kw)
    p1, o1, d1 = fitter.init(_batch())
    want = np.asarray([fitter.step(p1, o1, d1)[2].item() for _ in range(4)], np.float32)
    p2, o2, d2 = fitter.init(_batch())
    _, _, got = fitter.step_many(p2, o2, d2, 4)
    np.testing.assert_array_equal(got, want)
    _assert_same_state(p1, o1, p2, o2)
    assert fitter._graph is None


def test_graph_cache_key(tmp_path):
    """The graph is kept for the same tensors, also across
    `restore_checkpoint` (which copies in place); other tensors and a new
    `init` drop it."""
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    p, o, d = fitter.init(_batch())
    fitter._graphed_steps(p, o, d, 2)
    graph = fitter._graph
    assert fitter._step_graph(p, d) is graph
    path = str(tmp_path / "ckpt")
    fitting.FontFitter.save_checkpoint(path, p, o)
    fitter._graphed_steps(p, o, d, 3)
    fitting.FontFitter.restore_checkpoint(path, like=(p, o))
    losses = fitter._graphed_steps(p, o, d, 3)
    assert fitter._graph is graph

    # 2 + 3 steps through the checkpoint equal 5 straight ones.
    p5, o5, d5 = fitter.init(_batch())
    assert fitter._graph is None
    want = fitter._graphed_steps(p5, o5, d5, 5)
    np.testing.assert_array_equal(losses.numpy(), want[2:].numpy())
    _assert_same_state(p, o, p5, o5)
    assert fitter._graph is not graph and fitter._graph.key == fitting._graph_key(p5, d5)
    fitter._step_graph(p, d)  # other tensors: captured anew
    assert fitter._graph.key == fitting._graph_key(p, d)


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises out of `step_many`, which takes no
    step: nothing falls back to the eager loop."""
    fitter = fitting.FontFitter(depth=DEPTH, backend="flat", device="cpu")
    p, o, d = fitter.init(_batch())
    before = {k: p[k].detach().clone() for k in KEYS}

    def fail(self, dev):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(fitting.StepGraph, "_capture", fail)
    monkeypatch.setattr(fitter, "device", torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="capture failed"):
        fitter.step_many(p, o, d, 3)
    assert fitter._graph is None and not o.state
    for k in KEYS:
        assert torch.equal(p[k].detach(), before[k])


def test_capture_and_replay_launch_counts():
    """`capturing` takes a capture's launches back out of the counts and
    reports them; `count_replay` adds them once a replay."""
    sdf_cuda.reset_launches()
    sdf_cuda.LAUNCHES["sdf_tiles_pts"] = 4
    with sdf_cuda.capturing() as recorded:
        sdf_cuda.LAUNCHES["sdf_min_field_pts"] += 1
        sdf_cuda.LAUNCHES["sdf_min_field_bwd"] += 1
        assert not recorded
    assert recorded["sdf_min_field_pts"] == recorded["sdf_min_field_bwd"] == 1
    assert sum(recorded.values()) == 2 and set(recorded) == set(sdf_cuda.KERNELS)
    assert sdf_cuda.LAUNCHES["sdf_min_field_pts"] == 0 and sdf_cuda.LAUNCHES["sdf_tiles_pts"] == 4
    for _ in range(3):
        sdf_cuda.count_replay(recorded)
    assert sdf_cuda.LAUNCHES["sdf_min_field_pts"] == sdf_cuda.LAUNCHES["sdf_min_field_bwd"] == 3
    sdf_cuda.reset_launches()
