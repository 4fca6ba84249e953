"""The graphed sharded `FontFitter.step_many` (the port of the JAX
`_step_k` over `shard_map`), on the CPU.

On CUDA devices a sharded fitter's `step_many` replays a
`models.fitting.ShardedStepGraph`: one CUDA graph a shard of the shard's
sum and its gradient, the rows copied into each shard's leaves before
and the sums and gradients gathered on the first device after, and Adam
outside. The CPU has no graphs, so these tests run the same
decomposition without the capture (``capture=False``), over stand-ins of
the CPU device (`parallel.mesh.local_devices(n, "cpu")`). It must be
bit-equal to the eager sharded `FontFitter.step` (tolerance: none),
``log_gain``'s gradient included: it is summed over the shards in the
order autograd sums it. `tests/test_torch_fit_sharded.py` holds the same
decomposition against the JAX mesh fitter's `step_many`;
`chip_smoke.py` phase 6 holds the captured graphs against the eager step
on the card.
"""

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.parallel import mesh
from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

DEPTH = 2
KEYS = fitting.PARAM_KEYS


def _batch(n, seed=1):
    return synth_fit_batch(n, 65, seed=seed, depth=DEPTH, perturb=0.3)


def _fitter(backend, n_devices=2):
    return fitting.FontFitter(depth=DEPTH, backend=backend,
                              devices=mesh.local_devices(n_devices, "cpu"))


def _assert_same_state(p1, o1, p2, o2):
    for k in KEYS:
        np.testing.assert_array_equal(p1[k].detach().numpy(), p2[k].detach().numpy(), err_msg=k)
        for s in ("exp_avg", "exp_avg_sq", "step"):
            np.testing.assert_array_equal(o1.state[p1[k]][s].numpy(), o2.state[p2[k]][s].numpy())


# (backend, glyphs, devices, seed): the flat backend pads 5 glyphs to 6
# over two devices; the torch backend needs an even split; on six
# shards the order of log_gain's sum matters (`test_log_gain_sum_order`).
CASES = [("flat", 5, 2, 1), ("torch", 4, 2, 1), ("torch", 12, 6, 5)]


@pytest.mark.parametrize("backend,n,n_devices,seed", CASES)
def test_sharded_graph_decomposition_equals_step(backend, n, n_devices, seed):
    """3 steps through the sharded graph's decomposition equal 3 eager
    sharded `step` calls bit for bit: losses, parameters (padded rows
    included) and Adam's state. No parameter keeps a gradient after."""
    fitter = _fitter(backend, n_devices)
    p1, o1, s1 = fitter.init(_batch(n, seed))
    want = torch.stack([fitter.step(p1, o1, s1)[2] for _ in range(3)])
    p2, o2, s2 = fitter.init(_batch(n, seed))
    got = fitter._graphed_steps(p2, o2, s2, 3)
    graph = fitter._graph
    assert isinstance(graph, fitting.ShardedStepGraph) and len(graph.shards) == n_devices
    assert all(g.graph is None for g in graph.shards)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
    _assert_same_state(p1, o1, p2, o2)
    assert all(p2[k].grad is None for k in KEYS)


def test_log_gain_sum_order():
    """The shards' ``log_gain`` gradients, added last shard first, give
    the eager gradient's bits; added in shard order they do not (six
    shards of the torch backend)."""
    fitter = _fitter("torch", 6)
    p, _, s = fitter.init(_batch(12, seed=5))
    _, want = fitter.value_and_grad(p, s)
    graph = fitting.ShardedStepGraph(fitter._loss, p, s, capture=False)
    _, grads = graph.replay()
    parts = [g.grads[KEYS.index("log_gain")] for g in graph.shards]
    in_order = parts[0]
    for g in parts[1:]:
        in_order = in_order + g
    assert grads[KEYS.index("log_gain")].item() == want["log_gain"].item()
    assert in_order.item() != want["log_gain"].item()


def test_shard_leaves_and_pools(monkeypatch):
    """Shard 0's leaves alias its parameter rows; the other shards' are
    buffers of their own that each replay fills with the current rows.
    Every shard's capture gets the one dict of pools (a pool a
    device), in shard order, with the cotangent 1/B_real."""
    seen = []

    def record(self, dev):
        seen.append((dev, self._pools))

    monkeypatch.setattr(fitting.StepGraph, "_capture", record)
    fitter = _fitter("flat")
    p, _, s = fitter.init(_batch(5))
    graph = fitting.ShardedStepGraph(fitter._loss, p, s, capture=True)
    assert [d for d, _ in seen] == [torch.device("cpu")] * 2
    assert seen[0][1] is seen[1][1]
    leaves0 = graph.shards[0]._keyed[0]
    assert leaves0["curves"].data_ptr() == p["curves"].data_ptr()
    assert leaves0["log_gain"].data_ptr() == p["log_gain"].data_ptr()
    (rows, own), = graph._own
    assert rows == slice(3, 6) and own["curves"].data_ptr() != p["curves"][3:].data_ptr()
    with torch.no_grad():
        p["curves"].add_(1.0)
        p["log_gain"].fill_(0.25)
    graph.shards[0].graph = graph.shards[1].graph = None  # replay the decomposition
    loss, grads = graph.replay()
    assert torch.equal(own["curves"], p["curves"][3:].detach()) and own["log_gain"].item() == 0.25
    want_loss, want = fitter.value_and_grad(p, s)
    assert loss.item() == want_loss.item()
    for k, g in zip(KEYS, grads):
        assert torch.equal(g, want[k]), k


def test_sharded_graph_cache_key(tmp_path):
    """The graph is keyed on the parameters and every shard's tensors:
    kept for the same tensors and across `restore_checkpoint` (an
    in-place copy), made anew after `init`; 2 + 3 steps through the
    checkpoint equal 5 straight ones."""
    fitter = _fitter("flat")
    p, o, s = fitter.init(_batch(5))
    fitter._graphed_steps(p, o, s, 2)
    graph = fitter._graph
    assert fitter._step_graph(p, s) is graph
    assert graph.key == fitting._graph_key(p, s) != fitting._graph_key(p, s[:1])
    path = str(tmp_path / "ckpt")
    fitting.FontFitter.save_checkpoint(path, p, o)
    fitter._graphed_steps(p, o, s, 3)
    fitting.FontFitter.restore_checkpoint(path, like=(p, o))
    losses = fitter._graphed_steps(p, o, s, 3)
    assert fitter._graph is graph

    p5, o5, s5 = fitter.init(_batch(5))
    assert fitter._graph is None
    want = fitter._graphed_steps(p5, o5, s5, 5)
    np.testing.assert_array_equal(losses.numpy(), want[2:].numpy())
    _assert_same_state(p, o, p5, o5)
    assert fitter._graph is not graph and fitter._graph.key == fitting._graph_key(p5, s5)
    fitter._step_graph(p, s)  # other tensors: made anew
    assert fitter._graph.key == fitting._graph_key(p, s)


def test_a_failed_sharded_capture_raises(monkeypatch):
    """A capture that fails raises out of `step_many` on CUDA devices,
    which takes no step: nothing falls back to the loop over `step`."""
    fitter = _fitter("flat")
    p, o, s = fitter.init(_batch(5))
    before = {k: p[k].detach().clone() for k in KEYS}

    def fail(self, dev):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(fitting.StepGraph, "_capture", fail)
    monkeypatch.setattr(fitter, "device", torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="capture failed"):
        fitter.step_many(p, o, s, 3)
    assert fitter._graph is None and not o.state
    for k in KEYS:
        assert torch.equal(p[k].detach(), before[k])


@pytest.mark.parametrize("backend,n", [("flat", 5), ("torch", 4)])
def test_sharded_graph_resume_is_exact(tmp_path, backend, n):
    """5 + 5 steps through the decomposition and a checkpoint, into a
    fresh init, equal 10 (Δ = 0)."""
    fitter = _fitter(backend)
    p10, o10, s10 = fitter.init(_batch(n))
    fitter._graphed_steps(p10, o10, s10, 10)
    pa, oa, sa = fitter.init(_batch(n))
    fitter._graphed_steps(pa, oa, sa, 5)
    path = str(tmp_path / "ckpt")
    fitting.FontFitter.save_checkpoint(path, pa, oa)
    pb, ob, sb = fitter.init(_batch(n))
    pb, ob = fitting.FontFitter.restore_checkpoint(path, like=(pb, ob))
    fitter._graphed_steps(pb, ob, sb, 5)
    _assert_same_state(p10, o10, pb, ob)
