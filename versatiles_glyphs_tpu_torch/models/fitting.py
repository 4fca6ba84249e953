"""Font fitting: gradient descent on outline control points
(counterpart of `versatiles_glyphs_tpu.models.fitting`).

Parameters, a dict of f32 leaf tensors:

- ``curves``    [B, C, 4, 2] — per-glyph cubic control points (pixels)
- ``translate`` [B, 2]       — per-glyph placement
- ``log_gain``  []           — a shared global scale

Two gradient backends:

- ``"torch"`` (the JAX package's ``jnp``): autograd of the pair-tensor
  model `models.glyph_model.glyph_field`, hard min or softmin;
- ``"flat"`` (the JAX package's ``pallas``): the flat point-chain /
  tile-table layout of `build_flat_plan` through one fused autograd node
  (`ops.sdf_grad.flat_fit_losses`), whose forward and backward are the
  hand-written min-field kernels with the chain and loss kernels of
  `ops.flat_loss` around them on a CUDA device, and their plain versions
  on the CPU. Hard min only. `flat_losses_reference` is the same loss
  as PyTorch ops and autograd, the reference of the CPU tests.

`batch_loss_kernel` is the JAX package's loss of the same name: the
padded per-glyph layout through `ops.sdf_grad.signed_field_padded` (the
padded min-field kernel pair). As there, no backend of `FontFitter`
uses it; it reads a batch of its own (`padded_batch`).

Sharded fitting (the JAX package's mesh path, ``fit --mesh``): one
process over a list of local devices (`parallel.mesh.local_devices`),
with no mesh object. `FontFitter(devices=...)` pads the batch of the
``flat`` backend to a multiple of the device count and gives each device
an equal slice of it (`split_batch`), with its own flat plan.
`make_sharded_flat_loss` and `make_sharded_kernel_loss` (each a
`ShardedLoss`) run the kernel pairs once a shard; the loss is the sum of
the shards' sums, each brought back to the first device, over the real
glyph count. The parameters stay whole on the first device, with one
optimizer there: each shard reads its rows with ``.to(device)``, and
autograd sums ``log_gain``'s gradient over the shards at that copy,
which is the all-reduce the JAX package's ``psum`` gives. They are kept
whole because they are small (~1-2 MB at 1,700 glyphs) and so keep the
one-device shapes of `save_checkpoint`, `value_and_grad`,
`params_from_numpy`, `adam_state_from_optax` and the CLI's
``fitted.npz``; a checkpoint of a sharded fit holds its padded rows, so
a resume needs the same device count.

One dispatch for k steps (the JAX package's `_step_k`, a `lax.scan`
under one jit): on one CUDA device `FontFitter.step_many` replays a CUDA
graph of the step's forward and backward (`StepGraph`), captured once
for each (params, device batch), and runs Adam outside it (one launch of
`ops.adam.adam_step` a step). Sharded over
CUDA devices (the `_step_k` over `shard_map`) it replays one such graph
a shard, each on the shard's device (`ShardedStepGraph`: one graph
cannot span devices), with the rows copied in and the sums and
gradients gathered on the first device outside them. The graphed steps
are bit-equal to `FontFitter.step`: the same kernels on the same shapes
and the same sums in the same order, only their enqueue changes. On the
CPU (which has no graphs) `step_many` loops over `step`.

A `torch.optim.Adam` takes optax's place, holding the options and the
state, and `ops.adam.adam_step` steps it; `torch.save` takes orbax's;
`params_from_numpy` and `adam_state_from_optax` carry a JAX run's
parameters and Adam state across. `make_fit_batch` reads a font file
through the entry it is given (`font.entry`); nothing here imports
fontTools, JAX, optax or orbax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import cuda_device
from ..ops.adam import adam_step
from ..ops.flat_loss import bernstein_matrix
from ..render.batch import S_BUCKETS, SC, bucket
from ..utils import trace
from .glyph_model import bytes_to_field, glyph_field, sdf_loss

PARAM_KEYS = ("curves", "translate", "log_gain")
BT = 4  # tile rows per TPU grid program: the flat plan pads T to a multiple


@dataclass
class FitBatch:
    """Host-side fitting workload (see `make_fit_batch`)."""

    curves0: np.ndarray  # [B, C, 4, 2] initial control points
    curve_mask: np.ndarray  # [B, C] bool
    px: np.ndarray  # [B, P] pixel-center x
    py: np.ndarray  # [B, P] pixel-center y
    pix_mask: np.ndarray  # [B, P] f32 (1 = real pixel)
    target: np.ndarray  # [B, P] target signed distances
    meta: np.ndarray | None = None  # [B, 4] i32 (x0, y0, w, h) per glyph
    codepoints: np.ndarray | None = None  # [B] i32: the FITTED codepoints


def params_from_numpy(params, device=None) -> dict:
    """Parameters as f32 leaf tensors that require grad, from numpy
    arrays (the JAX package's ``fitted.npz`` or `np.asarray` of its
    parameter pytree) under the keys ``curves``, ``translate``,
    ``log_gain``. ``device``: a torch device or its name; None or
    ``"cuda"`` is the first CUDA device and raises without one, as in
    `FontFitter`."""
    device = cuda_device() if device in (None, "cuda") else torch.device(device)
    return {
        k: torch.tensor(np.asarray(params[k], np.float32), device=device).requires_grad_()
        for k in PARAM_KEYS
    }


def init_params(curves0: np.ndarray, device=None) -> dict:
    """The start of a fit at control points ``curves0``: no translation,
    unit gain. ``device`` as in `params_from_numpy`."""
    return params_from_numpy(
        {
            "curves": curves0,
            "translate": np.zeros((curves0.shape[0], 2), np.float32),
            "log_gain": np.zeros((), np.float32),
        },
        device,
    )


def adam_state_from_optax(opt_state, opt: torch.optim.Adam) -> dict:
    """A state dict for ``opt.load_state_dict`` from an optax Adam state
    as numpy (``jax.tree.map(np.asarray, opt_state)``): the
    ``ScaleByAdamState`` (count, mu, nu), alone or inside optax.adam's
    chain tuple. ``opt`` must hold the parameters in `PARAM_KEYS` order.
    optax and `torch.optim.Adam` compute the same update but round it
    differently in f32."""
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next((s for s in parts if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    sd = opt.state_dict()
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    sd["state"] = {
        i: {
            "step": step.clone(),
            "exp_avg": torch.tensor(np.asarray(adam.mu[k], np.float32)),
            "exp_avg_sq": torch.tensor(np.asarray(adam.nu[k], np.float32)),
        }
        for i, k in enumerate(PARAM_KEYS)
    }
    return sd


def _glyph_losses(field, params, batch) -> torch.Tensor:
    """The masked SDF loss of each glyph [B] from its signed field."""
    return sdf_loss(field * torch.exp(params["log_gain"]), batch["target"], batch["pix_mask"])


def _pair_losses(params, batch: dict, depth: int, sharpness) -> torch.Tensor:
    field = glyph_field(
        params["curves"], batch["curve_mask"], params["translate"],
        batch["px"], batch["py"], depth=depth, sharpness=sharpness,
    )
    return _glyph_losses(field, params, batch)


def batch_loss(params, batch: dict, depth: int, sharpness) -> torch.Tensor:
    """Mean over glyphs of the masked SDF loss, the pair-tensor model
    broadcast over the batch (the JAX package vmaps it)."""
    return torch.mean(_pair_losses(params, batch, depth, sharpness))


def _padded_losses(params, batch: dict, depth: int) -> torch.Tensor:
    from ..ops.sdf_grad import signed_field_padded
    from .glyph_model import curves_to_segments

    curves = params["curves"] + params["translate"][:, None, None, :]
    segs = curves_to_segments(curves, depth)
    seg_mask = torch.repeat_interleave(batch["curve_mask"], 2**depth, dim=-1)
    field = signed_field_padded(segs, seg_mask, batch["meta"], batch["target"].shape[1])
    return _glyph_losses(field, params, batch)


def batch_loss_kernel(params, batch: dict, depth: int) -> torch.Tensor:
    """`batch_loss` with the signed field of the padded kernel pair
    (`ops.sdf_grad.signed_field_padded`) instead of the pair tensor;
    hard min only. ``batch``: `padded_batch`."""
    # Per-glyph masked mean, then the batch mean, as in `batch_loss`.
    return torch.mean(_padded_losses(params, batch, depth))


def _arrays_on(batch: FitBatch, device, names) -> dict:
    """The arrays ``names`` on ``device``: ``curve_mask`` as is, ``meta`` i32, the rest f32."""
    dtypes = {"curve_mask": None, "meta": torch.int32}
    return {k: torch.as_tensor(getattr(batch, k), dtype=dtypes.get(k, torch.float32),
                               device=device) for k in names}


def padded_batch(batch: FitBatch, device) -> dict:
    """The device batch of `batch_loss_kernel` (a shard's, of `make_sharded_kernel_loss`)
    on ``device``: ``curve_mask``, ``meta`` [B, 4] i32, ``target`` and ``pix_mask``."""
    return _arrays_on(batch, device, ("curve_mask", "meta", "target", "pix_mask"))


def split_batch(batch: FitBatch, n: int) -> tuple[FitBatch, list[FitBatch]]:
    """(``batch`` padded to a multiple of ``n`` glyphs as the JAX package
    pads its ``pallas`` mesh path, its ``n`` equal slices in order). Padded
    glyphs (all-false masks, ``w·h = 0`` metas) add 0 to every loss and gradient."""
    from ..parallel.mesh import pad_to_multiple

    arrays = {f.name: pad_to_multiple(getattr(batch, f.name), n)
              for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None}
    Bl = arrays["curves0"].shape[0] // n
    return FitBatch(**arrays), [FitBatch(**{k: a[d * Bl : (d + 1) * Bl] for k, a in arrays.items()})
                                for d in range(n)]


def eager_step(loss_fn, params, opt, batch) -> torch.Tensor:
    """One `ops.adam.adam_step` in place on ``loss_fn(params, batch)``; the loss, detached."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, batch)
    loss.backward()
    adam_step(opt)
    return loss.detach()


@dataclass
class FlatKernelPlan:
    """Static launch plan of the flat backend (see `build_flat_plan`)."""

    K: int  # chain points per curve (2^depth + 1)
    N: int  # flat lane count (a multiple of SC, with slack)
    T: int  # real tiles
    TP: int
    L_max: int  # bucketed max chain length (sizes the slack)
    tmeta: np.ndarray  # [T_pad, 8] i32 row-major tile table
    mask_words: np.ndarray  # [N//32] i32 validity bits
    row_map: np.ndarray  # [B, P_pad//TP] i32 field-row gather map
    chunk_map: np.ndarray  # [N//128] i32: lane chunk → source 128-block
    glyph_rows: np.ndarray  # [B, 4] i32: first tile row, w·h, first lane, npts


def build_flat_plan(
    curve_mask: np.ndarray,
    metas: np.ndarray,
    depth: int,
    P_pad: int,
    TP: int = 256,
) -> FlatKernelPlan:
    """Host-side static plan of the flat backend, array for array the
    JAX package's (`models.fitting.build_flat_plan`).

    Glyph ``g``'s chain takes lanes ``[offs_g, offs_g + npts_g)``,
    ``npts_g = ncurves_g·K``, at tight SC-aligned offsets; each curve
    gives its K points with the last one's validity bit cleared (a chain
    break). Glyph g owns ``ceil(w·h / TP)`` consecutive tile rows whose
    pix_base runs 0, TP, 2·TP, …, which is also the per-glyph table the
    backward kernel reads (first row: pix_base 0). The table is padded
    to a multiple of BT with skip rows. ``chunk_map`` maps each 128-lane
    chunk to a 128-point block of the chain tensor; ``row_map[g, t]``
    maps loss-layout pixel tiles to field rows (out-of-range tiles point
    at the glyph's last tile; their pixels are masked). ``glyph_rows``
    is the fused loss's glyph table (`ops.flat_loss`): each glyph's first
    tile row, w·h, first lane and chain points."""
    B, C_pad = curve_mask.shape
    K = (1 << depth) + 1
    npts = curve_mask.sum(axis=1).astype(np.int64) * K
    runs = -(-np.maximum(npts, 1) // SC) * SC
    offs = np.concatenate([[0], np.cumsum(runs)[:-1]])
    wh = metas[:, 2].astype(np.int64) * metas[:, 3].astype(np.int64)
    ntiles = np.maximum(1, -(-wh // TP))
    tstart = np.concatenate([[0], np.cumsum(ntiles)[:-1]])
    T = int(ntiles.sum())
    T_pad = -(-T // BT) * BT

    tmeta = np.zeros((T_pad, 8), np.int32)
    g_of = np.repeat(np.arange(B), ntiles)
    tmeta[:T, :4] = metas[g_of, :4]
    tmeta[:T, 4] = npts[g_of]
    tmeta[:T, 5] = offs[g_of]
    tmeta[:T, 6] = (np.arange(T) - tstart[g_of]) * TP

    L_max = bucket(int(npts.max(initial=1)), S_BUCKETS)
    N = int(runs.sum()) + -(-(L_max + 1) // SC) * SC

    valid = np.zeros(N, np.uint8)
    nblk = -(-(C_pad * K) // SC) * SC // 128
    chunk_map = np.zeros(N // 128, np.int32)
    # Lane offs_g + c·K + j (c < ncurves_g) starts a live segment iff j < K-1.
    jpat = (np.arange(C_pad * K) % K) < (K - 1)
    for g in range(B):
        n = int(npts[g])
        valid[offs[g] : offs[g] + n] = jpat[:n]
        nb = int(runs[g]) // 128
        c0 = int(offs[g]) // 128
        chunk_map[c0 : c0 + nb] = g * nblk + np.arange(nb)
    mask_words = np.packbits(valid, bitorder="little").view("<u4").view(np.int32).copy()

    if P_pad % TP:
        raise ValueError(f"P_pad={P_pad} must be a multiple of TP={TP}")
    t = np.arange(P_pad // TP)[None, :]
    row_map = (tstart[:, None] + np.minimum(t, (ntiles - 1)[:, None])).astype(np.int32)
    glyph_rows = np.stack([tstart, wh, offs, npts], axis=1).astype(np.int32)
    return FlatKernelPlan(
        K=K, N=N, T=T, TP=TP, L_max=L_max, tmeta=tmeta, mask_words=mask_words,
        row_map=row_map, chunk_map=chunk_map, glyph_rows=glyph_rows,
    )


def tile_target(plan: FlatKernelPlan, target: np.ndarray) -> np.ndarray:
    """The target [B, P_pad] laid out as the min field's tiles
    [T_pad, TP] f32 (glyph g's pixel i at row ``tstart_g + i // TP``,
    slot ``i % TP``; padding rows 0), which the fused loss reads beside
    the field (`ops.flat_loss`)."""
    TP = plan.TP
    B = target.shape[0]
    out = np.zeros((plan.tmeta.shape[0], TP), np.float32)
    ntiles = np.maximum(1, -(-plan.glyph_rows[:, 1].astype(np.int64) // TP))
    own = np.arange(plan.row_map.shape[1])[None, :] < ntiles[:, None]
    out[plan.row_map[own]] = np.asarray(target, np.float32).reshape(B, -1, TP)[own]
    return out


def flat_chain_points(curves, translate, depth: int, chunk_map) -> torch.Tensor:
    """The flat point chain [2, N] f32 from padded control points: per
    curve the K = 2^depth + 1 points at dyadic parameters by one
    Bernstein matmul in full f32, then one gather of 128-point blocks
    into the plan's lane layout (its backward is a scatter-add)."""
    B, C_pad = curves.shape[:2]
    K = (1 << depth) + 1
    c = curves + translate[:, None, None, :]
    chain = torch.einsum("kj,bcjd->bckd", bernstein_matrix(depth, c.device), c)
    CK = C_pad * K
    CK_pad = -(-CK // SC) * SC
    chain = torch.nn.functional.pad(chain.reshape(B, CK, 2), (0, 0, 0, CK_pad - CK))
    nblk = CK_pad // 128
    blocks = chain.reshape(B * nblk, 128, 2).transpose(1, 2)  # [B·nblk, 2, 128]
    return blocks.index_select(0, chunk_map).transpose(0, 1).reshape(2, -1)


def make_flat_kernel_loss(plan: FlatKernelPlan, depth: int):
    """Loss of the flat backend. The plan's arrays ride in the device
    batch (``plan_tmeta`` [8, T_pad], ``plan_words``, ``chunk_map``,
    ``glyph_rows``, ``target_tiles``); its static ints are closed over.
    The batch's plan arrays must have passed `ops.sdf_cuda.check_flat_plan`
    and `ops.flat_loss.check_plan` (as `FontFitter.init` has them): the
    kernels launch without their wrappers' per-step checks, each of which
    would synchronize the host."""
    TP = plan.TP

    def loss_fn(params, batch):
        return torch.mean(_flat_losses(params, batch, depth, TP))

    return loss_fn


def _flat_losses(params, batch: dict, depth: int, TP: int) -> torch.Tensor:
    """The flat backend's per-glyph losses [B]: one fused autograd node
    (`ops.sdf_grad.flat_fit_losses`), six kernel launches a step on the
    card."""
    from ..ops.sdf_grad import flat_fit_losses

    return flat_fit_losses(params["curves"], params["translate"], params["log_gain"], batch,
                           depth, TP)


def flat_losses_reference(params, batch: dict, padded: dict, plan: FlatKernelPlan,
                          depth: int) -> torch.Tensor:
    """`_flat_losses` as PyTorch ops and autograd around the min-field pair
    (the JAX package's decomposition): `flat_chain_points` and the signed
    field on the flat device ``batch``, its tiles gathered into [B, P_pad]
    by the plan's ``row_map``, `_glyph_losses` against ``padded``'s target
    and pixel mask (`padded_batch`). The fused loss computes the same up
    to the order of its sums; the CPU tests hold it against this."""
    from ..ops.sdf_grad import signed_field_flat

    flat = flat_chain_points(params["curves"], params["translate"], depth, batch["chunk_map"])
    field = signed_field_flat(flat, batch["plan_words"], batch["plan_tmeta"], plan.TP,
                              checked=True)
    B = params["curves"].shape[0]
    row_map = torch.as_tensor(plan.row_map, dtype=torch.int64, device=field.device)
    fb = field.index_select(0, row_map.reshape(-1)).reshape(B, -1)
    return _glyph_losses(fb, params, padded)


class ShardedLoss:
    """``loss(params, shards)`` over a list of devices: shard d owns the
    parameter rows ``[d·Bl, (d+1)·Bl)`` (``Bl`` the parameters' padded
    glyph count over the device count) and its batch ``shards[d]`` on
    ``devices[d]``; ``shard_sum(params_d, shard)``, with ``params_d``
    already on the shard's device, is its sum of per-glyph losses. The
    parameters live on ``devices[0]``, where the shards' sums are added in
    shard order and divided by ``B_real``. `ShardedStepGraph` captures
    ``shard_sum`` a shard."""

    def __init__(self, devices, B_real: int, shard_sum):
        self.devices = list(devices)
        self.B_real = B_real
        self.shard_sum = shard_sum

    def rows(self, d: int, params) -> slice:
        """The parameter rows of shard ``d``."""
        Bl = params["curves"].shape[0] // len(self.devices)
        return slice(d * Bl, (d + 1) * Bl)

    def __call__(self, params, shards):
        home = self.devices[0]
        total = None
        for d, (dev, shard) in enumerate(zip(self.devices, shards, strict=True)):
            rows = self.rows(d, params)
            part = self.shard_sum(
                {
                    "curves": params["curves"][rows].to(dev),
                    "translate": params["translate"][rows].to(dev),
                    "log_gain": params["log_gain"].to(dev),
                },
                shard,
            ).to(home)
            total = part if total is None else total + part
        return total / self.B_real


def make_sharded_flat_loss(devices, plans: list, depth: int, B_real: int):
    """Sharded twin of `make_flat_kernel_loss` (the JAX package's
    `make_sharded_flat_loss`): the flat kernel pair runs once a shard,
    on the shard's own plan ``plans[d]`` (its arrays in ``shards[d]``,
    checked by `ops.sdf_cuda.check_flat_plan`), at the shard's own size.
    The JAX package pads the plans to one shape (`_unify_plans`) so that
    one traced function serves every shard; here each shard launches at
    its own size, as the render's bins do, so nothing is padded. (Its
    padding lanes are dead and its extra tile rows skip rows: it changes
    no value.) Returns ``loss_fn(params, shards)``, see `FontFitter`."""
    if len(plans) != len(devices):
        raise ValueError(f"{len(plans)} plans for {len(devices)} devices")
    TP = plans[0].TP
    return ShardedLoss(devices, B_real, lambda p, s: _flat_losses(p, s, depth, TP).sum())


def make_sharded_kernel_loss(devices, depth: int, B_real: int):
    """Sharded twin of `batch_loss_kernel` (the JAX package's
    `make_sharded_kernel_loss`): the padded kernel pair runs once a
    shard on its glyphs. ``shards[d]``: `padded_batch` of slice d of
    `split_batch`, whose rows are a sharded ``flat`` fitter's. Returns
    ``loss_fn(params, shards)``."""
    return ShardedLoss(devices, B_real, lambda p, s: _padded_losses(p, s, depth).sum())


def _graph_key(params, dev_batch) -> tuple:
    """Identity and storage of every tensor a `StepGraph` or a
    `ShardedStepGraph` reads: the parameters and the device batch, or
    each shard's batch of a list of them."""
    shards = dev_batch if isinstance(dev_batch, list) else [dev_batch]
    tensors = [params[k] for k in PARAM_KEYS] + [s[k] for s in shards for k in sorted(s)]
    return tuple((id(t), t.data_ptr()) for t in tensors)


class StepGraph:
    """The forward and backward of one fit step at fixed ``params`` and
    ``dev_batch`` tensors: the loss and `torch.autograd.grad` of it into
    static buffers (``loss``, ``grads`` in `PARAM_KEYS` order), captured
    into a CUDA graph (the `torch.cuda.graph` recipe: warm-up runs on a
    side stream, then one capture) when ``capture``, else run anew at
    each `replay` (the same decomposition without a graph).

    A replay runs on the current stream of the parameters' device and
    reads the parameters' values at that point of the stream, so an
    optimizer step between two replays is seen by the second. The
    graph's private memory pool keeps the forward's and the backward's
    temporaries between replays. A capture that fails raises (a host
    sync in the loss, say); nothing falls back to the eager step.

    ``cotangent`` (default: 1) is the gradient of what the loss feeds
    into, as `ShardedStepGraph` hands each shard's sum its share of the
    mean. ``pools``: graphs that take a dict here share one memory pool
    a device (made at the first capture on it); they must replay in the
    order they were captured, one after the other."""

    WARMUP = 3  # forward-backward runs on the side stream before the capture

    def __init__(self, loss_fn, params, dev_batch, capture: bool = True, cotangent=None,
                 pools: dict | None = None):
        self.key = _graph_key(params, dev_batch)
        self._keyed = (params, dev_batch)  # alive with the graph, so the key stays theirs
        self.device = params["curves"].device
        self._pools = pools
        # Leaves of the graph's own on the parameters' storage: a replay
        # reads the parameters' current values, and no autograd node that
        # another stream made (the gradient accumulator of a graph the
        # caller still holds) enters the capture.
        leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}

        def fwd_bwd():
            loss = loss_fn(leaves, dev_batch)
            return loss.detach(), torch.autograd.grad(loss, list(leaves.values()), cotangent)

        self._fwd_bwd = fwd_bwd
        self.graph = None
        self.launches: dict = {}  # kernel launches recorded by the capture
        self.loss, self.grads = None, None
        if capture:
            self._capture(self.device)

    def _capture(self, dev: torch.device) -> None:
        from ..ops import sdf_cuda

        pool = None
        if self._pools is not None:
            if dev not in self._pools:
                self._pools[dev] = torch.cuda.graph_pool_handle()
            pool = self._pools[dev]
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    self._fwd_bwd()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with (sdf_cuda.capturing() as self.launches,
                  torch.cuda.graph(graph, pool=pool, stream=side)):
                self.loss, self.grads = self._fwd_bwd()
        self.graph = graph

    def replay(self):
        """(loss, grads) at the parameters' current values, in the static
        buffers of a captured graph."""
        if self.graph is None:
            self.loss, self.grads = self._fwd_bwd()
        else:
            from ..ops import sdf_cuda

            with torch.cuda.device(self.device):
                self.graph.replay()
            sdf_cuda.count_replay(self.launches)
        return self.loss, self.grads


class ShardedStepGraph:
    """The forward and backward of one sharded fit step (the JAX
    package's `_step_k` body over `shard_map`) at fixed ``params`` and
    ``shards`` tensors: a `StepGraph` a shard, each captured on its own
    device, of the shard's sum (``loss.shard_sum``) and its gradient
    under the cotangent ``1/B_real`` that the eager `ShardedLoss` hands
    each shard. Graphs of shards on one device share a memory pool (they
    replay one after the other on its current stream).

    A shard's leaves are tensors of its own on its device: shard 0's are
    ``detach()`` aliases of its parameter rows on the first device, the
    others' are buffers that `replay` fills with their rows before their
    graphs run. So one card listed twice runs the copies in and out
    that two cards do, device-local. `replay` then brings the shards'
    sums to the first device, adds them in shard order and divides by
    ``B_real`` (the eager loss's arithmetic), and gathers the gradients
    there: the rows of ``curves`` and ``translate`` side by side,
    ``log_gain``'s sum over the shards in the order that autograd adds
    them in the eager step (the last shard's first: the engine runs the
    newest nodes first). Every copy is queued on the current streams of
    both of its devices, so it follows what wrote its source and
    precedes what reads its destination. Bit-equal to the eager sharded
    `FontFitter.step`'s loss and gradients."""

    def __init__(self, loss: ShardedLoss, params, shards, capture: bool = True):
        self.key = _graph_key(params, shards)
        self._keyed = (params, shards)  # alive with the graph, so the key stays theirs
        self.home = loss.devices[0]
        self.B_real = loss.B_real
        self._own: list = []  # (rows, leaves) of the shards that copy their rows in
        self.shards: list[StepGraph] = []
        pools: dict = {}
        for d, (dev, shard) in enumerate(zip(loss.devices, shards, strict=True)):
            rows = loss.rows(d, params)
            inputs = self._rows_of(rows)
            if d:
                inputs = {k: v.to(dev, copy=True) for k, v in inputs.items()}
                self._own.append((rows, inputs))
            cot = torch.ones((), dtype=torch.float32, device=dev) / loss.B_real
            self.shards.append(StepGraph(loss.shard_sum, inputs, shard, capture, cot, pools))
        self._grads = {k: torch.empty_like(params[k]) for k in ("curves", "translate")}

    def _rows_of(self, rows: slice) -> dict:
        params = self._keyed[0]
        return {"curves": params["curves"].detach()[rows],
                "translate": params["translate"].detach()[rows],
                "log_gain": params["log_gain"].detach()}

    def replay(self):
        """(loss, grads in `PARAM_KEYS` order) on the first device at the
        parameters' current values."""
        with torch.no_grad():
            for rows, leaves in self._own:
                for k, v in self._rows_of(rows).items():
                    leaves[k].copy_(v)
        outs = [g.replay() for g in self.shards]
        home = self.home
        total = None
        for part, _ in outs:
            part = part.to(home)
            total = part if total is None else total + part
        loss = total / self.B_real
        grads = []
        for i, k in enumerate(PARAM_KEYS):
            if k == "log_gain":
                g = None
                for _, gs in reversed(outs):
                    gd = gs[i].to(home)
                    g = gd if g is None else g + gd
            else:
                g = torch.cat([gs[i].to(home) for _, gs in outs], out=self._grads[k])
            grads.append(g)
        return loss, tuple(grads)


class FontFitter:
    """Owns the loss, the optimizer and the train step, on one device or
    sharded over a list of devices."""

    # Steps per `fit` chunk: the losses are fetched once per chunk.
    CHUNK = 10

    def __init__(
        self,
        depth: int = 3,
        learning_rate: float = 0.01,
        sharpness: float | None = None,
        backend: str = "torch",
        device=None,
        devices=None,
    ):
        """``backend="torch"`` autodiffs the pair-tensor model;
        ``"flat"`` runs forward and backward through the min-field
        kernels (hard min only). ``device``: a torch device or its name;
        None or ``"cuda"`` is the first CUDA device and raises without
        one. The CPU runs only when asked for by name. ``devices`` (the
        JAX package's ``mesh``): a list of devices to shard the batch
        over (`parallel.mesh.local_devices`), even of one; the
        parameters and the optimizer live on the first, and `init`
        returns a list of per-shard batches in place of one."""
        if backend not in ("torch", "flat"):
            raise ValueError(f"unknown fitting backend {backend!r}")
        if backend == "flat" and sharpness is not None:
            raise ValueError("backend='flat' supports hard-min only")
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            if not devices:
                raise ValueError("devices must list at least one device")
            self.devices = [torch.device(d) for d in devices]
            self.device = self.devices[0]
        else:
            self.devices = None
            self.device = cuda_device() if device in (None, "cuda") else torch.device(device)
        if any(d.type == "cuda" for d in self.devices or [self.device]) and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"
        ):
            raise ValueError(
                "the Bernstein matmul needs full f32: turn TF32 matmuls off "
                "(torch.backends.cuda.matmul.allow_tf32 = False, float32 "
                "matmul precision 'highest')"
            )
        self.depth = depth
        self.learning_rate = learning_rate
        self.sharpness = sharpness
        self.backend = backend
        self._loss = None  # built by init()
        # `step_many`'s graph, for one (params, batch)
        self._graph: StepGraph | ShardedStepGraph | None = None

    # -- state ----------------------------------------------------------

    def _device_batch(self, batch: FitBatch, dev):
        """(the device batch on ``dev``, the flat plan or None): the torch
        backend's pixel arrays, or the five arrays the fused loss reads (the
        plan and the target in the tile layout, checked once here: the loss
        launches the kernels without checks; on a card they are built here)."""
        if self.backend != "flat":
            return _arrays_on(batch, dev, ("curve_mask", "px", "py", "pix_mask", "target")), None
        from ..ops import flat_loss
        from ..ops.sdf_cuda import check_flat_plan

        plan = build_flat_plan(batch.curve_mask, batch.meta, self.depth, batch.target.shape[1])
        dev_batch = {
            "plan_tmeta": torch.as_tensor(plan.tmeta.T.copy(), device=dev),
            "plan_words": torch.as_tensor(plan.mask_words, device=dev),
            "chunk_map": torch.as_tensor(plan.chunk_map, dtype=torch.int64, device=dev),
            "glyph_rows": torch.as_tensor(plan.glyph_rows, device=dev),
            "target_tiles": torch.as_tensor(tile_target(plan, batch.target), device=dev),
        }
        check_flat_plan(plan.N, dev_batch["plan_words"], dev_batch["plan_tmeta"], plan.TP)
        flat_loss.check_plan(dev_batch, batch.curve_mask.shape[1], plan.K, plan.TP)
        if dev.type == "cuda":
            flat_loss.build()  # the step's six kernels, one nvcc each at once
        return dev_batch, plan

    def init(self, batch: FitBatch):
        """Initial (params, optimizer, device batch); with ``devices``,
        the device batch is the list of per-shard batches and the
        parameters have the padded batch's rows."""
        if self.backend == "flat" and batch.meta is None:
            raise ValueError("backend='flat' needs FitBatch.meta")
        self._graph = None  # the old graph's memory goes before the new batch's
        if self.devices is not None:
            batch, dev_batch = self._shard(batch)
        else:
            dev_batch, plan = self._device_batch(batch, self.device)
            if plan is not None:
                self._loss = make_flat_kernel_loss(plan, self.depth)
            else:
                depth, sharpness = self.depth, self.sharpness
                self._loss = lambda p, b: batch_loss(p, b, depth, sharpness)
        params = init_params(batch.curves0, self.device)
        opt = torch.optim.Adam([params[k] for k in PARAM_KEYS], lr=self.learning_rate)
        return params, opt, dev_batch

    def _shard(self, batch: FitBatch):
        """(the batch as sharded, the per-shard device batches), and the
        sharded loss. The flat backend pads the batch to a multiple of
        the device count (`split_batch`); the torch backend needs a batch
        that divides evenly, as the JAX package's ``device_put`` onto the
        mesh does."""
        devices = self.devices
        D = len(devices)
        B_real = batch.curves0.shape[0]
        if self.backend != "flat" and B_real % D:
            raise ValueError(
                f"the torch backend shards {B_real} glyphs over {D} devices: the batch "
                "must divide evenly (the flat backend pads it)"
            )
        batch, parts = split_batch(batch, D)
        shards, plans = [], []
        for part, dev in zip(parts, devices):
            shard, plan = self._device_batch(part, dev)
            shards.append(shard)
            plans.append(plan)
        if self.backend == "flat":
            self._loss = make_sharded_flat_loss(devices, plans, self.depth, B_real)
        else:
            # The JAX package leaves this backend to XLA's auto-sharding.
            depth, sharpness = self.depth, self.sharpness
            self._loss = ShardedLoss(
                devices, B_real, lambda p, s: _pair_losses(p, s, depth, sharpness).sum())
        return batch, shards

    def loss(self, params, dev_batch) -> torch.Tensor:
        return self._loss(params, dev_batch)

    def value_and_grad(self, params, dev_batch):
        """(loss, {key: gradient}) at ``params``, leaving their .grad
        untouched."""
        loss = self._loss(params, dev_batch)
        grads = torch.autograd.grad(loss, [params[k] for k in PARAM_KEYS])
        return loss.detach(), dict(zip(PARAM_KEYS, grads))

    def step(self, params, opt, dev_batch):
        """One Adam step in place (`eager_step`): (params, opt, loss)."""
        return params, opt, eager_step(self._loss, params, opt, dev_batch)

    def step_many(self, params, opt, dev_batch, k: int):
        """``k`` steps; the losses come back to the host once, as a
        numpy array [k]. On CUDA devices each step replays the CUDA
        graph of the forward and backward (`StepGraph` on one device, a
        `ShardedStepGraph` of one graph a shard over ``devices``,
        captured at the first call for these tensors) and runs Adam
        outside it, bit-equal to `step`; on the CPU it loops over
        `step`."""
        with trace.span("fit.step_many"):
            if self.device.type == "cuda":
                losses = self._graphed_steps(params, opt, dev_batch, k)
            else:
                losses = torch.stack([self.step(params, opt, dev_batch)[2] for _ in range(k)])
            # The host waits here until the card has run the call's steps.
            with trace.span("fit.loss_fetch"):
                losses = losses.cpu()
        return params, opt, losses.numpy()

    def _step_graph(self, params, dev_batch) -> StepGraph | ShardedStepGraph:
        """The cached `StepGraph` (or, over ``devices``,
        `ShardedStepGraph`) of these tensors, captured anew (and the old
        one dropped first) when they are others. `init` drops it;
        `restore_checkpoint` copies in place and keeps it. On the CPU the
        graph is the decomposition without a capture."""
        if self._graph is None or self._graph.key != _graph_key(params, dev_batch):
            self._graph = None
            graph = StepGraph if self.devices is None else ShardedStepGraph
            self._graph = graph(self._loss, params, dev_batch, capture=self.device.type == "cuda")
        return self._graph

    def _graphed_steps(self, params, opt, dev_batch, k: int) -> torch.Tensor:
        """``k`` steps through `_step_graph`: replay, each parameter's
        ``.grad`` set to its static gradient, Adam, the static loss
        copied out. Returns the losses [k] on the device."""
        graph = self._step_graph(params, dev_batch)
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        for i in range(k):
            with trace.span("fit.replay"):
                loss, grads = graph.replay()
            for key, g in zip(PARAM_KEYS, grads):
                params[key].grad = g
            with trace.span("fit.adam"):
                adam_step(opt)
            losses[i].copy_(loss)
        # The static buffers stay the graph's: later steps start from none.
        opt.zero_grad(set_to_none=True)
        return losses

    def fit(self, batch: FitBatch, steps: int = 200, log_every: int = 0):
        params, opt, dev_batch = self.init(batch)
        history = []
        chunk = min(self.CHUNK, log_every) if log_every else self.CHUNK
        i = 0
        while i < steps:
            k = min(chunk, steps - i)
            params, opt, losses = self.step_many(params, opt, dev_batch, k)
            if log_every:
                for j in range(k):
                    s = i + j
                    if s % log_every == 0 or s == steps - 1:
                        history.append((s, float(losses[j])))
            i += k
        return params, history

    # -- checkpointing (torch.save) --------------------------------------

    @staticmethod
    def save_checkpoint(path: str, params, opt) -> None:
        """One file: the parameters and Adam's state on the host, and
        the number of steps taken."""
        state = opt.state_dict()
        steps = int(state["state"][0]["step"]) if state["state"] else 0
        torch.save(
            {
                "params": {k: params[k].detach().cpu() for k in PARAM_KEYS},
                "opt": state,
                "step": steps,
            },
            path,
        )

    @staticmethod
    def restore_checkpoint(path: str, like):
        """Load a checkpoint into ``like = (params, opt)`` (e.g. a fresh
        `init`) in place and return them."""
        params, opt = like
        state = torch.load(path, map_location="cpu", weights_only=True)
        for k in PARAM_KEYS:
            if state["params"][k].shape != params[k].shape:
                raise ValueError(
                    f"checkpoint {k} has shape {tuple(state['params'][k].shape)}, the fit "
                    f"{tuple(params[k].shape)}: a sharded fit's checkpoint holds its padded "
                    "rows, so resume it over the same number of devices"
                )
        with torch.no_grad():
            for k in PARAM_KEYS:
                params[k].copy_(state["params"][k])
        opt.load_state_dict(state["opt"])
        return params, opt


# -- batches ------------------------------------------------------------


def pixel_grid(prep) -> tuple[np.ndarray, np.ndarray]:
    """Pixel-center coordinates of a `GlyphPrep`'s bitmap in PBF
    (Y-flipped row-major) order."""
    w, h = prep.width, prep.height
    i = np.arange(w * h)
    x = i % w
    y = h - 1 - i // w
    return (prep.x0 + x + 0.5).astype(np.float32), (prep.y0 + y + 0.5).astype(np.float32)


def fit_item(cp: int, curves: np.ndarray, prep, bitmap: np.ndarray):
    """One glyph of a batch: font-unit curves already scaled to pixels
    and shifted by ``prep.dx``; the target from the exact SDF bitmap."""
    px, py = pixel_grid(prep)
    target = bytes_to_field(torch.from_numpy(np.asarray(bitmap, np.uint8))).numpy()
    return (cp, curves, px, py, target,
            (prep.x0, prep.y0, prep.width, prep.height))


def assemble_fit_batch(items) -> FitBatch:
    """Pad `fit_item`s into a `FitBatch` (pixel axis padded to a
    multiple of 256, the flat tile size)."""
    if not items:
        raise ValueError("no fittable glyphs among the given codepoints")
    B = len(items)
    C_max = max(c.shape[0] for _, c, *_ in items)
    P_max = -(-max(len(px) for _, _, px, *_ in items) // 256) * 256
    curves0 = np.zeros((B, C_max, 4, 2), np.float32)
    curve_mask = np.zeros((B, C_max), bool)
    pxs = np.zeros((B, P_max), np.float32)
    pys = np.zeros((B, P_max), np.float32)
    pix_mask = np.zeros((B, P_max), np.float32)
    targets = np.zeros((B, P_max), np.float32)
    metas = np.zeros((B, 4), np.int32)
    kept = np.zeros(B, np.int32)
    for b, (cp, c, px, py, tg, m) in enumerate(items):
        kept[b] = cp
        curves0[b, : c.shape[0]] = c
        curve_mask[b, : c.shape[0]] = True
        n = len(px)
        pxs[b, :n] = px
        pys[b, :n] = py
        pix_mask[b, :n] = 1.0
        targets[b, :n] = tg
        metas[b] = m
    return FitBatch(curves0, curve_mask, pxs, pys, pix_mask, targets, metas, kept)


def make_fit_batch(entry, codepoints, depth: int = 3, target_entry=None) -> FitBatch:
    """A FitBatch from a font (`font.entry.FontFileEntry`, or an entry
    with its glyph-key methods): initial curves from
    ``entry``'s outlines, scaled to 24 px/EM and shifted by the parity
    pipeline's dx; targets from the exact renderer on ``target_entry``
    (default: the same font, a self-fit). Unfittable codepoints are
    skipped; ``codepoints`` of the result lists the fitted ones."""
    from ..ops.sdf_ref import render_sdf_exact
    from ..render.metrics import prepare_glyph

    target_entry = target_entry or entry
    items = []
    for cp in codepoints:
        key = entry.glyph_key(cp)
        tkey = target_entry.glyph_key(cp)
        if key is None or tkey is None:
            continue
        rings = target_entry.outline_rings(tkey)
        prep = prepare_glyph(cp, rings, target_entry.units_per_em, target_entry.hor_advance(tkey))
        if prep.empty:
            continue
        curves = entry.outline_curves(key)
        if curves.shape[0] == 0:
            continue
        curves = curves * (24.0 / entry.units_per_em) + np.array([prep.dx, 0.0])
        bitmap = render_sdf_exact(prep.segments, prep.width, prep.height, prep.x0, prep.y0)
        items.append(fit_item(cp, curves, prep, bitmap))
    return assemble_fit_batch(items)
