"""The fused flat-fit loss: four hand-written kernels around the min-field
pair (kernels 2 and 3), each with its plain version.

The flat backend's loss (`ops.sdf_grad.FlatFitLoss`) runs, forward:

1. ``flat_chain_fwd``: the point chain [2, N] in the plan's lane layout
   from the leaves ``curves`` [B, C, 4, 2] and ``translate`` [B, 2]
   (`chain_fwd`);
2. kernel 2 (``sdf_min_field_pts``): d², winding and argmin a tile pixel;
3. ``flat_loss_fwd``: each glyph's loss [B] from d², the winding, the
   target in the tile layout and ``log_gain`` (`loss_fwd`);

and backward, from the per-glyph cotangent ct [B]:

4. ``flat_loss_bwd``: the cotangent of d² [T_pad, TP] and each glyph's
   part of ``log_gain``'s gradient (`loss_bwd`);
5. kernel 3 (``sdf_min_field_bwd``): dpts [2, N];
6. ``flat_chain_bwd``: the gradients of ``curves``, ``translate`` and
   ``log_gain`` (`chain_bwd`).

The arithmetic is the JAX package's loss (`models.glyph_model.sdf_loss`
over the signed field of `ops.sdf_grad.signed_field_flat`): per pixel
``sd = sgn·sqrt(max(d², 1e-12))``, ``pred = sd·exp(log_gain)``, the
masked squared error of both clipped to ±`SDF_RADIUS`, a glyph's mean
over its w·h pixels; `torch.minimum`'s and `torch.maximum`'s gradients
(half at equality). Every operation is one f32 rounding in a fixed
order, the same in a kernel and in its plain version (``*_plain``), so
the kernel gives the plain version's bits; ``exp(log_gain)`` is taken
in f64 and rounded once. Every sum runs in a fixed order (a thread's
strided partial in order, then the block's `THREADS` partials added
pairwise, `_strided_sum` and `_block_sum`): no float atomics, so two
runs are bit-equal. Against the unfused decomposition
(`models.fitting.flat_losses_reference`) the sums differ by round-off.

The plan's static arrays ride in the device batch (`models.fitting`):
``chunk_map`` [N/128] i64, ``glyph_rows`` [B, 4] i32 (first tile row,
w·h, first lane, chain points), ``target_tiles`` [T_pad, TP] f32 (the
target in the tile layout), with ``plan_words`` and ``plan_tmeta``;
`check_plan` checks them once. A pixel ``i`` of glyph g is live iff
``i < w·h``: the batch's ``pix_mask``.

On CUDA tensors each function launches its kernel (no checks beyond
shapes: the plan is checked once); on CPU tensors it runs the plain
version; there is no fallback. Launches count in
`ops.sdf_cuda.LAUNCHES` under the kernel names of `KERNELS`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import SDF_RADIUS
from .sdf_torch import sqrt_rn

# The four kernels, in the order a step runs them, and the six launches
# of a flat step with kernels 2 and 3 among them.
KERNELS = ("flat_chain_fwd", "flat_loss_fwd", "flat_loss_bwd", "flat_chain_bwd")
STEP_KERNELS = ("flat_chain_fwd", "sdf_min_field_pts", "flat_loss_fwd", "flat_loss_bwd",
                "sdf_min_field_bwd", "flat_chain_bwd")
# Threads a block of every kernel, and the width of every fixed-order
# sum (kThreads of csrc/flat_loss.cuh).
THREADS = 256
# Lanes of a chunk of the lane layout (kLaneChunk; render.batch.SC).
LANE_CHUNK = 128
# The floor of d² under its square root (kD2Floor).
D2_FLOOR = 1e-12


@functools.lru_cache(maxsize=8)
def bernstein_matrix(depth: int, device: torch.device) -> torch.Tensor:
    """[K, 4] f32 Bernstein evaluation matrix at the K = 2^depth + 1
    dyadic parameters, on ``device`` (made once: a copy from the host
    would synchronize every step). The rows at t = 0 and 1 are exact
    unit vectors."""
    K = (1 << depth) + 1
    t = np.arange(K, dtype=np.float64) / (K - 1)
    M = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t**3], axis=1)
    return torch.from_numpy(M.astype(np.float32)).to(device)


def build() -> None:
    """Build the flat step's six kernels (`STEP_KERNELS`) where they are
    not built yet, one nvcc each, all at once (`ops._build.build_all`)."""
    from . import _build

    _build.build_all(STEP_KERNELS)


def blocks_a_glyph(C: int, K: int) -> int:
    """128-point blocks of a glyph's padded chain of C curves."""
    return -(-(C * K) // LANE_CHUNK)


def work(glyph_rows: np.ndarray, C: int, K: int, N: int, T_pad: int, TP: int) -> dict:
    """{kernel: (f32 operations, bytes)} of each of the four kernels on a
    plan (its glyph table as numpy): the arithmetic its sources do on
    live elements, and each input byte read once and each output byte
    written once. Bytes bound all four (a few operations a byte)."""
    rows = np.asarray(glyph_rows, np.int64)
    B = rows.shape[0]
    pixels, points = int(rows[:, 1].sum()), int(rows[:, 3].sum())
    curves = points // K
    table = 16 * B + 4  # the glyph table and log_gain
    return {
        # A lane inside a curve: 4 adds and 4 multiplies a coordinate and
        # 3 adds to sum them; a chain end: one add a coordinate.
        "flat_chain_fwd": (22 * (points - 2 * curves) + 4 * curves, 32 * B * C + 8 * B + 16 * K + 8 * (N // LANE_CHUNK)
                           + table + 8 * N),
        # sqrt, the gain's multiply, the difference, its square, the add.
        "flat_loss_fwd": (5 * pixels, 12 * pixels + table + 4 * B),
        # the above but the add, 2·diff, per·(2·diff), ·gain, 0.5/d, the
        # product, dpred·sd and the add; one divide a glyph.
        "flat_loss_bwd": (11 * pixels + B, 12 * pixels + table + 8 * B + 4 * T_pad * TP),
        # K multiplies and adds a curve's coordinate and control point,
        # 4 adds a curve a coordinate for the translate.
        "flat_chain_bwd": (2 * K * 8 * curves + 8 * curves + B, 8 * points + table + 4 * B
                           + 32 * B * C + 8 * B + 4),
    }


# -- plain versions --------------------------------------------------------


def _gain(log_gain: torch.Tensor) -> torch.Tensor:
    """exp(log_gain) in f64, rounded once to f32 (the kernels' `gain_of`)."""
    return torch.exp(log_gain.double()).to(torch.float32)


def _clip(x: torch.Tensor) -> torch.Tensor:
    r = SDF_RADIUS
    return torch.minimum(torch.maximum(x, x.new_full((), -r)), x.new_full((), r))


def _strided_sum(x: torch.Tensor) -> torch.Tensor:
    """[..., W] (W a multiple of `THREADS`) → [..., THREADS]: thread t's
    partial, the values t, t + THREADS, ... added in order from 0."""
    acc = torch.zeros((*x.shape[:-1], THREADS), dtype=x.dtype, device=x.device)
    for k in range(0, x.shape[-1], THREADS):
        acc = acc + x[..., k : k + THREADS]
    return acc


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """[..., THREADS] → [...]: halves added pairwise, as `block_sum`."""
    s = x.shape[-1]
    while s > 1:
        s //= 2
        x = x[..., :s] + x[..., s : 2 * s]
    return x[..., 0]


def _fixed_sum(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The kernels' sum over the last dimension of [..., W] (W a
    multiple of `THREADS`), dead entries left out."""
    return _block_sum(_strided_sum(torch.where(live, x, 0.0)))


def _glyph_pixels(glyph_rows: torch.Tensor, TP: int):
    """(flat index [B, W] into the tile layout, live [B, W]) of each
    glyph's pixels i < w·h, W a multiple of `THREADS`; dead entries
    index 0."""
    tile0, npix = glyph_rows[:, 0].long(), glyph_rows[:, 1].long()
    W = -(-max(int(npix.max()) if npix.numel() else 0, 1) // THREADS) * THREADS
    i = torch.arange(W, device=glyph_rows.device)
    live = i[None, :] < npix[:, None]
    return torch.where(live, tile0[:, None] * TP + i[None, :], 0), live


def _pixel_terms(d2, wn, target, gain):
    """(inside, d, sd, pred, diff) of `pixel_terms`."""
    inside = wn != 0
    d = sqrt_rn(torch.clamp(d2, min=D2_FLOOR))
    sd = torch.where(inside, -d, d)
    pred = sd * gain
    return inside, d, sd, pred, _clip(pred) - _clip(target)


def _pred_grad(per, pred, diff):
    """`pred_grad`: per·(2·diff) through both clips."""
    r = SDF_RADIUS
    g = per * (2.0 * diff)
    m = torch.maximum(pred, pred.new_full((), -r))
    g = torch.where(m > r, 0.0, torch.where(m == r, g / 2, g))
    return torch.where(pred < -r, 0.0, torch.where(pred == -r, g / 2, g))


def bernstein_points(q: torch.Tensor, bern: torch.Tensor) -> torch.Tensor:
    """[..., K, 2] f32: the chain points of cubics q [..., 4, 2] (control
    points + translate), ``((M_j0·q_0 + M_j1·q_1) + M_j2·q_2) + M_j3·q_3``
    with each operation one f32 rounding, the ends q_0 and q_3 themselves:
    ``flat_chain_fwd``'s arithmetic."""
    K = bern.shape[0]
    qi = [q[..., i, None, :] for i in range(4)]  # [..., 1, 2]
    m = [bern[:, i, None] for i in range(4)]  # [K, 1]
    chain = ((m[0] * qi[0] + m[1] * qi[1]) + m[2] * qi[2]) + m[3] * qi[3]  # [..., K, 2]
    chain[..., 0, :] = q[..., 0, :]
    chain[..., K - 1, :] = q[..., 3, :]
    return chain


def chain_fwd_plain(curves, translate, bern, chunk_map, glyph_rows, N: int) -> torch.Tensor:
    """The point chain pts [2, N] f32 (``flat_chain_fwd``): each live lane
    the Bernstein point of its curve (`bernstein_points` of q = control
    points + translate); dead lanes (past a glyph's chain, slack chunks)
    0."""
    B, C = curves.shape[:2]
    K = bern.shape[0]
    chain = bernstein_points(curves + translate[:, None, None, :], bern)  # [B, C, K, 2]
    n = torch.arange(N, device=curves.device)
    src = chunk_map.long()[n // LANE_CHUNK]
    nblk = blocks_a_glyph(C, K)
    g = src // nblk
    r = (src % nblk) * LANE_CHUNK + n % LANE_CHUNK
    rows = glyph_rows.long()
    live = (r < rows[g, 3]) & (n == rows[g, 2] + r)
    vals = chain.reshape(B, C * K, 2)[g, torch.where(live, r, 0)]  # [N, 2]
    return torch.where(live[:, None], vals, 0.0).T.contiguous()


def loss_fwd_plain(d2, wn, target_tiles, glyph_rows, log_gain, TP: int) -> torch.Tensor:
    """Each glyph's loss [B] (``flat_loss_fwd``): the sum of diff² over
    its w·h pixels, in the kernel's order, over max(w·h, 1)."""
    idx, live = _glyph_pixels(glyph_rows, TP)
    _, _, _, _, diff = _pixel_terms(d2.reshape(-1)[idx], wn.reshape(-1)[idx],
                                    target_tiles.reshape(-1)[idx], _gain(log_gain))
    n = torch.clamp(glyph_rows[:, 1], min=1).to(torch.float32)
    return _fixed_sum(diff * diff, live) / n


def loss_bwd_plain(ct, d2, wn, target_tiles, glyph_rows, log_gain, TP: int):
    """(ct_d2 [T_pad, TP], gain_part [B]) (``flat_loss_bwd``): a live
    pixel's cotangent of d², ``((dpred·gain)·sgn)·(0.5/d)`` with dpred
    the cotangent of pred from ``ct_g / max(w·h, 1)``; every other slot
    0. gain_part: each glyph's sum of dpred·sd in the kernel's order."""
    idx, live = _glyph_pixels(glyph_rows, TP)
    gain = _gain(log_gain)
    inside, d, sd, pred, diff = _pixel_terms(d2.reshape(-1)[idx], wn.reshape(-1)[idx],
                                             target_tiles.reshape(-1)[idx], gain)
    per = ct / torch.clamp(glyph_rows[:, 1], min=1).to(torch.float32)
    dpred = _pred_grad(per[:, None], pred, diff)
    dsd = dpred * gain
    out = torch.where(inside, -dsd, dsd) * (0.5 / d)
    ct_d2 = torch.zeros(d2.numel(), dtype=torch.float32, device=d2.device)
    ct_d2[idx[live]] = out[live]
    return ct_d2.reshape(d2.shape), _fixed_sum(dpred * sd, live)


def chain_bwd_plain(dpts, bern, glyph_rows, C: int, gain_part, log_gain):
    """(dcurves [B, C, 4, 2], dtranslate [B, 2], dlog_gain [])
    (``flat_chain_bwd``): a curve's gradient the sum over its K lanes of
    M_ji·dpts in j order (0 past the glyph's chain), the translate's the
    sum of its curves' in (c, i) order, log_gain's the glyphs' gain_part
    in the fixed order, times exp(log_gain)."""
    K = bern.shape[0]
    B = glyph_rows.shape[0]
    rows = glyph_rows.long()
    c = torch.arange(C, device=dpts.device)
    live = (c[None, :] + 1) * K <= rows[:, 3, None]  # [B, C]
    lanes = rows[:, 2, None, None] + c[None, :, None] * K + torch.arange(K, device=dpts.device)
    dp = torch.where(live[None, :, :, None], dpts[:, torch.where(live[..., None], lanes, 0)], 0.0)
    acc = torch.zeros((2, B, C, 4), dtype=torch.float32, device=dpts.device)
    for j in range(K):
        acc = acc + bern[j] * dp[..., j, None]
    dcurves = acc.permute(1, 2, 3, 0).contiguous()
    per_point = dcurves.reshape(B, C * 4, 2)
    dtranslate = torch.zeros((B, 2), dtype=torch.float32, device=dpts.device)
    for k in range(C * 4):
        dtranslate = dtranslate + per_point[:, k]
    W = -(-max(B, 1) // THREADS) * THREADS
    parts = torch.zeros(W, dtype=torch.float32, device=dpts.device)
    parts[:B] = gain_part
    dlog_gain = _block_sum(_strided_sum(parts)) * _gain(log_gain)
    return dcurves, dtranslate, dlog_gain


# -- the kernels ------------------------------------------------------------


def _device(*tensors) -> str:
    """"cpu" or "cuda" for tensors all on one such device; else raise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the fused loss's inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _ptr(t: torch.Tensor) -> int:
    if not t.is_contiguous():
        raise ValueError("the fused loss's kernels take contiguous tensors")
    return t.data_ptr()


def chain_fwd(curves, translate, bern, chunk_map, glyph_rows, N: int) -> torch.Tensor:
    """pts [2, N] f32: ``flat_chain_fwd`` on the card, `chain_fwd_plain`
    on the CPU."""
    if _device(curves, translate, bern, chunk_map, glyph_rows) == "cpu":
        return chain_fwd_plain(curves, translate, bern, chunk_map, glyph_rows, N)
    from .sdf_cuda import _launch

    B, C = curves.shape[:2]
    K = bern.shape[0]
    pts = torch.empty((2, N), dtype=torch.float32, device=curves.device)
    _launch("flat_chain_fwd", curves.device, _ptr(curves), _ptr(translate), _ptr(bern),
            _ptr(chunk_map), _ptr(glyph_rows), N, C, K, blocks_a_glyph(C, K), pts.data_ptr())
    return pts


def loss_fwd(d2, wn, target_tiles, glyph_rows, log_gain, TP: int) -> torch.Tensor:
    """Each glyph's loss [B]: ``flat_loss_fwd`` on the card,
    `loss_fwd_plain` on the CPU."""
    if _device(d2, wn, target_tiles, glyph_rows, log_gain) == "cpu":
        return loss_fwd_plain(d2, wn, target_tiles, glyph_rows, log_gain, TP)
    from .sdf_cuda import _launch

    B = glyph_rows.shape[0]
    loss = torch.empty(B, dtype=torch.float32, device=d2.device)
    _launch("flat_loss_fwd", d2.device, _ptr(d2), _ptr(wn), _ptr(target_tiles),
            _ptr(glyph_rows), B, _ptr(log_gain), TP, loss.data_ptr())
    return loss


def loss_bwd(ct, d2, wn, target_tiles, glyph_rows, log_gain, TP: int):
    """(ct_d2 [T_pad, TP], gain_part [B]): ``flat_loss_bwd`` on the card,
    `loss_bwd_plain` on the CPU. ``ct`` [B] may have any stride (a sum's
    backward hands a stride-0 one)."""
    if _device(ct, d2, wn, target_tiles, glyph_rows, log_gain) == "cpu":
        return loss_bwd_plain(ct, d2, wn, target_tiles, glyph_rows, log_gain, TP)
    from .sdf_cuda import _launch

    B = glyph_rows.shape[0]
    if ct.dtype != torch.float32 or tuple(ct.shape) != (B,):
        raise ValueError(f"ct must be [{B}] float32, got {tuple(ct.shape)} {ct.dtype}")
    ct_d2 = torch.empty_like(d2)
    gain_part = torch.empty(B, dtype=torch.float32, device=d2.device)
    _launch("flat_loss_bwd", d2.device, ct.data_ptr(), ct.stride(0), _ptr(d2), _ptr(wn),
            _ptr(target_tiles), _ptr(glyph_rows), B, _ptr(log_gain), TP, d2.shape[0],
            ct_d2.data_ptr(), gain_part.data_ptr())
    return ct_d2, gain_part


def chain_bwd(dpts, bern, glyph_rows, C: int, gain_part, log_gain):
    """(dcurves, dtranslate, dlog_gain): ``flat_chain_bwd`` on the card,
    `chain_bwd_plain` on the CPU."""
    if _device(dpts, bern, glyph_rows, gain_part, log_gain) == "cpu":
        return chain_bwd_plain(dpts, bern, glyph_rows, C, gain_part, log_gain)
    from .sdf_cuda import _launch

    B, K = glyph_rows.shape[0], bern.shape[0]
    dev = dpts.device
    dcurves = torch.empty((B, C, 4, 2), dtype=torch.float32, device=dev)
    dtranslate = torch.empty((B, 2), dtype=torch.float32, device=dev)
    dlog_gain = torch.empty((), dtype=torch.float32, device=dev)
    _launch("flat_chain_bwd", dev, _ptr(dpts), dpts.shape[1], _ptr(bern), _ptr(glyph_rows), B,
            C, K, _ptr(gain_part), _ptr(log_gain), dcurves.data_ptr(), dtranslate.data_ptr(),
            dlog_gain.data_ptr())
    return dcurves, dtranslate, dlog_gain


def check_plan(batch: dict, C: int, K: int, TP: int) -> None:
    """The fused loss's launch checks on a device batch's static plan for
    glyphs of ``C`` curves and ``K`` chain points a curve (one host sync
    on the card; `models.fitting.FontFitter` runs it once, after
    `ops.sdf_cuda.check_flat_plan`): dtypes, shapes and one device; the
    glyphs' tile rows consecutive in glyph order inside the table and
    their lane runs inside [0, N); every chunk naming a block of a
    glyph."""
    words, tmeta = batch["plan_words"], batch["plan_tmeta"]
    rows, chunk_map, target = batch["glyph_rows"], batch["chunk_map"], batch["target_tiles"]
    N, T_pad = words.shape[0] * 32, tmeta.shape[1]
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != 4:
        raise ValueError(f"glyph_rows must be [B, 4] int32, got {tuple(rows.shape)} {rows.dtype}")
    if chunk_map.dtype != torch.int64 or tuple(chunk_map.shape) != (N // LANE_CHUNK,):
        raise ValueError(f"chunk_map must be [{N // LANE_CHUNK}] int64, got "
                         f"{tuple(chunk_map.shape)} {chunk_map.dtype}")
    if target.dtype != torch.float32 or tuple(target.shape) != (T_pad, TP):
        raise ValueError(f"target_tiles must be [{T_pad}, {TP}] float32, got "
                         f"{tuple(target.shape)} {target.dtype}")
    _device(rows, chunk_map, target, words, tmeta)
    if not all(t.is_contiguous() for t in (rows, chunk_map, target)):
        raise ValueError("the fused loss's plan arrays must be contiguous")
    B = rows.shape[0]
    if not B:
        return
    tile0, npix, lane0, npts = rows.long().unbind(1)
    ntiles = torch.clamp(-(-npix // TP), min=1)
    ends = tile0 + ntiles
    bad = ((tile0 < 0) | (npix < 0) | (lane0 < 0) | (npts < 0) | (npts > C * K)
           | (lane0 + npts > N) | (ends > T_pad)).any()
    bad |= (tile0[0] != 0) | (tile0[1:] != ends[:-1]).any()
    bad |= ((chunk_map < 0) | (chunk_map >= B * blocks_a_glyph(C, K))).any()
    if bool(bad):
        raise ValueError("the fused loss's glyph table or chunk map leaves the plan "
                         f"(N={N}, T_pad={T_pad}, TP={TP})")
