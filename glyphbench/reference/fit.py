"""Plain reference of the fit step: the first Adam steps of the outline
fit from the same start, in float64, by the definition.

Each glyph's cubics are evaluated at the 2^depth + 1 dyadic parameters
by their Bernstein polynomials (a matrix product), consecutive points of
a cubic are joined by chords, and every pixel of the target's bitmap
takes its distance to the nearest chord (the projection clamped to the
chord), negative where the winding number of the half-open row
crossings left of the pixel is not 0. The field times exp(log_gain)
and the target, each clipped to ±8 px, give each glyph's mean squared
error over its pixels; the loss is the mean over the glyphs. Gradients
by autograd, the hard min's to the first nearest chord; Adam as
`torch.optim.Adam` defines it (lr, betas (0.9, 0.999), eps 1e-8, bias
corrections, no weight decay).

The batch is built here from the benchmark's own outlines: the fitted
font's quadratic contours degree-elevated to cubics, scaled to 24 px
a em and moved by the target glyph's sub-pixel shift; the targets are
the plain reference render (`reference.render`) of the target font's
outlines, read back as distances ``(191 − byte) / 32``.

``control=True`` computes the same in float32 with the Bernstein
product in TF32 (its operands rounded to 10 bits of mantissa), the
precision below the fit's stated one. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen import outlines as O
from ..frozen import synth_font
from . import render

LEAVES = ("curves", "translate", "log_gain")
BETAS = (0.9, 0.999)
EPS = 1e-8


class Batch:
    """Per glyph [B]: cubics ``curves`` [Σ C, 4, 2] with ``curve_start``
    and ``ncurves``; pixel centres ``px``, ``py`` and targets [Σ P] with
    ``pix_start`` and ``npix``."""


def build_batch(fit_seed: int, target_seed: int, n_glyphs: int, quads: int, device) -> Batch:
    """The fit of `synth_font.build_ttf`'s glyphs of ``fit_seed`` toward
    the bitmaps of those of ``target_seed``, every glyph (both fonts map
    the same codepoints to glyphs 1..n)."""
    tgt = O.prep(O.text_font_rings(n_glyphs, target_seed, quads))
    segs, sg = O.segments(tgt)
    bytes_, pix_start = render.render(segs, sg, tgt.width, tgt.height, tgt.x0, tgt.y0, device=device)
    b = Batch()
    scale = 24.0 / synth_font.UPEM
    curves, ncurves = [], []
    for g, (_, contours) in enumerate(synth_font.curved_outlines(n_glyphs, fit_seed, quads)):
        n = 0
        for on, off in contours:
            s = np.asarray(on, np.float64)
            c = np.asarray(off, np.float64)
            e = np.roll(s, -1, axis=0)
            cub = np.stack([s, s + 2.0 / 3.0 * (c - s), e + 2.0 / 3.0 * (c - e), e], axis=1)
            curves.append(cub * scale + np.array([tgt.dx[g], 0.0]))
            n += len(s)
        ncurves.append(n)
    b.curves = np.concatenate(curves)
    b.ncurves = np.asarray(ncurves, np.int64)
    b.curve_start = np.concatenate([[0], np.cumsum(b.ncurves)[:-1]])
    b.npix = (tgt.width * tgt.height).astype(np.int64)
    b.pix_start = pix_start
    k = np.arange(int(b.npix.sum())) - np.repeat(pix_start, b.npix)
    w = np.repeat(tgt.width, b.npix)
    b.px = np.repeat(tgt.x0, b.npix) + k % w + 0.5
    b.py = np.repeat(tgt.y0, b.npix) + (np.repeat(tgt.height, b.npix) - 1 - k // w) + 0.5
    b.target = (191.0 - bytes_.astype(np.float64)) / 32.0
    return b


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 bits of mantissa, to nearest
    even, passing the gradient through."""
    bits = x.detach().view(torch.int32)
    r = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (r.view(torch.float32) - x).detach()


def _bernstein(depth: int, dtype, device) -> torch.Tensor:
    t = np.arange((1 << depth) + 1, dtype=np.float64) / (1 << depth)
    m = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t ** 3], axis=1)
    return torch.as_tensor(m, dtype=dtype, device=device)


def _block_loss_sum(params, b: Batch, blk: np.ndarray, depth: int, control: bool, dev_b: dict):
    """Σ over the glyphs ``blk`` of their masked MSE (a 0-d tensor)."""
    dtype = params["curves"].dtype
    device = params["curves"].device
    g = len(blk)
    c_max = int(b.ncurves[blk].max())
    p_max = int(b.npix[blk].max())
    cidx = b.curve_start[blk][:, None] + np.arange(c_max)[None, :]
    cmask = np.arange(c_max)[None, :] < b.ncurves[blk][:, None]
    cidx_t = torch.as_tensor(np.where(cmask, cidx, 0), device=device)
    rows = torch.as_tensor(blk, device=device)
    cur = params["curves"][cidx_t] + params["translate"][rows][:, None, None, :]
    m = _bernstein(depth, dtype, device)
    if control:
        cur, m = _tf32(cur), _tf32(m)
    chain = torch.einsum("kj,gcjd->gckd", m, cur)  # [g, C, K, 2]
    v = chain[:, :, :-1].reshape(g, -1, 2)
    w = chain[:, :, 1:].reshape(g, -1, 2)
    seg_ok = torch.as_tensor(np.repeat(cmask, (1 << depth), axis=1), device=device)[:, None, :]
    pidx = b.pix_start[blk][:, None] + np.arange(p_max)[None, :]
    pmask_np = np.arange(p_max)[None, :] < b.npix[blk][:, None]
    pidx_t = torch.as_tensor(np.where(pmask_np, pidx, 0), device=device)
    px = dev_b["px"][pidx_t][:, :, None]
    py = dev_b["py"][pidx_t][:, :, None]
    tgt = dev_b["target"][pidx_t]
    pmask = torch.as_tensor(pmask_np, device=device, dtype=dtype)
    vx, vy = v[..., 0][:, None, :], v[..., 1][:, None, :]
    wx, wy = w[..., 0][:, None, :], w[..., 1][:, None, :]
    dx, dy = wx - vx, wy - vy
    l2 = dx * dx + dy * dy
    l2inv = torch.where(l2 > 0.0, 1.0 / torch.where(l2 > 0.0, l2, 1.0), 0.0)
    ex, ey = px - vx, py - vy
    tc = torch.clamp((ex * dx + ey * dy) * l2inv, 0.0, 1.0)
    qx, qy = ex - tc * dx, ey - tc * dy
    d2 = torch.where(seg_ok, qx * qx + qy * qy, torch.finfo(dtype).max)
    # The hard min's gradient goes to the first nearest chord (a pixel
    # nearest to the point two cubics share reaches both at one d^2).
    first = torch.argmin(d2, dim=2, keepdim=True)
    d = torch.sqrt(torch.clamp(torch.gather(d2, 2, first)[..., 0], min=1e-12))
    with torch.no_grad():
        up = (vy <= py) & (wy > py)
        dn = (vy > py) & (wy <= py)
        dyinv = torch.where(dy != 0.0, 1.0 / torch.where(dy != 0.0, dy, 1.0), 0.0)
        cx = vx + (ey * dyinv) * dx
        hit = (up | dn) & (cx <= px) & seg_ok
        wn = torch.sum(torch.where(hit, torch.where(up, 1, -1), 0), dim=2)
        sgn = torch.where(wn != 0, -1.0, 1.0).to(dtype)
    field = sgn * d * torch.exp(params["log_gain"])
    err = (torch.clamp(field, -8.0, 8.0) - torch.clamp(tgt, -8.0, 8.0)) ** 2 * pmask
    return (err.sum(dim=1) / torch.clamp(pmask.sum(dim=1), min=1.0)).sum()


def loss_and_grad(params, b: Batch, depth: int, control: bool, dev_b: dict, pairs_per_block: int,
                  keep: int | None = None):
    """(loss, {leaf: gradient}) of the batch at ``params`` (leaves that
    require grad), glyphs in blocks, each block's gradient added up.
    ``keep`` (a planted fault): the mean over the first ``keep`` glyphs
    alone."""
    B = keep or len(b.ncurves)
    for p in params.values():
        p.grad = None
    total = 0.0
    i = 0
    while i < B:
        j, c_max, p_max = i + 1, int(b.ncurves[i]), int(b.npix[i])
        while j < B:
            c2, p2 = max(c_max, int(b.ncurves[j])), max(p_max, int(b.npix[j]))
            if (j + 1 - i) * c2 * p2 * (1 << depth) > pairs_per_block:
                break
            c_max, p_max, j = c2, p2, j + 1
        s = _block_loss_sum(params, b, np.arange(i, j), depth, control, dev_b) / B
        s.backward()
        total += float(s.detach())
        i = j
    return total, {k: params[k].grad.detach().clone() for k in LEAVES}


def run_steps(b: Batch, steps: int, depth: int, lr: float, device, control: bool = False,
              pairs_per_block: int | None = None, keep: int | None = None) -> dict:
    """``steps`` Adam steps from the start: ``losses`` [steps] (each at
    the step's start), ``grad1`` {leaf: the first gradient},
    ``params0`` and ``params`` {leaf: values before the first and after
    the last step}, all float64 numpy. ``keep``: see `loss_and_grad`."""
    device = torch.device(device)
    dtype = torch.float32 if control else torch.float64
    budget = pairs_per_block or (1 << 24 if device.type == "cuda" else 1 << 20)
    B = len(b.ncurves)
    to = dict(dtype=dtype, device=device)
    params = {
        "curves": torch.as_tensor(b.curves, **to).requires_grad_(),
        "translate": torch.zeros((B, 2), **to).requires_grad_(),
        "log_gain": torch.zeros((), **to).requires_grad_(),
    }
    dev_b = {k: torch.as_tensor(getattr(b, k), **to) for k in ("px", "py", "target")}
    p0 = {k: v.detach().double().cpu().numpy().copy() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        loss, grads = loss_and_grad(params, b, depth, control, dev_b, budget, keep)
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: g.double().cpu().numpy() for k, g in grads.items()}
        with torch.no_grad():
            bc1 = 1.0 - BETAS[0] ** t
            bc2 = 1.0 - BETAS[1] ** t
            for k in LEAVES:
                g = grads[k]
                m[k].lerp_(g, 1.0 - BETAS[0])
                s2[k].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = s2[k].sqrt() / bc2 ** 0.5 + EPS
                params[k].addcdiv_(m[k], denom, value=-lr / bc1)
    return {"losses": np.asarray(losses), "grad1": grad1, "params0": p0,
            "params": {k: v.detach().double().cpu().numpy() for k, v in params.items()}}


def norms_by_leaf(tree: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(tree[k], np.float64).ravel())) for k in LEAVES}


def worst_leaf_gap(prog: dict, ref: dict, grad: dict | None = None) -> tuple[float, list]:
    """The largest gap between the program's and the reference's norm
    of a leaf, over the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient (``grad``,
    default ``ref`` itself) has a norm under a thousandth of the median
    leaf's are left out (and named): they move by round-off alone."""
    pn, rn = norms_by_leaf(prog), norms_by_leaf(ref)
    gn = rn if grad is None else norms_by_leaf(grad)
    med, gmed = float(np.median(list(rn.values()))), float(np.median(list(gn.values())))
    worst, skipped = 0.0, []
    for k in LEAVES:
        if gn[k] < 1e-3 * gmed:
            skipped.append(k)
            continue
        worst = max(worst, abs(pn[k] - rn[k]) / max(rn[k], med))
    return worst, skipped


def readings(prog: dict, ref: dict) -> dict:
    """The numbers the fit cell compares, of a run's first steps
    (``prog``: ``losses`` [steps], ``grad1`` and ``delta`` {leaf:
    values}, the change over all the steps) against the reference's
    (`run_steps` of as many steps): ``loss0_gap``, the first step's
    loss's relative gap, and ``loss_gap``, the worst step's;
    ``grad1_norm_gap`` and ``delta_norm_gap`` by `worst_leaf_gap`, the
    change's leaves left out by the reference's gradient; and the leaves
    ``skipped``."""
    rl, pl = np.asarray(ref["losses"]), np.asarray(prog["losses"])
    if rl.shape != pl.shape:
        raise ValueError(f"{len(pl)} steps against the reference's {len(rl)}")
    gaps = np.abs(pl - rl) / np.abs(rl)
    grad, skip_g = worst_leaf_gap(prog["grad1"], ref["grad1"])
    ref_delta = {k: ref["params"][k] - ref["params0"][k] for k in LEAVES}
    delta, skip_d = worst_leaf_gap(prog["delta"], ref_delta, ref["grad1"])
    return {"loss0_gap": float(gaps[0]), "grad1_norm_gap": grad, "delta_norm_gap": delta,
            "loss_gap": float(gaps.max()), "skipped": sorted(set(skip_g) | set(skip_d))}
