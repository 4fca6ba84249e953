"""Differentiable signed-distance fields (counterparts of
`versatiles_glyphs_tpu.ops.sdf_grad.signed_field_flat` and
`signed_field_pallas`), and the flat backend's fused loss.

`signed_field_flat`, over the flat point-chain layout:

Forward: the min-field kernel (`ops.sdf_cuda.min_field_cuda_pts`) gives
per pixel the min of d², the winding number and the first argmin lane;
``sd = sgn·sqrt(max(d², 1e-12))`` with ``sgn = −1`` where the winding
is non-zero. Backward: by the envelope theorem the gradient of the hard
min reaches the argmin segment alone, with its clamped projection
parameter held fixed: ``∂d²/∂v = 2q·(tc−1)``, ``∂d²/∂w = −2q·tc``. The
backward kernel (`ops.sdf_cuda.min_field_bwd_cuda`) sums those per lane
from ``ct_d2 = ct·sgn·0.5/d``. The sign is piecewise constant and gets
no gradient. On CPU tensors both steps run their plain versions. The
wrappers check the tile table each call (a host sync each); a caller
that ran `ops.sdf_cuda.check_flat_plan` once on a static plan passes
``checked=True`` and both steps go to the launch alone.

`signed_field_padded`, over the padded per-glyph layout [B, S, 4]:
`MinD2Padded` is the JAX package's custom-VJP primitive `_min_d2_wn`,
whose forward is the padded min-field kernel
(`ops.sdf_cuda.min_field_cuda_padded`) and whose backward is the padded
backward kernel (`ops.sdf_cuda.min_field_padded_bwd_cuda`, the same
envelope-theorem terms per segment); ``sd = sgn·sqrt(max(d², 1e-12))``
around it is plain autograd, as it is plain JAX there, with the winding
sign carrying no gradient.

`flat_fit_losses` (`FlatFitLoss`), the flat backend's per-glyph losses
[B] from the leaves ``curves``, ``translate`` and ``log_gain``: the point
chain, the signed field and `models.glyph_model.sdf_loss` of the
unfused decomposition (`models.fitting.flat_losses_reference`) in one
autograd node, whose forward and backward are three launches each
around the min-field pair (`ops.flat_loss`: the chain, the loss, the
cotangent of d², the leaves' gradients); on CPU tensors the plain
versions.
"""

from __future__ import annotations

import torch

from . import flat_loss
from .sdf_cuda import (
    _check,
    launch_min_field_bwd,
    launch_min_field_pts,
    min_field_bwd_cuda,
    min_field_cuda_padded,
    min_field_cuda_pts,
    min_field_padded_bwd_cuda,
)
from .sdf_torch import sqrt_rn


class SignedFieldFlat(torch.autograd.Function):
    """``sd [T, TP]`` from ``pts [2, N]``; see the module docstring."""

    @staticmethod
    def forward(ctx, pts, mask_words, tmeta, TP: int, checked: bool = False):
        # The launch alone only on the card: CPU tensors take the
        # wrappers and their plain versions.
        ctx.launch_alone = checked and pts.device.type == "cuda"
        if ctx.launch_alone:
            _check(pts, mask_words, tmeta, TP)  # shapes and dtypes: no sync
            d2, wn, am = launch_min_field_pts(pts.detach().contiguous(), mask_words, tmeta, TP)
        else:
            d2, wn, am = min_field_cuda_pts(pts.detach(), mask_words, tmeta, TP)
        d = sqrt_rn(torch.clamp(d2, min=1e-12))
        sgn = torch.where(wn != 0, -1.0, 1.0)
        ctx.save_for_backward(pts, am, d, sgn, tmeta)
        ctx.TP = TP
        return sgn * d

    @staticmethod
    def backward(ctx, ct_sd):
        pts, am, d, sgn, tmeta = ctx.saved_tensors
        # Chain through sd = sgn·sqrt(d²): ∂sd/∂d² = sgn/(2d). Pixels with
        # no live segment carry d² = 3e38; their (masked) cotangents meet
        # a finite 1/d.
        ct_d2 = ct_sd * sgn * (0.5 / d)
        bwd = launch_min_field_bwd if ctx.launch_alone else min_field_bwd_cuda
        dpts = bwd(pts.detach().contiguous(), am, ct_d2.contiguous(), tmeta, ctx.TP)
        return dpts, None, None, None, None


def signed_field_flat(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256,
    *, checked: bool = False,
) -> torch.Tensor:
    """Differentiable signed distance [T, TP] f32 (negative inside).

    pts [2, N] f32 (segment i = points i, i+1 where mask bit i is set),
    mask_words [N//32] i32, tmeta [8, T] i32 (the kernel layout: the flat
    plan's row-major table transposed). Rows of padding tiles are 1e-6
    (mask them). Gradients flow to ``pts`` only. ``checked``: the caller
    has run `ops.sdf_cuda.check_flat_plan` on these mask words and this
    table for ``pts``'s lane count, and they are contiguous on ``pts``'s
    device; the kernels then launch without the per-call checks."""
    return SignedFieldFlat.apply(pts, mask_words, tmeta, TP, checked)


class MinD2Padded(torch.autograd.Function):
    """(d2 [B, P] f32, wn [B, P] i32) from ``segs [B, S, 4]``: the min of
    d² over each glyph's live segments and the winding number (no
    gradient) of its first P pixels (counterpart of `_min_d2_wn`)."""

    @staticmethod
    def forward(ctx, segs, mask, meta, P: int):
        d2, wn, am = min_field_cuda_padded(segs.detach(), mask, meta, P)
        ctx.mark_non_differentiable(wn)
        ctx.save_for_backward(segs, meta, am)
        return d2, wn

    @staticmethod
    def backward(ctx, ct_d2, _ct_wn):
        segs, meta, am = ctx.saved_tensors
        dsegs = min_field_padded_bwd_cuda(segs.detach(), meta, am, ct_d2.contiguous())
        return dsegs, None, None, None


def signed_field_padded(
    segs: torch.Tensor, mask: torch.Tensor, meta: torch.Tensor, P: int
) -> torch.Tensor:
    """Differentiable signed distance [B, P] f32 (negative inside) on the
    padded per-glyph layout (counterpart of `signed_field_pallas`).

    segs [B, S, 4] (vx, vy, wx, wy per segment; cast to f32), mask
    [B, S] (nonzero = live), meta [B, ≥4] (x0, y0, w, h per glyph), P
    pixels per glyph in flat PBF order; entries past w·h are finite
    garbage (mask them in the loss). Gradients flow to ``segs`` only."""
    d2, wn = MinD2Padded.apply(segs.to(torch.float32).contiguous(), mask, meta, P)
    d = sqrt_rn(torch.clamp(d2, min=1e-12))
    sgn = torch.where(wn != 0, -1.0, 1.0)
    return sgn * d


class FlatFitLoss(torch.autograd.Function):
    """Per-glyph losses [B] from ``curves`` [B, C, 4, 2], ``translate``
    [B, 2] and ``log_gain`` []; see `flat_fit_losses`."""

    @staticmethod
    def forward(ctx, curves, translate, log_gain, batch: dict, depth: int, TP: int):
        words, tmeta = batch["plan_words"], batch["plan_tmeta"]
        bern = flat_loss.bernstein_matrix(depth, curves.device)
        pts = flat_loss.chain_fwd(curves.contiguous(), translate.contiguous(), bern,
                                  batch["chunk_map"], batch["glyph_rows"], words.shape[0] * 32)
        if pts.device.type == "cuda":
            _check(pts, words, tmeta, TP)  # shapes and dtypes: no sync
            d2, wn, am = launch_min_field_pts(pts, words, tmeta, TP)
        else:
            d2, wn, am = min_field_cuda_pts(pts, words, tmeta, TP)
        losses = flat_loss.loss_fwd(d2, wn, batch["target_tiles"], batch["glyph_rows"],
                                    log_gain, TP)
        ctx.save_for_backward(log_gain, pts, d2, wn, am)
        ctx.batch, ctx.bern, ctx.TP, ctx.C = batch, bern, TP, curves.shape[1]
        return losses

    @staticmethod
    def backward(ctx, ct):
        log_gain, pts, d2, wn, am = ctx.saved_tensors
        batch, TP = ctx.batch, ctx.TP
        ct_d2, gain_part = flat_loss.loss_bwd(ct, d2, wn, batch["target_tiles"],
                                              batch["glyph_rows"], log_gain, TP)
        bwd = launch_min_field_bwd if pts.device.type == "cuda" else min_field_bwd_cuda
        dpts = bwd(pts, am, ct_d2, batch["plan_tmeta"], TP)
        dcurves, dtranslate, dlog_gain = flat_loss.chain_bwd(
            dpts, ctx.bern, batch["glyph_rows"], ctx.C, gain_part, log_gain)
        return dcurves, dtranslate, dlog_gain, None, None, None


def flat_fit_losses(curves, translate, log_gain, batch: dict, depth: int, TP: int = 256
                    ) -> torch.Tensor:
    """The flat backend's per-glyph losses [B] f32, differentiable in
    ``curves``, ``translate`` and ``log_gain``: the masked SDF loss of
    each glyph (`models.glyph_model.sdf_loss`) of the signed field over
    the point chain of depth ``depth``, as `models.fitting.
    flat_losses_reference` computes it, up to the order of its sums.

    ``batch`` is a flat device batch (`models.fitting.FontFitter`):
    ``plan_words``, ``plan_tmeta``, ``chunk_map``, ``glyph_rows`` and
    ``target_tiles``, which must have passed `ops.sdf_cuda.check_flat_plan`
    and `ops.flat_loss.check_plan` (the kernels launch without per-call
    checks, each of which would synchronize the host). On the card a
    forward is three launches (``flat_chain_fwd``, kernel 2,
    ``flat_loss_fwd``) and a backward three more (``flat_loss_bwd``,
    kernel 3, ``flat_chain_bwd``), none with a float atomic, so two runs
    are bit-equal; on the CPU the plain versions."""
    return FlatFitLoss.apply(curves, translate, log_gain, batch, depth, TP)
