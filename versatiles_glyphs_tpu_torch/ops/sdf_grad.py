"""Differentiable signed-distance fields (counterparts of
`versatiles_glyphs_tpu.ops.sdf_grad.signed_field_flat` and
`signed_field_pallas`).

`signed_field_flat`, over the flat point-chain layout:

Forward: the min-field kernel (`ops.sdf_cuda.min_field_cuda_pts`) gives
per pixel the min of d², the winding number and the first argmin lane;
``sd = sgn·sqrt(max(d², 1e-12))`` with ``sgn = −1`` where the winding
is non-zero. Backward: by the envelope theorem the gradient of the hard
min reaches the argmin segment alone, with its clamped projection
parameter held fixed: ``∂d²/∂v = 2q·(tc−1)``, ``∂d²/∂w = −2q·tc``. The
backward kernel (`ops.sdf_cuda.min_field_bwd_cuda`) sums those per lane
from ``ct_d2 = ct·sgn·0.5/d``. The sign is piecewise constant and gets
no gradient. On CPU tensors both steps run their plain versions.

`signed_field_padded`, over the padded per-glyph layout [B, S, 4]:
`MinD2Padded` is the JAX package's custom-VJP primitive `_min_d2_wn`,
whose forward is the padded min-field kernel
(`ops.sdf_cuda.min_field_cuda_padded`) and whose backward is the padded
backward kernel (`ops.sdf_cuda.min_field_padded_bwd_cuda`, the same
envelope-theorem terms per segment); ``sd = sgn·sqrt(max(d², 1e-12))``
around it is plain autograd, as it is plain JAX there, with the winding
sign carrying no gradient.
"""

from __future__ import annotations

import torch

from .sdf_cuda import (
    min_field_bwd_cuda,
    min_field_cuda_padded,
    min_field_cuda_pts,
    min_field_padded_bwd_cuda,
)
from .sdf_torch import sqrt_rn


class SignedFieldFlat(torch.autograd.Function):
    """``sd [T, TP]`` from ``pts [2, N]``; see the module docstring."""

    @staticmethod
    def forward(ctx, pts, mask_words, tmeta, TP: int):
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
        dpts = min_field_bwd_cuda(pts.detach(), am, ct_d2.contiguous(), tmeta, ctx.TP)
        return dpts, None, None, None


def signed_field_flat(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256
) -> torch.Tensor:
    """Differentiable signed distance [T, TP] f32 (negative inside).

    pts [2, N] f32 (segment i = points i, i+1 where mask bit i is set),
    mask_words [N//32] i32, tmeta [8, T] i32 (the kernel layout: the flat
    plan's row-major table transposed). Rows of padding tiles are 1e-6
    (mask them). Gradients flow to ``pts`` only."""
    return SignedFieldFlat.apply(pts, mask_words, tmeta, TP)


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
