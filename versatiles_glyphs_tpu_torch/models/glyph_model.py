"""Differentiable glyph model: Bezier control points → SDF field
(counterpart of `versatiles_glyphs_tpu.models.glyph_model`).

Plain functions on tensors, the ``torch`` backend of the fitting path.
Curves are f32 ``[..., C, 4, 2]`` cubics (quadratics degree-elevated,
lines as collinear cubics) with a validity mask ``[..., C]``; a fixed
depth of midpoint De Casteljau splits turns them into chord segments,
and the field is the masked pair tensor of pixels × segments. Leading
batch dimensions broadcast, so one call covers a batch of glyphs where
the JAX package vmaps.

Gradient conventions follow the JAX package: the hard min is
`torch.amin`, whose backward splits evenly on ties as `jnp.min` does;
clips are `torch.maximum`/`torch.minimum` against tensors, which split
at equality as `jnp.clip` does; square roots are correctly rounded
(`ops.sdf_torch.sqrt_rn`); the winding sign gets no gradient.
"""

from __future__ import annotations

import torch

from ..constants import CUTOFF, SDF_RADIUS

from ..ops.sdf_torch import sqrt_rn


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip` with its gradient: half to each side at equality. The
    bounds are filled on x's device (`new_tensor` would copy from the
    host and synchronize)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def elevate_quadratic(start, ctrl, end):
    """Quadratic → cubic control points (exact degree elevation)."""
    c1 = start + 2.0 / 3.0 * (ctrl - start)
    c2 = end + 2.0 / 3.0 * (ctrl - end)
    return torch.stack([start, c1, c2, end], dim=-2)


def subdivide_cubics(curves: torch.Tensor, depth: int) -> torch.Tensor:
    """[..., C, 4, 2] cubics → [..., C·2^depth, 4, 2] via ``depth``
    rounds of midpoint De Casteljau splits, curve order kept."""
    for _ in range(depth):
        s, c1, c2, e = (curves[..., i, :] for i in range(4))
        p01 = (s + c1) * 0.5
        p12 = (c1 + c2) * 0.5
        p23 = (c2 + e) * 0.5
        p012 = (p01 + p12) * 0.5
        p123 = (p12 + p23) * 0.5
        mid = (p012 + p123) * 0.5
        left = torch.stack([s, p01, p012, mid], dim=-2)
        right = torch.stack([mid, p123, p23, e], dim=-2)
        curves = torch.stack([left, right], dim=-3).reshape(*curves.shape[:-3], -1, 4, 2)
    return curves


def curves_to_segments(curves: torch.Tensor, depth: int) -> torch.Tensor:
    """[..., C, 4, 2] cubics → [..., C·2^depth, 4] chords (vx, vy, wx, wy)."""
    pieces = subdivide_cubics(curves, depth)
    return torch.cat([pieces[..., 0, :], pieces[..., 3, :]], dim=-1)


def segment_components(segs: torch.Tensor):
    """[..., S, 4] segments → (vx, vy, dx, dy, 1/l2, 1/dy, wy), with
    guards whose gradients stay finite at zero-length and horizontal
    segments."""
    vx, vy, wx, wy = segs.unbind(-1)
    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = torch.where(l2 > 0.0, 1.0 / torch.where(l2 > 0.0, l2, 1.0), 0.0)
    dyinv = torch.where(dy != 0.0, 1.0 / torch.where(dy != 0.0, dy, 1.0), 0.0)
    return vx, vy, dx, dy, l2inv, dyinv, wy


def sdf_field(
    segs: torch.Tensor,
    seg_mask: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    sharpness: float | None = None,
) -> torch.Tensor:
    """Signed distance of pixels (px, py) [..., P] to a masked segment
    soup [..., S, 4] — differentiable, negative inside.

    ``sharpness=None``: hard min over segments (the subgradient goes to
    the argmin segment). A float: the softmin ``-logsumexp(-s·d)/s``,
    which spreads smooth gradients over nearby segments."""
    vx, vy, dx, dy, l2inv, dyinv, wy = (c[..., None, :] for c in segment_components(segs))
    seg_ok = seg_mask[..., None, :]
    pxc = px[..., :, None]
    pyc = py[..., :, None]
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    tc = _clip(num * l2inv, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = torch.where(seg_ok, qx * qx + qy * qy, 3.0e38)

    floor = d2.new_full((), 1e-12)
    if sharpness is None:
        d = sqrt_rn(torch.maximum(torch.amin(d2, dim=-1), floor))
    else:
        dists = sqrt_rn(torch.maximum(d2, floor))
        dists = torch.where(seg_ok, dists, 2.0 * SDF_RADIUS)
        s = float(sharpness)
        d = -torch.logsumexp(-s * dists, dim=-1) / s

    # Winding sign (hard: locally constant in the parameters).
    with torch.no_grad():
        up = (vy <= pyc) & (wy > pyc)
        dn = (vy > pyc) & (wy <= pyc)
        cx = vx + (ey * dyinv) * dx
        sign = up.to(torch.int32) - dn.to(torch.int32)
        hit = (cx <= pxc) & seg_ok & (up | dn)
        wn = torch.sum(torch.where(hit, sign, 0), dim=-1)
        sgn = torch.where(wn != 0, -1.0, 1.0)
    return sgn * d


def glyph_field(
    curves: torch.Tensor,
    curve_mask: torch.Tensor,
    translate: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    depth: int = 3,
    sharpness: float | None = None,
) -> torch.Tensor:
    """SDF field [..., P] of glyphs from their control points: curves
    [..., C, 4, 2] f32, curve_mask [..., C] bool, translate [..., 2] f32
    (the differentiable placement), pixel centers px/py [..., P]."""
    curves = curves + translate[..., None, None, :]
    segs = curves_to_segments(curves, depth)
    seg_mask = torch.repeat_interleave(curve_mask, 2**depth, dim=-1)
    return sdf_field(segs, seg_mask, px, py, sharpness=sharpness)


def field_to_bytes(field: torch.Tensor) -> torch.Tensor:
    """Quantize a signed-distance field to SDF bytes
    (`ops.sdf_jax.quantize_sdf`; a staircase with no gradient)."""
    v = field * (256.0 / SDF_RADIUS) + CUTOFF
    return torch.floor(torch.clamp(255.0 - v, 0.0, 255.0) + 0.5).to(torch.uint8)


def bytes_to_field(bitmap: torch.Tensor) -> torch.Tensor:
    """Invert the quantization: byte → signed distance in pixels
    (``d = (191 - byte)/32``; exact for unsaturated bytes)."""
    return (191.0 - bitmap.to(torch.float32)) / (256.0 / SDF_RADIUS)


def sdf_loss(pred_field, target_field, pix_mask=None):
    """Masked MSE between SDFs clipped to ±SDF_RADIUS (the byte
    format's saturation), over the last dimension: one loss per row."""
    r = SDF_RADIUS
    err = (_clip(pred_field, -r, r) - _clip(target_field, -r, r)) ** 2
    if pix_mask is None:
        return torch.mean(err, dim=-1)
    err = err * pix_mask
    return torch.sum(err, dim=-1) / torch.clamp(torch.sum(pix_mask, dim=-1), min=1.0)
