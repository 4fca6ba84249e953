"""Plain PyTorch versions of the atlas render path's device ops.

Device-agnostic functions on tensors. They are the counterparts of the
XLA prepass steps and of the Pallas tile kernel in
`versatiles_glyphs_tpu.ops.sdf_pallas` / `ops.sdf_jax`, kept in the same
op order so that every result is bit-identical to the JAX package's on
the same wire arrays. The CPU tests hold them against the JAX package,
the ``torch`` renderer runs them on the CPU, and `ops.sdf_cuda` takes
them for CPU tensors and holds its kernel against them on the card.
"""

from __future__ import annotations

import torch

from versatiles_glyphs_tpu.constants import CUTOFF, SDF_RADIUS
from versatiles_glyphs_tpu.render.metrics import Q16_SCALE

# ~f32 max: the distance of a masked segment (`ops.sdf_jax._BIG`).
_BIG = 3.0e38


def reconstruct_delta(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode the i8-delta wire to exact q16 positions (counterpart of
    `sdf_pallas.reconstruct_delta`).

    deltas: [2, N] i8 lane-to-lane diffs (0 at anchor lanes); anchors:
    [3, K] i32, row 0 the lane, rows 1-2 the true x/y delta. Duplicate
    and padding ``(0, 0, 0)`` anchors accumulate, as ``.at[].add``
    does. Returns [2, N] i32."""
    full = deltas.to(torch.int32, copy=True)
    full.index_add_(1, anchors[0].long(), anchors[1:3].to(torch.int32))
    return torch.cumsum(full, dim=1, dtype=torch.int32)


def dequantize(q: torch.Tensor) -> torch.Tensor:
    """q16 fixed point → f32 pixels, as a multiply by the reciprocal
    scale (`sdf_pallas.py` does the same; the scale is a power of two,
    so the result is exact)."""
    return q.to(torch.float32) * (1.0 / Q16_SCALE)


def derive_tmeta(meta: torch.Tensor, TP: int, T_pad: int) -> torch.Tensor:
    """The [8, T_pad] i32 tile table from the per-glyph rows meta [G, 8]
    (counterpart of `sdf_pallas.derive_tmeta`).

    `jnp.repeat(..., total_repeat_length=T_pad)` truncates past T_pad
    and pads by repeating the LAST glyph index; `torch.repeat_interleave`
    with ``output_size`` raises instead. So the glyph of each tile row
    is built the way `jnp.repeat` builds it: a 1 at every glyph's first
    tile (starts beyond T_pad dropped), cumulated. The padding rows then
    equal JAX's row for row and land on pix_base ≥ w·h (skipped)."""
    meta = meta.to(torch.int32)
    dev = meta.device
    npix = meta[:, 2] * meta[:, 3]
    ntiles = torch.clamp(-torch.div(-npix, TP, rounding_mode="floor"), min=1)
    starts = torch.cumsum(ntiles, 0, dtype=torch.int32) - ntiles
    marks = torch.zeros(T_pad, dtype=torch.int32, device=dev)
    marks.index_add_(
        0,
        torch.clamp(starts, max=T_pad - 1).long(),
        (starts < T_pad).to(torch.int32),
    )
    g_of_tile = (torch.cumsum(marks, 0, dtype=torch.int32) - 1).long()
    tmeta = meta[g_of_tile].T.contiguous()
    pix_base = (
        torch.arange(T_pad, dtype=torch.int32, device=dev) - starts[g_of_tile]
    ) * TP
    tmeta[6] = pix_base
    return tmeta


def _chunk_elems(device: torch.device) -> int:
    # Bounds each [tiles, TP, L] temporary: ~8 MiB on the host, ~256 MiB
    # on the card (fewer, larger launches).
    return 1 << 26 if device.type == "cuda" else 1 << 21


def render_tiles_pts(
    pts: torch.Tensor,
    mask_words: torch.Tensor,
    tmeta: torch.Tensor,
    TP: int = 256,
) -> torch.Tensor:
    """Quantized uint8 bitmaps [T, TP] over the point-chain layout: the
    plain version of the tile kernel (`sdf_jax._field_tile_pts` +
    `quantize_sdf`, same op order).

    pts: [2, N] f32; mask_words: [N//32] i32 lane-validity bits; tmeta:
    [8, T] i32 rows ``x0, y0, w, h, npts, off, pix_base, _``. Segment i
    is ``(pts[:, i], pts[:, i+1])``, live iff mask bit i is set and
    ``off <= i < off + npts - 1``. Rows with pix_base ≥ w·h are zeros.
    Runs over chunks of tiles so that each [tiles, TP, L] temporary
    stays bounded."""
    dev = pts.device
    T = tmeta.shape[1]
    N = pts.shape[1]
    out = torch.zeros((T, TP), dtype=torch.uint8, device=dev)
    if T == 0:
        return out
    rows = tmeta.to(torch.int32)
    # Longest segment run of any tile: one host sync for the chunking.
    L = max(int(rows[4].max()) - 1, 1)
    C = max(1, _chunk_elems(dev) // (TP * L))
    iota_tp = torch.arange(TP, dtype=torch.int32, device=dev)
    iota_l = torch.arange(L, dtype=torch.int32, device=dev)
    scale = 256.0 / SDF_RADIUS
    for t0 in range(0, T, C):
        m = rows[:, t0 : t0 + C]
        x0, y0, w, h, npts, off, base = (m[k][:, None] for k in range(7))

        i = base + iota_tp
        ws = torch.clamp(w, min=1)
        x = i % ws
        row = torch.div(i, ws, rounding_mode="floor")
        y = h - 1 - row
        px = (x0.float() + x.float() + 0.5)[:, :, None]
        py = (y0.float() + y.float() + 0.5)[:, :, None]

        lane = off + iota_l
        vi = torch.clamp(lane, max=N - 1).long()
        wi = torch.clamp(lane + 1, max=N - 1).long()
        vx = pts[0][vi][:, None, :]
        vy = pts[1][vi][:, None, :]
        wx = pts[0][wi][:, None, :]
        wy = pts[1][wi][:, None, :]
        words = mask_words[torch.clamp(lane >> 5, max=mask_words.shape[0] - 1).long()]
        bits = (words >> (lane & 31)) & 1
        seg_ok = ((bits != 0) & (lane < off + npts - 1))[:, None, :]

        dx = wx - vx
        dy = wy - vy
        l2 = dx * dx + dy * dy
        l2inv = torch.where(l2 > 0.0, torch.reciprocal(l2), 0.0)
        dyinv = torch.where(dy != 0.0, torch.reciprocal(dy), 0.0)

        ex = px - vx
        ey = py - vy
        num = ex * dx + ey * dy
        tc = torch.clamp(num * l2inv, 0.0, 1.0)
        qx = ex - tc * dx
        qy = ey - tc * dy
        d2 = torch.where(seg_ok, qx * qx + qy * qy, _BIG)
        del num, tc, qx, qy
        dmin = torch.amin(d2, dim=2)
        del d2

        c1 = vy <= py
        cross = c1 ^ (wy <= py)
        cx = vx + (ey * dyinv) * dx
        hit = cross & (cx <= px) & seg_ok
        del cross, cx, ex, ey
        wn = torch.sum(torch.where(hit, torch.where(c1, 1, -1), 0), dim=2)

        d = torch.sqrt(dmin)
        d = torch.where(wn != 0, -d, d)
        v = d * scale + CUTOFF
        byte = torch.floor(torch.clamp(255.0 - v, 0.0, 255.0) + 0.5)
        byte = torch.where(base < w * h, byte, 0.0)
        out[t0 : t0 + C] = byte.to(torch.uint8)
    return out
