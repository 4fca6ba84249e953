"""Plain PyTorch versions of the port's device ops.

Device-agnostic functions on tensors. They are the counterparts of the
XLA prepass steps and of three Pallas kernels of
`versatiles_glyphs_tpu.ops.sdf_pallas` / `ops.sdf_grad`: the render
tile kernel, the fitting min field and its backward reduction. They
keep the op order of the JAX package's twins (`ops.sdf_jax`), so the
render bytes and the min field are bit-identical to the JAX package's
on the same arrays; the backward's sums are taken in another order. The
CPU tests hold them against the JAX package, the ``torch`` backends run
them on the CPU, and `ops.sdf_cuda` takes them for CPU tensors and
holds its kernels against them on the card.
"""

from __future__ import annotations

import torch

from versatiles_glyphs_tpu.constants import CUTOFF, SDF_RADIUS
from versatiles_glyphs_tpu.render.metrics import Q16_SCALE

# ~f32 max: the distance of a masked segment (`ops.sdf_jax._BIG`).
_BIG = 3.0e38
# i32 max: the argmin of a pixel with no live segment
# (`ops.sdf_pallas._BIGI`).
_BIGI = 2147483647


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of an f32 tensor, as XLA's and the
    kernels' (``__fsqrt_rn``). `torch.sqrt` of f32 on the CPU is not
    (its vectorized path is off by one ulp on ~0.1 % of inputs); taken
    in f64 and rounded once to f32, it is."""
    return torch.sqrt(x.double()).to(x.dtype)


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


def _pixel_centers(rows: torch.Tensor, TP: int):
    """Pixel centers (px, py) and flat pixel indices i, each [C, TP], of
    tile rows [8, C] (`sdf_jax._min_field_tile_pts` decomposition:
    integer div/mod, Y flipped)."""
    x0, y0, w, h, base = (rows[k][:, None] for k in (0, 1, 2, 3, 6))
    i = base + torch.arange(TP, dtype=torch.int32, device=rows.device)
    ws = torch.clamp(w, min=1)
    x = i % ws
    row = torch.div(i, ws, rounding_mode="floor")
    y = h - 1 - row
    return x0.float() + x.float() + 0.5, y0.float() + y.float() + 0.5, i


def _tile_chunks(pts, mask_words, tmeta, TP: int):
    """The pair math of the tile kernels over chunks of tile rows, in
    `sdf_jax._field_tile_pts` op order. Yields ``(t0, rows [8, C],
    lane [C, 1, L] global lanes, d2 [C, TP, L] (masked segments
    `_BIG`), wn [C, TP])``; every [C, TP, L] temporary stays bounded."""
    dev = pts.device
    T = tmeta.shape[1]
    N = pts.shape[1]
    rows = tmeta.to(torch.int32)
    # Longest segment run of any tile: one host sync for the chunking.
    L = max(int(rows[4].max()) - 1, 1)
    C = max(1, _chunk_elems(dev) // (TP * L))
    iota_l = torch.arange(L, dtype=torch.int32, device=dev)
    for t0 in range(0, T, C):
        m = rows[:, t0 : t0 + C]
        npts, off = m[4][:, None], m[5][:, None]
        px, py, _ = _pixel_centers(m, TP)
        px = px[:, :, None]
        py = py[:, :, None]

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

        c1 = vy <= py
        cross = c1 ^ (wy <= py)
        cx = vx + (ey * dyinv) * dx
        hit = cross & (cx <= px) & seg_ok
        del cross, cx, ex, ey
        wn = torch.sum(torch.where(hit, torch.where(c1, 1, -1), 0), dim=2)
        yield t0, m, lane[:, None, :], d2, wn


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
    out = torch.zeros((tmeta.shape[1], TP), dtype=torch.uint8, device=pts.device)
    if tmeta.shape[1] == 0:
        return out
    scale = 256.0 / SDF_RADIUS
    for t0, m, _, d2, wn in _tile_chunks(pts, mask_words, tmeta, TP):
        dmin = torch.amin(d2, dim=2)
        del d2
        d = sqrt_rn(dmin)
        d = torch.where(wn != 0, -d, d)
        v = d * scale + CUTOFF
        byte = torch.floor(torch.clamp(255.0 - v, 0.0, 255.0) + 0.5)
        byte = torch.where(m[6][:, None] < m[2][:, None] * m[3][:, None], byte, 0.0)
        out[t0 : t0 + m.shape[1]] = byte.to(torch.uint8)
    return out


def min_field_pts(
    pts: torch.Tensor,
    mask_words: torch.Tensor,
    tmeta: torch.Tensor,
    TP: int = 256,
):
    """Min-distance residuals over the point-chain layout: the plain
    version of the min-field kernel (`sdf_jax._min_field_tile_pts`, same
    op order). Inputs as `render_tiles_pts` (pts f32). Returns (d2
    [T, TP] f32 min of d², wn [T, TP] i32 winding number, am [T, TP] i32
    global lane of the first argmin segment, `_BIGI` where no segment is
    live). Rows with pix_base ≥ w·h are 0 in all three."""
    dev = pts.device
    T = tmeta.shape[1]
    d2_out = torch.zeros((T, TP), dtype=torch.float32, device=dev)
    wn_out = torch.zeros((T, TP), dtype=torch.int32, device=dev)
    am_out = torch.zeros((T, TP), dtype=torch.int32, device=dev)
    if T == 0:
        return d2_out, wn_out, am_out
    for t0, m, lane, d2, wn in _tile_chunks(pts, mask_words, tmeta, TP):
        dmin = torch.amin(d2, dim=2)
        amin = torch.amin(torch.where(d2 == dmin[:, :, None], lane, _BIGI), dim=2)
        del d2
        amin = torch.where(dmin < _BIG, amin, _BIGI)
        live = m[6][:, None] < m[2][:, None] * m[3][:, None]
        C = m.shape[1]
        d2_out[t0 : t0 + C] = torch.where(live, dmin, 0.0)
        wn_out[t0 : t0 + C] = torch.where(live, wn, 0).to(torch.int32)
        am_out[t0 : t0 + C] = torch.where(live, amin, 0).to(torch.int32)
    return d2_out, wn_out, am_out


def min_field_bwd_pts(
    pts: torch.Tensor,
    am: torch.Tensor,
    ct_d2: torch.Tensor,
    tmeta: torch.Tensor,
    TP: int = 256,
) -> torch.Tensor:
    """Gradient of the min field's d² w.r.t. the points: the plain
    version of the backward kernel (`sdf_grad._bwd_kernel_flat`).

    am [T, TP] i32 argmin lanes of `min_field_pts`, ct_d2 [T, TP] f32
    cotangent g of d². For each pixel with a live argmin a, tc and q
    are recomputed on segment (a, a+1) in the forward's op order; the
    pixel adds 2g·q·(tc−1) at lane a and −2g·q·tc at lane a+1. Pixels
    with the `_BIGI` sentinel, pixels past w·h and skip rows (which carry
    am = 0) add nothing. Returns dpts [2, N] f32."""
    N = pts.shape[1]
    dpts = torch.zeros((2, N), dtype=torch.float32, device=pts.device)
    if tmeta.shape[1] == 0:
        return dpts
    rows = tmeta.to(torch.int32)
    px, py, i = _pixel_centers(rows, TP)
    npix = (rows[2] * rows[3])[:, None]
    live = (am != _BIGI) & (i < npix) & (rows[6][:, None] < npix)
    a = torch.where(live, am, 0).clamp(0, N - 2).long()
    vx, vy = pts[0][a], pts[1][a]
    dx = pts[0][a + 1] - vx
    dy = pts[1][a + 1] - vy
    l2 = dx * dx + dy * dy
    l2inv = torch.where(l2 > 0.0, torch.reciprocal(l2), 0.0)
    ex = px - vx
    ey = py - vy
    num = ex * dx + ey * dy
    tc = torch.clamp(num * l2inv, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    g2 = 2.0 * ct_d2
    a = a.reshape(-1)
    for k, q in enumerate((qx, qy)):
        gq = g2 * q
        dpts[k].index_add_(0, a, torch.where(live, gq * (tc - 1.0), 0.0).reshape(-1))
        dpts[k].index_add_(0, a + 1, torch.where(live, -(gq * tc), 0.0).reshape(-1))
    return dpts
