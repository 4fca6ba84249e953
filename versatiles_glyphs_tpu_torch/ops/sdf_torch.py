"""Plain PyTorch versions of the port's device ops.

Device-agnostic functions on tensors. They are the counterparts of the
XLA prepass steps and of the Pallas kernels of
`versatiles_glyphs_tpu.ops.sdf_pallas` / `ops.sdf_grad` / `ops.legacy`
and of the measurement scripts: the render tile kernel over the point
chain (also the plain version of its split variant, the same function),
the fitting min field and its backward reduction over the point chain,
the padded-layout min field and its backward, the two renders over the
flat segment layout, and the synthetic ALU roof; and the padded-layout
render of the JAX ``--renderer jax`` (`sdf_jax.render_bitmaps_jax`,
jnp code that XLA compiles, with no kernel: its torch ops here are its
port on any device).
They keep the op order of the JAX package's kernels and twins
(`ops.sdf_jax`, `ops.sdf_grad._pair_terms`), so the render bytes and the
min fields are bit-identical to the JAX package's on the same arrays;
the backwards' sums are taken in another order. The CPU tests hold them
against the JAX package, the ``torch`` backends run them on the CPU,
and `ops.sdf_cuda` / `ops.legacy` take them for CPU tensors and hold
their kernels against them on the card.
"""

from __future__ import annotations

import torch

from ..constants import CUTOFF, SDF_RADIUS
from ..render.metrics import Q16_SCALE

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


def _pair_d2_steps(px, py, vx, vy, wx, wy, seg_ok):
    """The pair math of every kernel: d² (masked segments `_BIG`) and
    the winding step (+1, −1 or 0) of pixels ``px, py [..., TP, 1]``
    against segments ``vx … wy [..., 1, L]`` (live where ``seg_ok``), in
    `sdf_jax._field_tile_pts` op order. The crossing is the parity form
    (`csrc/sdf_pair.cuh` says why it equals the older up/down form).
    Returns (d2 [..., TP, L], steps [..., TP, L] i64)."""
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
    return d2, torch.where(hit, torch.where(c1, 1, -1), 0)


def _pair_d2_wn(px, py, vx, vy, wx, wy, seg_ok):
    """`_pair_d2_steps` with the steps summed over the segments: (d2
    [..., TP, L], winding number wn [..., TP])."""
    d2, steps = _pair_d2_steps(px, py, vx, vy, wx, wy, seg_ok)
    return d2, torch.sum(steps, dim=-1)


def _first_argmin(d2, lane):
    """(min of d² over the last axis, the first lane that reaches it, or
    `_BIGI` where every segment is masked)."""
    dmin = torch.amin(d2, dim=-1)
    amin = torch.amin(torch.where(d2 == dmin[..., None], lane, _BIGI), dim=-1)
    return dmin, torch.where(dmin < _BIG, amin, _BIGI)


def _sdf_bytes(dmin, wn):
    """Quantized SDF bytes (as f32) of the min d² and winding
    (`sdf_jax.quantize_sdf` of ``±sqrt``)."""
    d = sqrt_rn(dmin)
    d = torch.where(wn != 0, -d, d)
    v = d * (256.0 / SDF_RADIUS) + CUTOFF
    return torch.floor(torch.clamp(255.0 - v, 0.0, 255.0) + 0.5)


def _tile_chunks(pts, mask_words, tmeta, TP: int, pair=_pair_d2_wn):
    """The pair math of the tile kernels over chunks of tile rows, in
    `sdf_jax._field_tile_pts` op order. Yields ``(t0, rows [8, C],
    lane [C, 1, L] global lanes, d2 [C, TP, L] (masked segments
    `_BIG`), wn [C, TP])``; every [C, TP, L] temporary stays bounded.
    With ``pair=_pair_d2_steps`` the last item is the winding steps
    [C, TP, L] instead of their sum."""
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
        words = mask_words[torch.clamp(lane >> 5, max=mask_words.shape[0] - 1).long()]
        bits = (words >> (lane & 31)) & 1
        seg_ok = ((bits != 0) & (lane < off + npts - 1))[:, None, :]
        d2, wn = pair(
            px, py, pts[0][vi][:, None, :], pts[1][vi][:, None, :],
            pts[0][wi][:, None, :], pts[1][wi][:, None, :], seg_ok,
        )
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
    for t0, m, _, d2, wn in _tile_chunks(pts, mask_words, tmeta, TP):
        dmin = torch.amin(d2, dim=2)
        del d2
        byte = _sdf_bytes(dmin, wn)
        byte = torch.where(m[6][:, None] < m[2][:, None] * m[3][:, None], byte, 0.0)
        out[t0 : t0 + m.shape[1]] = byte.to(torch.uint8)
    return out


# Steps of (multiply, add, min) in one chunk of the ALU roof's
# recurrence: 30 f32 operations.
ALU_ROOF_TRIPLES = 10


def alu_roof(T: int, TP: int, n_chunk: int, device=None) -> torch.Tensor:
    """The synthetic ALU roof's recurrence on a tensor: the plain version
    of ``csrc/alu_roof.cu`` (the body of `_roof_kernel` in the JAX
    package's ``scripts/roofline.py``). An accumulator [T, TP] f32 starts
    at 1.0; each of ``n_chunk`` chunks applies ``a = a * 1.000001 + x;
    a = min(a, 3e38)`` ten times, x = 0.5, 1.5, … by chunk. Multiply,
    add and min are separate ops on f32 tensors, so nothing contracts
    into an FMA and the kernel's result is bit-equal."""
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.full((T, TP), 1.0, **f32)
    c = torch.tensor(1.000001, **f32)
    big = torch.tensor(_BIG, **f32)
    for k in range(n_chunk):
        x = torch.tensor(0.5 + k, **f32)
        for _ in range(ALU_ROOF_TRIPLES):
            a = torch.minimum(a * c + x, big)
    return a


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
        dmin, amin = _first_argmin(d2, lane)
        del d2
        live = m[6][:, None] < m[2][:, None] * m[3][:, None]
        C = m.shape[1]
        d2_out[t0 : t0 + C] = torch.where(live, dmin, 0.0)
        wn_out[t0 : t0 + C] = torch.where(live, wn, 0).to(torch.int32)
        am_out[t0 : t0 + C] = torch.where(live, amin, 0).to(torch.int32)
    return d2_out, wn_out, am_out


def _flat_bwd_pixels(pts, am, ct_d2, tmeta, TP: int):
    """Per pixel [T, TP] of the flat backward: whether it counts (a row
    and a pixel below w·h, its am a segment lane of the row's run
    [off, off + npts − 1): the sentinel `_BIGI` and any other lane add
    nothing, whatever the cotangent), that lane (0 where it does not
    count), tc, qx, qy recomputed on segment (a, a+1) in the forward's
    op order, and g2 = 2g."""
    N = pts.shape[1]
    rows = tmeta.to(torch.int32)
    px, py, i = _pixel_centers(rows, TP)
    npix = (rows[2] * rows[3])[:, None]
    off = rows[5][:, None]
    live = (i < npix) & (rows[6][:, None] < npix) & (am >= off) & (am < off + rows[4][:, None] - 1)
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
    return live, a, tc, ex - tc * dx, ey - tc * dy, 2.0 * ct_d2


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
    cotangent g of d². For each pixel below w·h whose argmin a is a
    segment lane of its row's run, tc and q are recomputed on segment
    (a, a+1) in the forward's op order; the pixel adds 2g·q·(tc−1) at
    lane a and −2g·q·tc at lane a+1 (`index_add_`, in no fixed order on
    the card). Pixels with the `_BIGI` sentinel, pixels past w·h and skip
    rows (which carry am = 0) add nothing. Returns dpts [2, N] f32."""
    N = pts.shape[1]
    dpts = torch.zeros((2, N), dtype=torch.float32, device=pts.device)
    if tmeta.shape[1] == 0:
        return dpts
    live, a, tc, qx, qy, g2 = _flat_bwd_pixels(pts, am, ct_d2, tmeta, TP)
    a = a.reshape(-1)
    for k, q in enumerate((qx, qy)):
        gq = g2 * q
        dpts[k].index_add_(0, a, torch.where(live, gq * (tc - 1.0), 0.0).reshape(-1))
        dpts[k].index_add_(0, a + 1, torch.where(live, -(gq * tc), 0.0).reshape(-1))
    return dpts


def min_field_bwd_pts_ordered(
    pts: torch.Tensor,
    am: torch.Tensor,
    ct_d2: torch.Tensor,
    tmeta: torch.Tensor,
    TP: int = 256,
) -> torch.Tensor:
    """`min_field_bwd_pts` as the backward kernel sums it: per lane L,
    A_L = Σ 2g·q and B_L = Σ 2g·q·tc over the pixels whose am is L, each
    sum a sequential f32 loop in pixel order (a glyph's tile rows up,
    pixels up), then dpts[L] = (B_L − A_L) − B_{L−1} over each glyph's
    lanes [off, off + npts), with B of the lane before the run 0. Step
    (k, j) adds pixel k·TP + j of every glyph onto its lane's sums; glyph
    lane runs are disjoint, so no step adds twice to one element, and
    the order of every sum is the pixels' (on any device). Only a glyph's
    first row (pix_base 0, w·h > 0) owns lanes, as in the kernel. The
    counterpart of `min_field_padded_bwd_ordered`: a reference, not a
    fast path (TP steps a tile row of the largest glyph)."""
    N = pts.shape[1]
    dev = pts.device
    dpts = torch.zeros((2, N), dtype=torch.float32, device=dev)
    T = tmeta.shape[1]
    if T == 0:
        return dpts
    rows = tmeta.to(torch.int32)
    live, a, tc, qx, qy, g2 = _flat_bwd_pixels(pts, am, ct_d2, tmeta, TP)
    gqx, gqy = g2 * qx, g2 * qy
    terms = torch.where(live, torch.stack([gqx, gqy, gqx * tc, gqy * tc]), 0.0)  # [4, T, TP]
    lane = torch.where(live, a, N)  # column N takes the zeros of pixels that do not count
    sums = torch.zeros((4, N + 1), dtype=torch.float32, device=dev)  # ax, ay, bx, by
    npix = rows[2] * rows[3]
    k_of = torch.where(rows[6] < npix, torch.div(rows[6], TP, rounding_mode="floor"), -1)
    for k in range(int(k_of.max()) + 1):  # one host sync
        ks = torch.nonzero(k_of == k).reshape(-1)
        for j in range(TP):
            cols = lane[ks, j]
            sums[:, cols] += terms[:, ks, j]
    first = (rows[6] == 0) & (npix > 0) & (rows[4] >= 1)
    off, npts = rows[5][first].long(), rows[4][first].long()
    start = torch.repeat_interleave(off, npts)
    lanes = start + torch.arange(start.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(npts, 0) - npts, npts)
    prev = torch.where(lanes > start, sums[2:, lanes - 1], 0.0)
    dpts[:, lanes] = (sums[2:, lanes] - sums[:2, lanes]) - prev
    return dpts


# -- the flat segment layout (TPU kernels 6 and 7, `ops.legacy`) --------


def render_tiles_flat(flat: torch.Tensor, tmeta: torch.Tensor, TP: int = 256) -> torch.Tensor:
    """Quantized uint8 bitmaps [T, TP] over the flat segment layout: the
    plain version of the legacy tile kernel (`legacy._sdf_kernel_tiles`;
    `sdf_jax._field_tile_flat` + `quantize_sdf`, same op order).

    flat: [4, N] f32 rows vx, vy, wx, wy, one segment a lane
    (`render.batch.pack_flat`); tmeta: [8, T] i32 rows ``x0, y0, w, h,
    nseg, seg_off, pix_base, _``. A row's segments are lanes
    ``[seg_off, seg_off + nseg)``, all live. Rows with pix_base ≥ w·h
    are zeros. Runs over chunks of rows so that each [rows, TP, L]
    temporary stays bounded."""
    dev = flat.device
    T = tmeta.shape[1]
    out = torch.zeros((T, TP), dtype=torch.uint8, device=dev)
    if T == 0:
        return out
    N = flat.shape[1]
    rows = tmeta.to(torch.int32)
    # Longest segment run of any row: one host sync for the chunking.
    L = max(int(rows[4].max()), 1)
    C = max(1, _chunk_elems(dev) // (TP * L))
    iota_l = torch.arange(L, dtype=torch.int32, device=dev)
    for t0 in range(0, T, C):
        m = rows[:, t0 : t0 + C]
        px, py, _ = _pixel_centers(m, TP)
        lane = torch.clamp(m[5][:, None] + iota_l, 0, N - 1).long()
        seg = flat[:, lane][:, :, None, :]  # [4, C, 1, L]
        seg_ok = (iota_l < m[4][:, None])[:, None, :]
        d2, wn = _pair_d2_wn(px[:, :, None], py[:, :, None], *seg, seg_ok)
        dmin = torch.amin(d2, dim=2)
        del d2
        byte = _sdf_bytes(dmin, wn)
        byte = torch.where(m[6][:, None] < m[2][:, None] * m[3][:, None], byte, 0.0)
        out[t0 : t0 + m.shape[1]] = byte.to(torch.uint8)
    return out


def grid_tmeta(meta: torch.Tensor, P: int, TP: int) -> torch.Tensor:
    """The tile table [8, G·P/TP] i32 of a padded [G, P] grid: glyph g's
    row of meta [G, 8] (x0, y0, w, h, nseg, seg_off, …) once per pixel
    tile, with pix_base 0, TP, 2·TP, … (TP divides P)."""
    nt = P // TP
    rows = meta.to(torch.int32).repeat_interleave(nt, dim=0).T.contiguous()
    rows[6] = torch.arange(rows.shape[1], dtype=torch.int32, device=meta.device) % nt * TP
    return rows


def render_grid_flat(
    flat: torch.Tensor, meta: torch.Tensor, P: int, TP: int = 1024
) -> torch.Tensor:
    """Quantized uint8 bitmaps [G, P] over the flat segment layout on a
    padded grid: the plain version of the legacy grid kernel
    (`legacy._sdf_kernel`). meta: [G, 8] i32 (x0, y0, w, h, nseg,
    seg_off, _, _); TP divides P. A pixel tile whose base is at or past
    w·h is zeros; the pixels in [w·h, P) of a live tile are computed
    from their out-of-range coordinates, as the TPU kernel does. (The
    jnp twin `sdf_jax.render_bitmaps_flat_jax` computes every tile, so
    the two agree on the live tiles.) Each glyph's tiles are rows of
    `render_tiles_flat`."""
    G = meta.shape[0]
    return render_tiles_flat(flat, grid_tmeta(meta, P, TP), TP).reshape(G, P)


# -- the padded per-glyph layout (TPU kernels 4 and 5, `ops.sdf_grad`) --


def pixel_coords(meta: torch.Tensor, P: int):
    """Pixel centers (px, py) [B, P] f32 of the first P flat pixels of
    each glyph, and whether each is below w·h (counterpart of
    `sdf_jax.pixel_coords`, over a batch). meta [B, ≥4] i32 (x0, y0, w,
    h): index i is bitmap position (i mod w, i div w), render row
    ``h - 1 - row``; integer div and mod, which give the TPU kernels'
    f32-division rows for every index below 2²³."""
    rows = torch.zeros((8, meta.shape[0]), dtype=torch.int32, device=meta.device)
    rows[:4] = meta[:, :4].T
    px, py, i = _pixel_centers(rows, P)
    return px, py, i < rows[2][:, None] * rows[3][:, None]


def min_field_padded(segs: torch.Tensor, mask: torch.Tensor, meta: torch.Tensor, P: int):
    """Min-distance residuals on the padded per-glyph layout: the plain
    version of the padded min-field kernel (`sdf_grad._fwd_kernel`,
    `_pair_terms` op order).

    segs [B, S, 4] f32 (vx, vy, wx, wy), mask [B, S] (nonzero = live),
    meta [B, ≥4] i32 (x0, y0, w, h), P pixels per glyph (flat PBF order;
    pixels past w·h are computed from their out-of-range coordinates).
    Returns (d2 [B, P] f32 min of d², wn [B, P] i32 winding number, am
    [B, P] i32 first argmin segment, `_BIGI` where no segment is live).
    Runs over chunks of glyphs so that each [glyphs, P, S] temporary
    stays bounded."""
    dev = segs.device
    B, S = segs.shape[:2]
    d2_out = torch.full((B, P), _BIG, dtype=torch.float32, device=dev)
    wn_out = torch.zeros((B, P), dtype=torch.int32, device=dev)
    am_out = torch.full((B, P), _BIGI, dtype=torch.int32, device=dev)
    if B == 0 or P == 0 or S == 0:
        return d2_out, wn_out, am_out
    meta = meta.to(torch.int32)
    C = max(1, _chunk_elems(dev) // (P * S))
    lane = torch.arange(S, dtype=torch.int32, device=dev)
    for b0 in range(0, B, C):
        px, py, _ = pixel_coords(meta[b0 : b0 + C], P)
        sg = segs[b0 : b0 + C].permute(2, 0, 1)[:, :, None, :]  # [4, C, 1, S]
        ok = (mask[b0 : b0 + C] != 0)[:, None, :]
        d2, wn = _pair_d2_wn(px[:, :, None], py[:, :, None], *sg, ok)
        dmin, amin = _first_argmin(d2, lane)
        del d2
        d2_out[b0 : b0 + C] = dmin
        wn_out[b0 : b0 + C] = wn.to(torch.int32)
        am_out[b0 : b0 + C] = amin.to(torch.int32)
    return d2_out, wn_out, am_out


def _padded_bwd_terms(segs, meta, am, ct_d2):
    """Per pixel of the padded backward: whether its argmin is a segment
    (0 ≤ am < S), that segment's index (0 where it is none) and its four
    terms [B, P, 4] (2g·q·(tc−1) for dv, −2g·q·tc for dw; zeros where am
    is no segment), tc and q recomputed in the forward's op order."""
    B, S = segs.shape[:2]
    P = am.shape[1]
    px, py, _ = pixel_coords(meta.to(torch.int32), P)
    live = (am >= 0) & (am < S)
    a = torch.where(live, am, 0).long()
    vx, vy, wx, wy = segs.gather(1, a[:, :, None].expand(B, P, 4)).unbind(-1)
    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = torch.where(l2 > 0.0, torch.reciprocal(l2), 0.0)
    ex = px - vx
    ey = py - vy
    num = ex * dx + ey * dy
    tc = torch.clamp(num * l2inv, 0.0, 1.0)
    gqx = (2.0 * (ex - tc * dx)) * ct_d2
    gqy = (2.0 * (ey - tc * dy)) * ct_d2
    terms = torch.stack([gqx * (tc - 1.0), gqy * (tc - 1.0), -(gqx * tc), -(gqy * tc)], dim=-1)
    return live, a, torch.where(live[:, :, None], terms, 0.0)


def min_field_padded_bwd(
    segs: torch.Tensor, meta: torch.Tensor, am: torch.Tensor, ct_d2: torch.Tensor
) -> torch.Tensor:
    """Gradient of the padded min field's d² w.r.t. the segments: the
    plain version of the padded backward kernel (`sdf_grad._bwd_kernel`),
    in the direct per-pixel form.

    am [B, P] i32 argmin segments of `min_field_padded`, ct_d2 [B, P]
    f32 cotangent g of d². Each pixel with a live argmin s gathers its
    segment, recomputes tc and q in the forward's op order and adds
    2g·q·(tc−1) to dv and −2g·q·tc to dw of segment s (`index_add_`).
    Pixels past w·h count (the caller's cotangent masks them); the
    `_BIGI` sentinel adds nothing. Returns dsegs [B, S, 4] f32 (dvx,
    dvy, dwx, dwy)."""
    B, S = segs.shape[:2]
    P = am.shape[1]
    dsegs = torch.zeros((B, S, 4), dtype=torch.float32, device=segs.device)
    if B == 0 or S == 0 or P == 0:
        return dsegs
    _, a, terms = _padded_bwd_terms(segs, meta, am, ct_d2)
    rows = torch.arange(B, device=segs.device)[:, None] * S + a
    dsegs.view(B * S, 4).index_add_(0, rows.reshape(-1), terms.reshape(-1, 4))
    return dsegs


def min_field_padded_bwd_ordered(
    segs: torch.Tensor, meta: torch.Tensor, am: torch.Tensor, ct_d2: torch.Tensor
) -> torch.Tensor:
    """`min_field_padded_bwd` with each segment's sum taken in pixel
    order: a sequential f32 loop over the pixels, every glyph at once.
    Step p adds pixel p's terms of every glyph onto its argmin segment's
    sums; a glyph has one pixel p, so no step adds twice to one element
    and the order of every sum is the pixels' (on any device). The
    padded backward kernel sums in this order while one warp walks a
    glyph, and then gives these bits. P small kernels' worth of steps: a
    reference, not a fast path."""
    B, S = segs.shape[:2]
    P = am.shape[1]
    dsegs = torch.zeros((B, S, 4), dtype=torch.float32, device=segs.device)
    if B == 0 or S == 0 or P == 0:
        return dsegs
    # A pixel with no segment adds zeros at segment 0, which changes no
    # sum: a sum starts at +0.0 and is never -0.0.
    _, a, terms = _padded_bwd_terms(segs, meta, am, ct_d2)
    glyphs = torch.arange(B, device=segs.device)
    for p in range(P):
        dsegs[glyphs, a[:, p]] += terms[:, p]
    return dsegs


# -- the padded-layout render (`sdf_jax.render_bitmaps_jax`) ------------

# Component rows of the packed segment tensor [G, 8, S] that
# `render.batch.pack_segments` fills (`sdf_jax`'s row indices; row 7 is
# spare).
VX, VY, DX, DY, L2INV, DYINV, WY = range(7)


def padded_field(segs: torch.Tensor, meta: torch.Tensor, P: int):
    """The min of d² and the winding number of each glyph's first P
    pixels over its packed segments: `sdf_jax._field_one` for a batch of
    glyphs, in its op order, up to the square root.

    segs [G, 8, S] f32 component rows (`VX` … `WY`, the divisions done
    on the host in f64), meta [G, ≥5] i32 (x0, y0, w, h, nseg). Each op
    is elementwise over (glyph, pixel, segment), a float min or an int32
    sum over the segments, so a batch of any size gives each glyph's
    bits. Returns (d2 [G, P] f32, masked segments `_BIG`; wn [G, P]
    i32)."""
    meta = meta.to(torch.int32)
    px, py, _ = pixel_coords(meta, P)
    pxc = px[:, :, None]
    pyc = py[:, :, None]
    vx, vy, dx, dy, l2inv, dyinv, wy = (
        segs[:, k, None, :] for k in (VX, VY, DX, DY, L2INV, DYINV, WY))
    S = segs.shape[2]
    seg_ok = (torch.arange(S, dtype=torch.int32, device=segs.device)
              < meta[:, 4, None])[:, None, :]

    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    tc = torch.clamp(num * l2inv, 0.0, 1.0)
    del num
    qx = ex - tc * dx
    qy = ey - tc * dy
    del ex, tc
    d2 = torch.where(seg_ok, qx * qx + qy * qy, _BIG)
    del qx, qy
    dmin2 = torch.amin(d2, dim=2)
    del d2

    up = (vy <= pyc) & (wy > pyc)
    dn = (vy > pyc) & (wy <= pyc)
    cx = vx + (ey * dyinv) * dx
    sign = up.to(torch.int32) - dn.to(torch.int32)
    hit = (cx <= pxc) & seg_ok & (up | dn)
    del cx, ey
    wn = torch.sum(torch.where(hit, sign, 0), dim=2, dtype=torch.int32)
    return dmin2, wn


def render_bitmaps_padded(
    segs: torch.Tensor, meta: torch.Tensor, P: int, chunk: int | None = None
) -> torch.Tensor:
    """Quantized uint8 bitmaps [G, P] of a packed glyph batch
    (`render.batch.pack_block`): the port of
    `sdf_jax.render_bitmaps_jax(..., sequential=True)`, byte for byte,
    on the tensors' device. Pixels past w·h are computed from their
    out-of-range coordinates, as there.

    The JAX function maps glyph by glyph; this runs ``chunk`` glyphs at
    a time (None: as many as keep each [glyphs, P, S] f32 temporary
    within `_chunk_elems` pairs), which gives the same bytes at any
    chunk size (see `padded_field`)."""
    G, _, S = segs.shape
    out = torch.empty((G, P), dtype=torch.uint8, device=segs.device)
    if chunk is None:
        chunk = max(1, _chunk_elems(segs.device) // max(P * S, 1))
    for g0 in range(0, G, chunk):
        dmin2, wn = padded_field(segs[g0 : g0 + chunk], meta[g0 : g0 + chunk], P)
        out[g0 : g0 + chunk] = _sdf_bytes(dmin2, wn).to(torch.uint8)
    return out
