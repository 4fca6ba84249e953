"""Plain reference of the SDF render: every glyph's bitmap from its
segment soup, in float64, by the definition.

For each pixel centre ``(x0 + x + 0.5, y0 + y + 0.5)`` of a glyph's
bitmap: the distance to the nearest segment (the projection clamped to
the segment, its end points taken exactly where the projection falls
outside it or the segment has no length), negative where the winding
number of the half-open row crossings left of the pixel is not 0; then
``byte = floor(clamp(255 − (d·256/8 + 64), 0, 255) + 0.5)``, stored with
the top row first. Plain torch on any device: glyphs go in blocks of
similar segment counts, padded within a block, so that a block's
[glyphs, pixels, segments] temporaries stay bounded. ``dtype`` other
than float64 computes the same in that precision (the control).

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

SDF_RADIUS = 8.0
CUTOFF = 64.0


def _block_bytes(segs, smask, px, py, pmask, dtype):
    """Bytes [G, P] (as float) of pixels px, py [G, P] against segments
    [G, S, 4] where ``smask`` [G, S]."""
    vx, vy, wx, wy = (segs[..., i][:, None, :] for i in range(4))
    ok = smask[:, None, :]
    pxc, pyc = px[:, :, None], py[:, :, None]
    dx, dy = wx - vx, wy - vy
    l2 = dx * dx + dy * dy
    t = ((pxc - vx) * dx + (pyc - vy) * dy) / l2
    use_v = (t < 0.0) | (l2 == 0.0) | torch.isnan(t)
    use_w = (t > 1.0) & ~use_v
    qx = torch.where(use_v, vx, torch.where(use_w, wx, vx + t * dx))
    qy = torch.where(use_v, vy, torch.where(use_w, wy, vy + t * dy))
    del t, use_v, use_w
    ddx, ddy = pxc - qx, pyc - qy
    del qx, qy
    d2 = torch.where(ok, ddx * ddx + ddy * ddy, torch.inf)
    del ddx, ddy
    d = torch.sqrt(torch.amin(d2, dim=2))
    del d2
    up = (vy <= pyc) & (wy > pyc)
    dn = (vy > pyc) & (wy <= pyc)
    tr = (pyc - vy) / (wy - vy)
    cx = vx + tr * dx
    hit = (up | dn) & (cx <= pxc) & ok
    wn = torch.sum(torch.where(hit, torch.where(up, 1, -1), 0), dim=2)
    del up, dn, tr, cx, hit
    d = torch.where(wn != 0, -d, d)
    v = d * (256.0 / SDF_RADIUS) + CUTOFF
    out = torch.floor(torch.clamp(255.0 - v, 0.0, 255.0) + 0.5)
    return torch.where(pmask, out, 0.0)


def render(segs: np.ndarray, seg_glyph: np.ndarray, width, height, x0, y0,
           device="cpu", dtype=torch.float64, pairs_per_block: int | None = None):
    """Bitmaps of every glyph: ``segs`` [S, 4] pixel-space segments,
    ``seg_glyph`` [S] their glyph (sorted), and per glyph [G] its bitmap
    ``width``, ``height`` and origin ``x0``, ``y0``. Returns (bytes [Σ
    w·h] uint8, each glyph's first index [G]) in glyph order, each
    bitmap with its top row first."""
    device = torch.device(device)
    width, height = np.asarray(width, np.int64), np.asarray(height, np.int64)
    x0, y0 = np.asarray(x0, np.int64), np.asarray(y0, np.int64)
    G = len(width)
    npix = width * height
    starts = np.concatenate([[0], np.cumsum(npix)[:-1]])
    out = np.zeros(int(npix.sum()), np.uint8)
    nseg = np.bincount(seg_glyph, minlength=G)
    seg_start = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    budget = pairs_per_block or (1 << 25 if device.type == "cuda" else 1 << 20)
    order = np.argsort(nseg * np.maximum(npix, 1), kind="stable")
    segs_t = torch.as_tensor(segs, dtype=torch.float64)
    i = 0
    while i < G:
        j = i + 1
        s_max, p_max = int(nseg[order[i]]), int(npix[order[i]])
        while j < G:
            s2, p2 = max(s_max, int(nseg[order[j]])), max(p_max, int(npix[order[j]]))
            if (j + 1 - i) * s2 * p2 > budget:
                break
            s_max, p_max, j = s2, p2, j + 1
        blk = order[i:j]
        g = len(blk)
        s_max, p_max = max(s_max, 1), max(p_max, 1)
        sidx = seg_start[blk][:, None] + np.arange(s_max)[None, :]
        smask = np.arange(s_max)[None, :] < nseg[blk][:, None]
        bsegs = segs_t[torch.as_tensor(np.where(smask, sidx, 0).reshape(-1))].reshape(g, s_max, 4)
        k = np.arange(p_max)[None, :]
        w = np.maximum(width[blk], 1)[:, None]
        px = x0[blk][:, None] + k % w + 0.5
        py = y0[blk][:, None] + (height[blk][:, None] - 1 - k // w) + 0.5
        pmask = k < npix[blk][:, None]
        to = dict(device=device, dtype=dtype)
        b = _block_bytes(bsegs.to(**to), torch.as_tensor(smask, device=device),
                         torch.as_tensor(px, **to), torch.as_tensor(py, **to),
                         torch.as_tensor(pmask, device=device), dtype)
        b = b.to(torch.uint8).cpu().numpy()
        for r, gi in enumerate(blk):
            out[starts[gi]:starts[gi] + npix[gi]] = b[r, :npix[gi]]
        i = j
    return out, starts
