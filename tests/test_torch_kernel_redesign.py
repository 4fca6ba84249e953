"""The decomposition of the redesigned kernels, on the CPU.

``csrc/sdf_tiles_pts.cu`` (TPU kernel 1), ``csrc/sdf_tiles_flat.cu``
(TPU kernel 6), ``csrc/sdf_grid_flat.cu`` (TPU kernel 7),
``csrc/sdf_min_field_padded.cu`` (TPU kernel 4) and
``csrc/sdf_min_field_pts.cu`` (TPU kernel 2) compute their plain
versions' values by another route than one thread a pixel over every
segment: live segments compacted chunk by chunk in ballot order (each
with its index carried where the kernel keeps an argmin), R pixels a
thread, one staging a span of a glyph for the grid kernel and the
padded min field, and the crossing test done once a (bitmap row,
segment) with a pixel summing its row's list, falling back to the
per-pair test where a block has too many rows or a row too many
crossings. The CUDA kernels run only on the card (`chip_smoke.py`).
Here the same decomposition, written in plain PyTorch with the
launchers' own helpers (`sdf_cuda.pixels_per_thread`,
`legacy.grid_launch_shape`, `sdf_cuda.padded_launch_shape`, the chunk
and list sizes), must give

- the bytes of `sdf_torch.render_tiles_pts` / `render_tiles_flat` /
  `render_grid_flat`, the d² bits, winding and first argmin of
  `sdf_torch.min_field_padded`, and the same winding numbers as the
  per-pair test, and
- the bytes of the JAX package's jnp twins (`render_bitmaps_pts_jax`,
  `render_bitmaps_tiles_jax`, `render_bitmaps_flat_jax`) and the
  outputs of its padded forward `_run_fwd` in Pallas interpret mode,
  which run in one subprocess each with XLA's CPU backend capped below
  FMA so that every multiply and add is rounded separately, as in the
  port.

``csrc/sdf_min_field_padded_bwd.cu`` (TPU kernel 5) routes each pixel's
terms to its argmin segment: a warp walks a glyph's pixels 32 at a time,
the lanes of a step with one argmin form a set, and the set's lowest
lane adds the set's terms in lane order onto the segment's sums. The
same routing in plain Python must give the bits of a sequential f32
loop over the pixels (`sdf_torch.min_field_padded_bwd_ordered`) while
one warp walks a glyph, and the plain version within 1e-4 of the
largest gradient at every launch shape; one case is held against the
JAX package's `_run_bwd` in interpret mode.

Tolerance: 0 bytes, 0 bits, but for the backward's plain version (which
sums in another order): 1e-4 of the largest gradient.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import versatiles_glyphs_tpu_torch as pkg
from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu.render.metrics import GlyphPrep
from versatiles_glyphs_tpu_torch.models import fitting
from versatiles_glyphs_tpu_torch.ops import _build, legacy, sdf_cuda, sdf_torch
from versatiles_glyphs_tpu_torch.render import batch as tbatch
from versatiles_glyphs_tpu_torch.tools import kernel_turns, work
from versatiles_glyphs_tpu_torch.utils.synth_font import (
    PADDED_BWD_EDGE_CASES, PADDED_EDGE_CASES, curved_preps, out_of_range_argmin, padded_edge_case,
    row_list_edge_preps, synth_fit_batch, tied_point_chain, unaligned_point_chain,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, ROWS_MAX, ROW_CROSS = sdf_cuda.REC_CHUNK, sdf_cuda.ROWS_MAX, sdf_cuda.ROW_CROSS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the decomposition in plain PyTorch --


def _live_between(words, a: int, b: int) -> int:
    """Set validity bits among lanes [a, b): `live_between` of the header."""
    return sum((int(words[i >> 5]) >> (i & 31)) & 1 for i in range(a, b))


def _stage_live(words, c0: int, cend: int, nt: int) -> list[int]:
    """The lanes of [c0, cend) that a block of nt threads stages, by
    slot: a live lane's slot is the live count before its warp's 32
    lanes plus the live lanes below it in the warp's ballot."""
    slots = {}
    for i0 in range(0, cend - c0, nt):
        for warp in range(nt // 32):
            lanes = [c0 + i0 + warp * 32 + k for k in range(32)]
            ballot = [ln < cend and (int(words[ln >> 5]) >> (ln & 31)) & 1 for ln in lanes]
            before = _live_between(words, c0, min(lanes[0], cend))
            for k, ln in enumerate(lanes):
                if ballot[k]:
                    slots[before + sum(ballot[:k])] = ln
    n = _live_between(words, c0, cend)
    assert sorted(slots) == list(range(n))  # dense, no slot written twice
    return [slots[j] for j in range(n)]


def _list_crossings(y0: int, h: int, row0: int, nrows: int, vx, vy, wx, wy):
    """Per bitmap row from row0: (cx, step) of the staged segments that
    cross its center line, or None when a row lists more than
    ROW_CROSS. The expressions of the pair math."""
    dx, dy = wx - vx, wy - vy
    dyinv = torch.where(dy != 0.0, torch.reciprocal(dy), 0.0)
    lists = []
    for q in range(nrows):
        pyc = torch.tensor(float(y0)) + torch.tensor(float(h - 1 - (row0 + q))) + 0.5
        c1 = vy <= pyc
        cross = c1 ^ (wy <= pyc)
        if int(cross.sum()) > ROW_CROSS:
            return None
        cx = vx + ((pyc - vy) * dyinv) * dx
        lists.append((cx[cross], torch.where(c1, 1, -1)[cross]))
    return lists


def _span_bytes(bitmap, base: int, npx: int, chunks, stats) -> torch.Tensor:
    """Bytes (as f32) of pixels base .. base + npx − 1 of ``bitmap`` =
    (x0, y0, w, h) against the staged ``chunks`` (each vx, vy, wx, wy of
    live segments only)."""
    dmin, wn, _ = _span_fields(bitmap, base, npx, chunks, stats)
    return sdf_torch._sdf_bytes(dmin, wn)


def _span_fields(bitmap, base: int, npx: int, chunks, stats):
    """(min d², winding, first argmin) of pixels base .. base + npx − 1
    of ``bitmap`` = (x0, y0, w, h) against the staged ``chunks``: each
    vx, vy, wx, wy of live segments only, in staged order, and where the
    kernel keeps an argmin a fifth array, the index each carries. The
    running (dmin, amin) pair updates on a strict ``<`` chunk after
    chunk, a chunk's candidate being the first of its staged segments
    that reaches the chunk's min."""
    x0, y0, w, h = bitmap
    row8 = torch.tensor([[x0], [y0], [w], [h], [0], [0], [base], [0]], dtype=torch.int32)
    px, py, i = (a[0] for a in sdf_torch._pixel_centers(row8, npx))
    ws = max(w, 1)
    row0 = base // ws
    nrows = (base + npx - 1) // ws - row0 + 1
    lrow = torch.div(i, ws, rounding_mode="floor") - row0
    dmin = torch.full((npx,), sdf_torch._BIG)
    amin = torch.full((npx,), sdf_torch._BIGI, dtype=torch.int64)
    wn = torch.zeros(npx, dtype=torch.int64)
    for vx, vy, wx, wy, *carried in chunks:
        ok = torch.ones((1, len(vx)), dtype=torch.bool)
        d2, steps = sdf_torch._pair_d2_steps(px[:, None], py[:, None], vx[None], vy[None],
                                             wx[None], wy[None], ok)
        if carried:
            slot = torch.from_numpy(np.argmin(d2.numpy(), axis=1))  # the first of equals
            amin = torch.where(d2.amin(dim=1) < dmin, carried[0][slot], amin)
        dmin = torch.minimum(dmin, d2.amin(dim=1))
        per_pair = steps.sum(dim=1)
        lists = _list_crossings(y0, h, row0, nrows, vx, vy, wx, wy) if nrows <= ROWS_MAX else None
        if lists is None:
            stats["per_pair"] += 1
            wn += per_pair
            continue
        stats["by_row"] += 1
        by_row = torch.zeros_like(wn)
        for q, (cx, st) in enumerate(lists):
            sel = lrow == q
            by_row[sel] = ((cx[None, :] <= px[sel, None]) * st[None, :]).sum(dim=1)
        assert torch.equal(by_row, per_pair)
        wn += by_row
    return dmin, wn, amin


def _emulate_tiles_pts(pts, words, tmeta, TP: int, R: int, stats) -> torch.Tensor:
    """``csrc/sdf_tiles_pts.cu``: a block of TP / R threads a tile row,
    thread tid owning pixels tid + k·TP/R."""
    nt = TP // R
    assert nt % 32 == 0
    T = tmeta.shape[1]
    out = torch.zeros((T, TP), dtype=torch.uint8)
    own = torch.arange(nt)[:, None] + nt * torch.arange(R)[None, :]  # [tid, k] -> pixel
    assert sorted(own.reshape(-1).tolist()) == list(range(TP))
    for t in range(T):
        x0, y0, w, h, npts, off, base, _ = (int(v) for v in tmeta[:, t])
        if base >= w * h:
            continue
        last = off + npts - 1
        chunks = []
        for c0 in range(off, last, CHUNK):
            lanes = _stage_live(words, c0, min(c0 + CHUNK, last), nt)
            if not lanes:
                stats["empty_chunks"] += 1
                continue
            v, wv = torch.tensor(lanes), torch.tensor(lanes) + 1
            chunks.append((pts[0, v], pts[1, v], pts[0, wv], pts[1, wv]))
        byte = _span_bytes((x0, y0, w, h), base, TP, chunks, stats)
        for k in range(R):  # each thread stores its R pixels
            out[t, own[:, k]] = byte[own[:, k]].to(torch.uint8)
    return out


def _emulate_tiles_flat(flat, tmeta, TP: int, R: int, stats) -> torch.Tensor:
    """``csrc/sdf_tiles_flat.cu``: `_emulate_tiles_pts`'s tile body over
    the soup, lanes [seg_off, seg_off + nseg) staged whole in chunks."""
    nt = TP // R
    assert nt % 32 == 0
    T = tmeta.shape[1]
    out = torch.full((T, TP), 255, dtype=torch.uint8)  # every byte must be written
    own = torch.arange(nt)[:, None] + nt * torch.arange(R)[None, :]  # [tid, k] -> pixel
    for t in range(T):
        x0, y0, w, h, nseg, off, base, _ = (int(v) for v in tmeta[:, t])
        if base >= w * h:
            out[t] = 0
            continue
        chunks = []
        for c0 in range(off, off + nseg, CHUNK):
            ln = torch.arange(c0, min(c0 + CHUNK, off + nseg))
            chunks.append(tuple(flat[k, ln] for k in range(4)))
        stats["chunks"] += len(chunks)
        byte = _span_bytes((x0, y0, w, h), base, TP, chunks, stats)
        for k in range(R):  # each thread stores its R pixels
            out[t, own[:, k]] = byte[own[:, k]].to(torch.uint8)
    return out


def _emulate_min_field_pts(pts, words, tmeta, TP: int, R: int, stats):
    """``csrc/sdf_min_field_pts.cu``: `_emulate_tiles_pts`'s tile body
    with each staged segment carrying its global lane and each pixel
    keeping its first argmin; three stores a pixel, zeros in a row at or
    past w·h."""
    nt = TP // R
    assert nt % 32 == 0
    T = tmeta.shape[1]
    d2 = torch.full((T, TP), -1.0)  # every value must be written
    wn = torch.full((T, TP), -99, dtype=torch.int64)
    am = torch.full((T, TP), -99, dtype=torch.int64)
    own = torch.arange(nt)[:, None] + nt * torch.arange(R)[None, :]  # [tid, k] -> pixel
    for t in range(T):
        x0, y0, w, h, npts, off, base, _ = (int(v) for v in tmeta[:, t])
        if base >= w * h:
            d2[t], wn[t], am[t] = 0.0, 0, 0
            continue
        last = off + npts - 1
        chunks = []
        for c0 in range(off, last, CHUNK):
            lanes = _stage_live(words, c0, min(c0 + CHUNK, last), nt)
            assert lanes == sorted(lanes)  # lane order: strict `<` keeps the first argmin
            if not lanes:
                stats["empty_chunks"] += 1
                continue
            v = torch.tensor(lanes)
            chunks.append((pts[0, v], pts[1, v], pts[0, v + 1], pts[1, v + 1], v))
        stats["chunks"] = max(stats["chunks"], len(chunks))
        dmin, w_, amin = _span_fields((x0, y0, w, h), base, TP, chunks, stats)
        for k in range(R):  # each thread stores its R pixels
            d2[t, own[:, k]], wn[t, own[:, k]], am[t, own[:, k]] = (
                dmin[own[:, k]], w_[own[:, k]], amin[own[:, k]])
    return d2, wn.to(torch.int32), am.to(torch.int32)


def _emulate_padded_bwd(segs, meta, am, ct, shape, stats) -> np.ndarray:
    """``csrc/sdf_min_field_padded_bwd.cu`` at launch shape (threads a
    block, warps a glyph, segments a pass): warp k of a glyph walks the
    k-th range of its pixels in steps of 32; the lanes of a step whose
    am is one segment of the pass form a set, and the set's terms are
    added in lane order onto the segment's sums of that warp; the
    glyph's warps are summed in warp order. The terms are the plain
    version's."""
    _, wpg, s_chunk = shape
    B, S = segs.shape[:2]
    P = am.shape[1]
    terms = sdf_torch._padded_bwd_terms(segs, meta, am, ct)[2].numpy()
    am = am.numpy()
    out = np.full((B, S, 4), np.nan, np.float32)  # every value must be written
    share = (-(-P // wpg) + 31) // 32 * 32
    for b in range(B):
        for c0 in range(0, S, s_chunk):
            n = min(s_chunk, S - c0)
            acc = np.zeros((wpg, n, 4), np.float32)
            for part in range(wpg):
                p_lo = min(part * share, P)
                p_hi = min(p_lo + share, P)
                for p0 in range(p_lo, p_hi, 32):
                    sets: dict[int, list[int]] = {}
                    for p in range(p0, min(p0 + 32, p_hi)):  # lanes up: pixels up
                        if c0 <= am[b, p] < c0 + n:
                            sets.setdefault(int(am[b, p]), []).append(p)
                    for key, members in sets.items():  # the leader is members[0]
                        total = acc[part, key - c0].copy()
                        for p in members:
                            total = total + terms[b, p]
                        acc[part, key - c0] = total
                    stats["most"] = max([stats["most"], *map(len, sets.values())])
                    stats["steps"] += 1
            total = acc[0]
            for k in range(1, wpg):
                total = total + acc[k]
            assert np.isnan(out[b, c0 : c0 + n]).all()
            out[b, c0 : c0 + n] = total
            stats["passes"] += 1
    assert out.dtype == np.float32
    return out


def _stage_masked(mask_row, c0: int, cend: int, nt: int) -> list[int]:
    """The segments of [c0, cend) that a block of nt threads stages, by
    slot (`SegRecords::stage_masked`): every warp walks the run 32
    segments at a time and counts the live ones by ballot; the warp
    whose turn it is stages them, a live segment's slot being the live
    count before its 32 plus the live ones below it in the ballot."""
    nwarps = nt // 32
    slots = {}
    for wid in range(nwarps):
        before = 0
        for turn, s0 in enumerate(range(c0, cend, 32)):
            ballot = [s0 + k < cend and float(mask_row[s0 + k]) != 0.0 for k in range(32)]
            if turn % nwarps == wid:
                for k in range(32):
                    if ballot[k]:
                        assert before + sum(ballot[:k]) not in slots  # no slot written twice
                        slots[before + sum(ballot[:k])] = s0 + k
            before += sum(ballot)
    n = int((mask_row[c0:cend] != 0).sum())
    assert sorted(slots) == list(range(n))  # dense
    staged = [slots[j] for j in range(n)]
    assert staged == sorted(staged)  # segment order: strict `<` keeps the first argmin
    return staged


def _emulate_min_field_padded(segs, mask, meta, P: int, threads: int, r: int, stats):
    """``csrc/sdf_min_field_padded.cu``: a block of nt threads a (glyph,
    span of R·nt pixels), thread tid owning pixels tid + k·nt; a span
    with fewer than R slots of nt pixels below P runs them one by one,
    one pixel a thread; only live segments staged, their indices
    carried."""
    B, S = mask.shape
    nt, R, gy = sdf_cuda.padded_launch_shape(P, threads, r)
    assert nt % 32 == 0 and gy * nt * R >= P > (gy - 1) * nt * R
    d2 = torch.full((B, P), -1.0)  # every value must be written
    wn = torch.full((B, P), -99, dtype=torch.int64)
    am = torch.full((B, P), -99, dtype=torch.int64)
    for b in range(B):
        bitmap = tuple(int(v) for v in meta[b, :4])
        for y in range(gy):
            base = y * nt * R
            slots = min(-(-(P - base) // nt), R)
            stats[f"slots{slots}"] += 1
            spans = [(base, R)] if slots == R else [(base + s * nt, 1) for s in range(slots)]
            for sbase, Rk in spans:
                chunks = []
                for c0 in range(0, S, CHUNK):
                    idx = _stage_masked(mask[b], c0, min(c0 + CHUNK, S), nt)
                    stats["staged"] += len(idx)
                    if not idx:
                        stats["empty_chunks"] += 1
                        continue
                    idx = torch.tensor(idx)
                    chunks.append((*(segs[b, idx, k] for k in range(4)), idx))
                dmin, w_, amin = _span_fields(bitmap, sbase, Rk * nt, chunks, stats)
                p = torch.arange(sbase, min(sbase + Rk * nt, P))
                assert (d2[b, p] == -1.0).all()  # no pixel computed twice
                d2[b, p], wn[b, p], am[b, p] = dmin[: len(p)], w_[: len(p)], amin[: len(p)]
    return d2, wn.to(torch.int32), am.to(torch.int32)


def _emulate_grid_flat(flat, meta, P: int, TP: int, threads: int, stats) -> torch.Tensor:
    """``csrc/sdf_grid_flat.cu``: a block of nt threads a (glyph, span
    of 4·nt pixels); the span's live slots of nt pixels decide R."""
    G = meta.shape[0]
    nt, (gx, gy) = legacy.grid_launch_shape(G, P, threads)
    span = nt * sdf_cuda.GRID_PIXELS_PER_THREAD
    assert gx == G and gy * span >= P > (gy - 1) * span
    out = torch.full((G, P), 255, dtype=torch.uint8)  # every byte must be written
    for g in range(G):
        x0, y0, w, h, nseg, off = (int(v) for v in meta[g, :6])
        wh = w * h
        live_end = min(P, -(-wh // TP) * TP) if wh > 0 else 0
        for y in range(gy):
            base = y * span
            live_here = min(live_end, P) - base
            slots = min(-(-live_here // nt), 4) if live_here > 0 else 0
            R = 4 if slots > 2 else slots
            stats[f"R{R}"] += 1
            end = min(base + span, P)
            out[g, base:end] = 0
            if not R:
                continue
            chunks = []
            for c0 in range(off, off + nseg, CHUNK):
                ln = torch.arange(c0, min(c0 + CHUNK, off + nseg))
                chunks.append(tuple(flat[k, ln] for k in range(4)))
                stats["staged"] += len(ln)
            byte = _span_bytes((x0, y0, w, h), base, R * nt, chunks, stats)
            p = torch.arange(base, min(base + R * nt, P))
            out[g, p] = torch.where(p < live_end, byte[: len(p)], 0.0).to(torch.uint8)
    return out


# -- the cases --


def _degenerate_preps():
    segs = np.array([
        [5.0, 5.0, 5.0, 5.0], [5.0, 5.0, 15.0, 5.0], [15.0, 5.0, 15.0, 15.0],
        [15.0, 15.0, 5.0, 15.0], [5.0, 15.0, 5.0, 5.0], [9.5, 9.5, 9.5, 9.5],
    ])
    box = GlyphPrep(codepoint=65, advance=20, empty=False, width=22, height=22,
                    x0=-1, y0=-1, x1=21, y1=21, segments=segs)
    rings = GlyphPrep(codepoint=66, advance=20, empty=False, width=20, height=20,
                      x0=0, y0=0, x1=20, y1=20,
                      rings_px=[np.array([[3.0, 3.0], [12.0, 3.0], [12.0, 12.0], [3.0, 3.0]]),
                                np.array([[6.0, 6.0], [6.0, 6.0], [7.0, 6.0]])])
    return [box, rings]


def _pts_arrays(preps, TP):
    pts, words, meta = tbatch.pack_points(preps, dtype=np.float32, arena_tag="_tredesign")
    T = tbatch.tile_starts(meta, len(preps), TP)[1]
    tmeta = np.ascontiguousarray(tbatch.plan_tiles(preps, meta, TP, T_pad=T)[0].T)
    return np.array(pts), np.array(words), tmeta


def _pts_case(name):
    if name == "unaligned":
        return (*unaligned_point_chain(), 256)
    preps, TP = {
        "curved": (curved_preps(10, 65, seed=5), 256),
        "heavy": (curved_preps(2, 0x600, seed=1, quads=24), 256),
        "degenerate": (_degenerate_preps(), 256),
        "fallbacks": (row_list_edge_preps(), 256),
        "tp64": (curved_preps(4, 65, seed=7), 64),
    }[name]
    return (*_pts_arrays(preps, TP), TP)


def _grid_case(name):
    preps, tp = {
        "curved": (curved_preps(8, 65, seed=3), None),
        "curved_tp256": (curved_preps(8, 65, seed=3), 256),
        "degenerate": (_degenerate_preps(), None),
        "eight_tiles": (curved_preps(4, 65, seed=9) + row_list_edge_preps()[2:], -8),
        "fallbacks": (row_list_edge_preps(), 512),
    }[name]
    flat, meta, P = tbatch.pack_flat(preps)
    tp = P // -tp if tp and tp < 0 else tp  # −n: n tiles a glyph
    return np.array(flat), np.array(meta[: len(preps)]), P, tp or min(1024, P)


def _tiles_case(name):
    """(flat [4, N], tile table [8, T], TP) of the flat tile kernel."""
    preps, TP = {
        "curved": (curved_preps(10, 65, seed=5), 256),
        "heavy": (curved_preps(2, 0x600, seed=1, quads=24), 256),
        "degenerate": (_degenerate_preps(), 256),
        "fallbacks": (row_list_edge_preps(), 256),
        "tp64": (curved_preps(4, 65, seed=7), 64),
        "tp32": (curved_preps(4, 65, seed=7), 32),
    }[name]
    flat, meta, _ = tbatch.pack_flat(preps)
    T = tbatch.tile_starts(meta, len(preps), TP)[1]
    tmeta = np.ascontiguousarray(tbatch.plan_tiles(preps, meta, TP, T_pad=T)[0].T)
    return np.array(flat), tmeta, TP


def _fit_plan_case():
    """The flat backend's plan and point chain of 4 curved glyphs at
    depth 2 from a perturbed start, as `tests/test_torch_fit_ops.py`
    makes them: (plan, pts [2, N])."""
    b = synth_fit_batch(4, 65, seed=1, depth=2, perturb=0.3)
    plan = fitting.build_flat_plan(b.curve_mask, b.meta, 2, b.target.shape[1])
    params = fitting.init_params(b.curves0, device="cpu")
    pts = fitting.flat_chain_points(params["curves"], params["translate"], 2,
                                    torch.as_tensor(plan.chunk_map).long()).detach().numpy()
    return plan, np.ascontiguousarray(pts, np.float32)


def _min_case(name):
    """(pts, mask words, tile table [8, T], TP) of the min-field tile
    kernel."""
    if name == "fit":
        plan, pts = _fit_plan_case()
        return pts, plan.mask_words, np.ascontiguousarray(plan.tmeta.T), plan.TP
    if name == "tied":
        return (*tied_point_chain(), 256)
    return _pts_case(name)


def _bwd_case(name):
    """(segs, meta, am, ct) of the padded backward: the argmin of the
    plain padded min field and a seeded cotangent over every pixel, not
    masked past w·h."""
    segs, mask, meta, P = padded_edge_case("holes" if name == "out_of_range" else name)
    am = sdf_torch.min_field_padded(_t(segs), _t(mask), _t(meta), P)[2]
    if name == "out_of_range":
        am = _t(out_of_range_argmin(am.numpy(), segs.shape[1]))
    ct = np.random.default_rng(len(name)).normal(size=tuple(am.shape)).astype(np.float32)
    return _t(segs), _t(meta), am, _t(ct)


PTS_CASES = ("curved", "heavy", "degenerate", "unaligned", "fallbacks", "tp64")
MIN_CASES = ("fit", "heavy", "degenerate", "unaligned", "fallbacks", "tp64", "tied")
BWD_CASES = PADDED_BWD_EDGE_CASES + ("out_of_range",)
# name -> (threads, warps a glyph, segments a pass) from S and P
BWD_SHAPES = {
    "launcher": lambda S, P: sdf_cuda.padded_bwd_launch_shape(S, P),
    "passes": lambda S, P: (128, 1, max(1, min(S // 3, 64))),
    "warps4": lambda S, P: sdf_cuda.padded_bwd_launch_shape(S, P, 256, 4),
}
TILES_CASES = ("curved", "heavy", "degenerate", "fallbacks", "tp64", "tp32")
GRID_CASES = ("curved", "curved_tp256", "degenerate", "eight_tiles", "fallbacks")
PADDED_CASES = PADDED_EDGE_CASES
# (threads, r) handed to `sdf_cuda.padded_launch_shape`
PADDED_SHAPES = ((128, 3), (256, 4), (256, 3), (64, 4), (32, 4), (64, 3), (96, 2), (256, 1))
assert PADDED_SHAPES[0] == (sdf_cuda.PADDED_THREADS, sdf_cuda.PADDED_PIXELS_PER_THREAD)

_JAX_SIDE = r"""
import sys, numpy as np
from versatiles_glyphs_tpu.ops.sdf_jax import (
    render_bitmaps_flat_jax, render_bitmaps_pts_jax, render_bitmaps_tiles_jax)
a = dict(np.load(sys.argv[1]))
out = {}
for key in a:
    kind, name, part = key.split("|")
    if kind == "pts" and part == "pts":
        words, tmeta, tp, L = (a[f"pts|{name}|{p}"] for p in ("words", "tmeta", "tp", "L"))
        out[f"pts|{name}"] = render_bitmaps_pts_jax(a[key], words, tmeta, int(tp), int(L))
    if kind == "tiles" and part == "flat":
        tmeta, tp, S = (a[f"tiles|{name}|{p}"] for p in ("tmeta", "tp", "S"))
        out[f"tiles|{name}"] = render_bitmaps_tiles_jax(a[key], tmeta, int(tp), int(S))
    if kind == "grid" and part == "flat":
        meta, P, S = (a[f"grid|{name}|{p}"] for p in ("meta", "P", "S"))
        out[f"grid|{name}"] = render_bitmaps_flat_jax(a[key], meta, int(P), int(S))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_twins(tmp_path_factory):
    """The jnp twins' bytes of every case, from one subprocess with
    XLA's FMA contraction off. The twins read a fixed window of lanes
    from each run's start, so the arrays are padded by it."""
    tmp = tmp_path_factory.mktemp("jax_redesign")
    arrays = {}
    for name in PTS_CASES:
        pts, words, tmeta, TP = _pts_case(name)
        L = jbatch.bucket(max(int(tmeta[4].max()), 1), jbatch.S_BUCKETS)
        pad = -(-(int(tmeta[5].max()) + L + 1 - pts.shape[1]) // 32) * 32
        if pad > 0:
            pts = np.pad(pts, ((0, 0), (0, pad)))
            words = np.pad(words, (0, pad // 32))
        arrays |= {f"pts|{name}|pts": pts, f"pts|{name}|words": words,
                   f"pts|{name}|tmeta": np.ascontiguousarray(tmeta.T), f"pts|{name}|tp": TP,
                   f"pts|{name}|L": L}
    for name in TILES_CASES:
        flat, tmeta, TP = _tiles_case(name)
        S = jbatch.bucket(int(tmeta[4].max()), jbatch.S_BUCKETS)
        pad = int((tmeta[5] + S).max()) - flat.shape[1]
        if pad > 0:
            flat = np.pad(flat, ((0, 0), (0, pad)))
        arrays |= {f"tiles|{name}|flat": flat, f"tiles|{name}|tmeta": np.ascontiguousarray(tmeta.T),
                   f"tiles|{name}|tp": TP, f"tiles|{name}|S": S}
    for name in GRID_CASES:
        flat, meta, P, _ = _grid_case(name)
        S = jbatch.bucket(int(meta[:, 4].max()), jbatch.S_BUCKETS)
        pad = int((meta[:, 5] + S).max()) - flat.shape[1]
        if pad > 0:
            flat = np.pad(flat, ((0, 0), (0, pad)))
        arrays |= {f"grid|{name}|flat": flat, f"grid|{name}|meta": meta, f"grid|{name}|P": P,
                   f"grid|{name}|S": S}
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(src), str(dst)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


# -- the tests --


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("case", PTS_CASES)
def test_tile_kernel_decomposition_gives_the_plain_bytes(jax_twins, case, R):
    pts, words, tmeta, TP = _pts_case(case)
    assert R in (1, sdf_cuda.pixels_per_thread(TP))
    stats = dict.fromkeys(("per_pair", "by_row", "empty_chunks"), 0)
    got = _emulate_tiles_pts(_t(pts), words, tmeta, TP, R, stats)
    want = sdf_torch.render_tiles_pts(_t(pts), _t(words), _t(tmeta), TP)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jax_twins[f"pts|{case}"])
    assert int((want > 0).sum()) > 50 and stats["by_row"] > 0
    if case == "heavy":  # a glyph of ~1,000 lanes: several chunks a tile
        assert int(tmeta[4].max()) > 2 * CHUNK
    if case == "unaligned":
        assert int(tmeta[5, 0]) % 32 and stats["empty_chunks"] >= 1  # the all-dead glyph
        assert not want[2:].any() and want[:2].any()
    if case == "fallbacks":
        assert stats["per_pair"] > 0  # too many rows, too many crossings


@pytest.mark.parametrize("case,R", [(c, R) for c in TILES_CASES for R in (1, 2)
                                    if (c, R) != ("tp32", 2)])
def test_flat_tile_kernel_decomposition_gives_the_plain_bytes(jax_twins, case, R):
    flat, tmeta, TP = _tiles_case(case)
    assert R in (1, sdf_cuda.pixels_per_thread(TP))
    stats = dict.fromkeys(("per_pair", "by_row", "chunks"), 0)
    got = _emulate_tiles_flat(_t(flat), tmeta, TP, R, stats)
    want = sdf_torch.render_tiles_flat(_t(flat), _t(tmeta), TP)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jax_twins[f"tiles|{case}"])
    assert int((want > 0).sum()) > 50 and stats["by_row"] > 0
    if case == "heavy":  # a glyph of ~1,000 segments: several chunks a tile
        assert int(tmeta[4].max()) > 2 * CHUNK and stats["chunks"] > 3 * tmeta.shape[1] // 2
    if case == "fallbacks":
        assert stats["per_pair"] > 0  # too many rows, too many crossings
    if case == "tp32":
        assert sdf_cuda.pixels_per_thread(TP) == 1


_JAX_PADDED_SIDE = r"""
import sys, numpy as np, jax.numpy as jnp
from versatiles_glyphs_tpu.ops.sdf_grad import _run_fwd

def up(n, m):
    return max(-(-n // m) * m, m)

a = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({key.split("|")[0] for key in a}):
    segs, mask, meta, P = (a[f"{name}|{p}"] for p in ("segs", "mask", "meta", "P"))
    B, S, _ = segs.shape
    P = int(P)
    Sp, Pp = up(S, 128), up(P, 1024)
    segp = np.pad(segs, ((0, 0), (0, Sp - S), (0, 0)))
    maskp = np.pad(mask, ((0, 0), (0, Sp - S)))
    meta8 = np.zeros((B, 8), np.int32)
    meta8[:, :4] = meta
    d2, wn, am = _run_fwd(jnp.transpose(segp, (0, 2, 1)), maskp[:, None, :], meta8, Pp, Sp, True)
    out |= {f"{name}|d2": np.asarray(d2)[:, :P], f"{name}|wn": np.asarray(wn)[:, :P],
            f"{name}|am": np.asarray(am)[:, :P]}
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_padded_fwd(tmp_path_factory):
    """The JAX package's padded forward `_run_fwd` (Pallas interpret
    mode, with the TPU's paddings of S to 128 and P to 1,024 cut off
    again) on every padded case, from one subprocess with XLA's FMA
    contraction off, as `tests/test_torch_padded.py` runs it."""
    tmp = tmp_path_factory.mktemp("jax_padded_redesign")
    arrays = {}
    for name in PADDED_CASES:
        segs, mask, meta, P = padded_edge_case(name)
        arrays |= {f"{name}|segs": segs, f"{name}|mask": mask, f"{name}|meta": meta, f"{name}|P": P}
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_PADDED_SIDE, str(src), str(dst)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("shape", PADDED_SHAPES, ids=lambda s: f"t{s[0]}r{s[1]}")
@pytest.mark.parametrize("case", PADDED_CASES)
def test_padded_min_field_decomposition_gives_the_plain_fields(jax_padded_fwd, case, shape):
    segs, mask, meta, P = padded_edge_case(case)
    keys = ("per_pair", "by_row", "staged", "empty_chunks", "slots1", "slots2", "slots3", "slots4")
    stats = dict.fromkeys(keys, 0)
    got = _emulate_min_field_padded(_t(segs), _t(mask), meta, P, *shape, stats)
    want = sdf_torch.min_field_padded(_t(segs), _t(mask), _t(meta), P)
    for g, w, name in zip(got, want, ("d2", "wn", "am")):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      jax_padded_fwd[f"{case}|{name}"].view(np.int32))
    d2, wn, am = (t.numpy() for t in got)
    B, S = mask.shape
    nt, R, gy = sdf_cuda.padded_launch_shape(P, *shape)
    assert (wn != 0).any() and (wn == 0).any()
    live = am != sdf_torch._BIGI
    assert (mask[np.nonzero(live)[0], am[live]] != 0).all()  # an index into [B, S], and a live one
    if gy == 1 and R * nt >= P and stats[f"slots{R}"] == B:  # one span a glyph: staged once
        assert stats["staged"] == int((mask != 0).sum())
    if case == "holes":  # P = 437: a last span of 1, 2 or 3 live slots, or a full one
        short = {(128, 3): "slots2", (64, 4): "slots3", (32, 4): "slots2", (64, 3): "slots1",
                 (96, 2): "slots1"}
        assert P % nt and stats[f"slots{R}"] == B * (gy - (shape in short))
        assert shape not in short or stats[short[shape]] == B
        first_hole = int(np.argmin(mask[0]))
        assert (am[0] > first_hole).any() and mask[0, first_hole + 1:].any()
    if case == "narrow":  # a bitmap 5 pixels wide
        assert gy * R * nt == P
        if R * nt // 5 > ROWS_MAX:  # the rows fallback, at the launcher's own shape too
            assert shape in ((128, 3), (256, 4), (256, 3))
            assert stats["per_pair"] > 0 and not stats["by_row"]
        else:
            assert stats["by_row"] > 0
    if case == "comb":
        assert stats["per_pair"] > 0 and stats["by_row"] > 0
    if case == "chunks":  # the tie of segments 3 and 260 goes to 3; both chunks staged
        assert S > CHUNK and (am[1] == 3).any() and not (am[1] == 260).any()
        assert (am[0] >= CHUNK).any() and (am[0] < CHUNK).any()
    if case == "degenerate":  # the all-masked glyph keeps the sentinel and 3e38
        assert not live[2].any() and (d2[2] == np.float32(sdf_torch._BIG)).all()
        assert live[:2].all() and stats["empty_chunks"] > 0


@pytest.mark.parametrize("threads", [256, 128, 32])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_kernel_decomposition_gives_the_plain_bytes(jax_twins, case, threads):
    flat, meta, P, TP = _grid_case(case)
    stats = dict.fromkeys(("per_pair", "by_row", "staged", "R0", "R1", "R2", "R4"), 0)
    got = _emulate_grid_flat(_t(flat), meta, P, TP, threads, stats)
    want = sdf_torch.render_grid_flat(_t(flat), _t(meta), P, TP)
    assert torch.equal(got, want)
    # The jnp twin computes every tile; the kernels zero those at or past w·h.
    live = (np.arange(P) // TP * TP)[None, :] < (meta[:, 2] * meta[:, 3])[:, None]
    np.testing.assert_array_equal(got.numpy()[live], jax_twins[f"grid|{case}"][: len(meta)][live])
    assert not got.numpy()[~live].any() and int((want > 0).sum()) > 50
    nt, (_, gy) = legacy.grid_launch_shape(len(meta), P, threads)
    if gy == 1:  # one block a glyph: its soup is staged once
        assert stats["staged"] == int(meta[:, 4].sum())
    if case == "eight_tiles":
        assert P // TP == 8 and int((meta[:, 2] * meta[:, 3]).min()) < TP
        assert stats["R1"] + stats["R2"] > 0 and (gy == 1 or stats["R0"] > 0)
    if case == "fallbacks":
        assert stats["per_pair"] > 0 and stats["by_row"] > 0


_JAX_FITTING_SIDE = r"""
import sys, numpy as np, jax.numpy as jnp
from versatiles_glyphs_tpu.ops.sdf_pallas import min_field_pallas_pts
from versatiles_glyphs_tpu.ops.sdf_grad import _run_bwd, _run_fwd

def up(n, m):
    return max(-(-n // m) * m, m)

a = dict(np.load(sys.argv[1]))
d2, wn, am = min_field_pallas_pts(a["pts"], a["words"], a["tmeta"], 256, interpret=True)
out = {"min_d2": np.asarray(d2), "min_wn": np.asarray(wn), "min_am": np.asarray(am)}
segs, mask, meta, ct = a["segs"], a["mask"], a["meta"], a["ct"]
B, S, _ = segs.shape
P = ct.shape[1]
Sp, Pp = up(S, 128), up(P, 1024)
segp = np.pad(segs, ((0, 0), (0, Sp - S), (0, 0)))
maskp = np.pad(mask, ((0, 0), (0, Sp - S)))
meta8 = np.zeros((B, 8), np.int32)
meta8[:, :4] = meta
_, _, am = _run_fwd(jnp.transpose(segp, (0, 2, 1)), maskp[:, None, :], meta8, Pp, Sp, True)
gd = np.zeros((B, Pp), np.float32)
gd[:, :P] = ct
dsegt = _run_bwd(np.pad(segp, ((0, 0), (0, 0), (0, 124))), meta8, am, gd, Pp, Sp, True)
out |= {"bwd_am": np.asarray(am)[:, :P], "bwd_dsegs": np.asarray(dsegt)[:, :S, :4]}
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_fitting_kernels(tmp_path_factory):
    """The JAX package's flat min field (`min_field_pallas_pts`, Pallas
    interpret mode, as `tests/test_torch_fit_ops.py` runs it) on the
    ``fit`` case and its padded backward (`_run_bwd` on `_run_fwd`'s
    argmin, as `tests/test_torch_padded.py` runs them) on the ``holes``
    case, from one subprocess with XLA's FMA contraction off."""
    tmp = tmp_path_factory.mktemp("jax_fitting_redesign")
    plan, pts = _fit_plan_case()
    segs, mask, meta, _ = padded_edge_case("holes")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, pts=pts, words=plan.mask_words, tmeta=np.ascontiguousarray(plan.tmeta.T),
             segs=segs, mask=mask,
             meta=meta, ct=_bwd_case("holes")[3].numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               VG_JAX_CACHE_DIR=str(tmp / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", _JAX_FITTING_SIDE, str(src), str(dst)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("case,R", [(c, R) for c in MIN_CASES for R in (1, 2, 4)
                                    if (c, R) != ("tp64", 4)])
def test_min_field_tile_kernel_decomposition_gives_the_plain_fields(jax_fitting_kernels, case, R):
    pts, words, tmeta, TP = _min_case(case)
    assert R <= sdf_cuda.min_field_pixels_per_thread(TP) == (4 if TP == 256 else 2)
    stats = dict.fromkeys(("per_pair", "by_row", "empty_chunks", "chunks"), 0)
    got = _emulate_min_field_pts(_t(pts), words, tmeta, TP, R, stats)
    want = sdf_torch.min_field_pts(_t(pts), _t(words), _t(tmeta), TP)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))
    d2, wn, am = (t.numpy() for t in got)
    live_row = tmeta[6] < tmeta[2] * tmeta[3]
    found = am[live_row] != sdf_torch._BIGI
    assert found.any() and stats["by_row"] > 0
    # The argmin is a global lane of its row's run, and a live one.
    lanes = am[live_row][found]
    off = np.broadcast_to(tmeta[5][live_row, None], am[live_row].shape)[found]
    npts = np.broadcast_to(tmeta[4][live_row, None], am[live_row].shape)[found]
    assert (lanes >= off).all() and (lanes < off + npts - 1).all()
    assert ((words[lanes >> 5] >> (lanes & 31)) & 1).all()
    if case == "fit":  # the Pallas kernel, over the same plan
        for g, name in zip(got, ("d2", "wn", "am")):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          jax_fitting_kernels[f"min_{name}"].view(np.int32))
    if case == "heavy":  # ~1,000 lanes a glyph: the argmin crosses chunks
        assert stats["chunks"] > 2 and (lanes - off >= 2 * CHUNK).any()
    if case == "unaligned":
        assert int(tmeta[5, 0]) % 32 and stats["empty_chunks"] >= 1
        # The all-dead glyph and the rows of npts <= 1 keep the sentinel;
        # the row past w*h is zeros.
        assert (am[2:5] == sdf_torch._BIGI).all() and (d2[2:5] == np.float32(sdf_torch._BIG)).all()
        assert not am[5].any() and not d2[5].any() and not wn[5].any()
        assert set(np.unique(am[:2])) <= set(range(37, 56)) | set(range(57, 86))
    if case == "fallbacks":
        assert stats["per_pair"] > 0  # too many rows, too many crossings
    if case == "tied":  # lanes 8 and 308 are one segment, in two staged chunks
        assert stats["chunks"] == 2 and (am == 8).any() and not (am == 308).any()
        assert (am == 403).any()


@pytest.mark.parametrize("shape", list(BWD_SHAPES))
@pytest.mark.parametrize("case", BWD_CASES)
def test_padded_backward_routing_gives_the_pixel_order_sums(jax_fitting_kernels, case, shape):
    segs, meta, am, ct = _bwd_case(case)
    B, S = segs.shape[:2]
    P = am.shape[1]
    threads, wpg, s_chunk = launch = BWD_SHAPES[shape](S, P)
    assert 16 * s_chunk * threads // 32 <= sdf_cuda.PADDED_BWD_SMEM and (threads // 32) % wpg == 0
    stats = dict.fromkeys(("most", "steps", "passes"), 0)
    got = _emulate_padded_bwd(segs, meta, am, ct, launch, stats)
    twin = sdf_torch.min_field_padded_bwd(segs, meta, am, ct).numpy()
    ordered = sdf_torch.min_field_padded_bwd_ordered(segs, meta, am, ct).numpy()
    scale = np.abs(twin).max()
    assert scale > 0
    np.testing.assert_allclose(got, twin, rtol=0, atol=1e-4 * scale)
    if wpg == 1:  # one warp a glyph: every sum in pixel order
        np.testing.assert_array_equal(got.view(np.int32), ordered.view(np.int32))
    assert stats["passes"] == B * -(-S // s_chunk)
    if shape == "launcher":
        assert (wpg, s_chunk) == ((2 if case == "large" else 1), S)
        assert stats["steps"] == B * wpg * -(-(-(-P // wpg)) // 32)
    if shape == "passes":
        assert s_chunk < S and stats["passes"] >= 3 * B
    if shape == "warps4":
        assert wpg == 4
    # A segment no pixel chose, and every segment of a glyph without a
    # live one, gets zeros.
    chosen = np.zeros((B, S), bool)
    ok = (am.numpy() >= 0) & (am.numpy() < S)
    chosen[np.nonzero(ok)[0], am.numpy()[ok]] = True
    assert not got[~chosen].any() and (~chosen).any()
    if case == "holes" and wpg == 1:  # the Pallas kernel, on its own argmin
        np.testing.assert_array_equal(am.numpy(), jax_fitting_kernels["bwd_am"])
        np.testing.assert_allclose(got, jax_fitting_kernels["bwd_dsegs"], rtol=0, atol=1e-4 * scale)
    if case == "one_wins":  # a step's 32 lanes are one set
        assert stats["most"] == 32 and (np.count_nonzero(chosen[0]), chosen[0, 5]) == (1, True)
    if case == "degenerate":
        assert not ok[2].any() and not got[2].any()
    if case == "out_of_range":
        assert (~ok).mean() > 0.05 and (am.numpy()[~ok] < 0).any() and (am.numpy()[~ok] >= S).any()
    if case == "large":
        assert P > sdf_cuda.PADDED_BWD_WARP_PIXELS


def test_pixel_order_sums_are_a_sequential_loop():
    """`sdf_torch.min_field_padded_bwd_ordered` against a loop over the
    glyphs, the pixels and the four terms, one f32 addition at a time."""
    segs, meta, am, ct = _bwd_case("out_of_range")
    B, S = segs.shape[:2]
    terms = sdf_torch._padded_bwd_terms(segs, meta, am, ct)[2].numpy()
    want = np.zeros((B, S, 4), np.float32)
    for b in range(B):
        for p in range(am.shape[1]):
            s = int(am[b, p])
            if 0 <= s < S:
                for k in range(4):
                    want[b, s, k] = want[b, s, k] + terms[b, p, k]
    got = sdf_torch.min_field_padded_bwd_ordered(segs, meta, am, ct).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.abs(want).max() > 0


def test_launch_helpers():
    # A block is whole warps: two pixels a thread only at multiples of 64.
    assert [sdf_cuda.pixels_per_thread(tp) for tp in (32, 64, 96, 128, 256, 1024)] == [1, 2, 1, 2, 2, 2]
    assert legacy.grid_launch_shape(7, 1024) == (128, (7, 2))
    assert legacy.grid_launch_shape(7, 1024, 256) == (256, (7, 1))
    assert legacy.grid_launch_shape(7, 64) == (32, (7, 1))
    assert legacy.grid_launch_shape(7, 5120, 256) == (256, (7, 5))
    assert legacy.grid_launch_shape(7, 1056, 256) == (256, (7, 2))
    for bad in (0, 48, 512):
        with pytest.raises(ValueError, match="threads"):
            legacy.grid_launch_shape(7, 1024, bad)
    # The padded min field: (threads a block, pixels a thread, blocks a
    # glyph); the spans of a glyph are sized evenly and cover P.
    assert sdf_cuda.padded_launch_shape(768) == (128, 3, 2)
    assert sdf_cuda.padded_launch_shape(768, 256, 4) == (192, 4, 1)
    assert sdf_cuda.padded_launch_shape(768, 128, 4) == (96, 4, 2)
    assert sdf_cuda.padded_launch_shape(768, 256, 1) == (256, 1, 3)
    assert sdf_cuda.padded_launch_shape(1280, 256, 4) == (160, 4, 2)
    assert sdf_cuda.padded_launch_shape(129, 256, 4) == (64, 3, 1)
    assert sdf_cuda.padded_launch_shape(1, 256, 4) == (32, 1, 1)
    for P in (1, 31, 33, 300, 437, 768, 1025, 5000, sdf_cuda.MAX_PADDED_PIXELS):
        for threads, r in PADDED_SHAPES:
            nt, R, gy = sdf_cuda.padded_launch_shape(P, threads, r)
            assert nt % 32 == 0 and 32 <= nt <= threads and 1 <= R <= r
            assert gy * nt * R >= P > (gy - 1) * nt * R
    assert sdf_cuda.padded_launch_shape(sdf_cuda.MAX_PADDED_PIXELS)[2] <= 65535  # a grid's y limit
    for bad in ((0, 4), (48, 4), (512, 4), (256, 0), (256, 5)):
        with pytest.raises(ValueError, match="threads|r="):
            sdf_cuda.padded_launch_shape(768, *bad)
    # The flat min field: four pixels a thread where that leaves whole warps.
    assert [sdf_cuda.min_field_pixels_per_thread(tp) for tp in (32, 64, 96, 128, 256, 1024)] == [
        1, 2, 1, 4, 4, 4]
    assert sdf_cuda.min_field_pixels_per_thread(256, 2) == 2
    with pytest.raises(ValueError, match="r=3"):
        sdf_cuda.min_field_pixels_per_thread(256, 3)
    # The padded backward: (threads a block, warps a glyph, segments a
    # pass); one warp a glyph up to PADDED_BWD_WARP_PIXELS pixels, and
    # the accumulators of a block's warps within PADDED_BWD_SMEM.
    assert sdf_cuda.padded_bwd_launch_shape(128, 768) == (128, 1, 128)
    assert sdf_cuda.padded_bwd_launch_shape(352, 768) == (128, 1, 352)
    assert sdf_cuda.padded_bwd_launch_shape(128, 2048) == (128, 1, 128)
    assert sdf_cuda.padded_bwd_launch_shape(128, 2049) == (128, 2, 128)
    assert sdf_cuda.padded_bwd_launch_shape(128, sdf_cuda.MAX_PADDED_PIXELS) == (128, 4, 128)
    assert sdf_cuda.padded_bwd_launch_shape(5000, 768) == (128, 1, 768)
    assert sdf_cuda.padded_bwd_launch_shape(5000, 768, 1024, 8) == (1024, 8, 96)
    assert sdf_cuda.padded_bwd_launch_shape(1, 0) == (128, 1, 1)
    for S in (1, 8, 352, 769, 100000):
        for threads in (32, 128, 256, 1024):
            t, w, c = sdf_cuda.padded_bwd_launch_shape(S, 768, threads)
            assert (t, w) == (threads, 1) and 1 <= c <= S
            assert 16 * c * threads // 32 <= sdf_cuda.PADDED_BWD_SMEM
    for bad in ({"threads": 0}, {"threads": 48}, {"threads": 2048}, {"warps": 3}, {"warps": 0}):
        with pytest.raises(ValueError, match="threads|warps"):
            sdf_cuda.padded_bwd_launch_shape(128, 768, **bad)


def test_sizes_are_the_sources():
    """The launchers' constants against ``csrc/sdf_pair.cuh``,
    ``csrc/sdf_grid_flat.cu``, ``csrc/sdf_min_field_padded.cu``,
    ``csrc/sdf_min_field_pts.cu`` and ``csrc/sdf_min_field_padded_bwd.cu``."""
    csrc = os.path.join(os.path.dirname(pkg.__file__), "csrc")
    with open(os.path.join(csrc, "sdf_pair.cuh")) as f:
        header = f.read()
    with open(os.path.join(csrc, "sdf_grid_flat.cu")) as f:
        grid = f.read()
    with open(os.path.join(csrc, "sdf_min_field_padded.cu")) as f:
        padded = f.read()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const(header, "kRecChunk") == sdf_cuda.REC_CHUNK
    assert const(header, "kRowsMax") == sdf_cuda.ROWS_MAX
    assert const(header, "kRowCross") == sdf_cuda.ROW_CROSS
    assert const(grid, "kMaxR") == sdf_cuda.GRID_PIXELS_PER_THREAD
    assert int(re.search(r"__launch_bounds__\((\d+), 2\) sdf_grid_flat_kernel", grid)[1]) == sdf_cuda.GRID_THREADS_MAX
    assert const(padded, "kMaxR") == sdf_cuda.PADDED_PIXELS_PER_THREAD_MAX >= sdf_cuda.PADDED_PIXELS_PER_THREAD
    assert const(padded, "kMaxThreads") == sdf_cuda.PADDED_THREADS_MAX >= sdf_cuda.PADDED_THREADS
    assert "__launch_bounds__(kMaxThreads) sdf_min_field_padded_kernel" in padded
    # Both tile kernels are compiled for the launcher's pixels a thread.
    for name in ("sdf_tiles_pts", "sdf_tiles_flat"):
        with open(os.path.join(csrc, name + ".cu")) as f:
            text = f.read()
        assert f"launch_r<{sdf_cuda.TILE_PIXELS_PER_THREAD}>" in text and "vg::render_tile<R>(" in text
    # The render tile is the shared tile body keeping no argmin; the flat
    # min field is the same body with one, compiled for the launcher's
    # pixels a thread.
    assert "tile_body<R, Pixels<R>>(staging" in header
    with open(os.path.join(csrc, "sdf_min_field_pts.cu")) as f:
        text = f.read()
    assert f"launch_r<{sdf_cuda.MIN_FIELD_PIXELS_PER_THREAD}>" in text
    assert "vg::tile_body<R, vg::MinPixels<R>>(vg::ChainStaging{" in text
    assert "pts[n_lanes + lane + 1], lane);" in header  # stage_live carries the lane
    with open(os.path.join(csrc, "sdf_min_field_padded_bwd.cu")) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kSmemMax = (\d+) \* 1024;", text)[1]) * 1024 == sdf_cuda.PADDED_BWD_SMEM
    assert "vg::match_keys(" in text and "vg::add_in_lane_order(" in text and "atomic" not in text.split("#include")[1]


def test_row_shared_pair_ops_are_counted_from_the_source():
    """`work.ROW_SHARED_PAIR_F32_OPS` against the f32 operators of
    `SegRecords::pair` outside its winding block, counted from the text
    as `test_pair_ops_are_counted_from_the_source` counts the 22; the
    crossing's operations against `list_crossings` and the row's sum in
    `reduce`."""
    with open(os.path.join(os.path.dirname(pkg.__file__), "csrc", "sdf_pair.cuh")) as f:
        src = f.read()

    def count(text):
        text = re.sub(r"//[^\n]*", "", text)
        return (len(re.findall(r"(?<=[\w\)\]]) [*+-] (?=[\w\(])", text))
                + len(re.findall(r"\bfm(?:in|ax)f\(", text)) + len(re.findall(r"<=", text)))

    proj = src[src.index("void project("):]
    proj = proj[proj.index("{"): proj.index("}") + 1]
    pair = src[src.index("void pair(int j, Px& px)"):]
    pair = pair[pair.index("const float ex"): pair.index("// The first n staged segments")]
    winding = pair[pair.index("if (kWinding) {"): pair.index("const float d2 =")]
    loop = pair.replace(winding, "").replace("project(ex, ey, a.z, a.w, b.x, tc, qx, qy);", "")
    assert count(proj) == 10
    assert count(loop) + count(proj) == work.ROW_SHARED_PAIR_F32_OPS == 16
    # The winding block holds the other six, the integer step apart.
    assert count(winding.replace("px.wn[k] += c1 ? 1 : -1", "")) == 6 == work.PAIR_F32_OPS - 16
    # A (row, segment): the test's two compares; a crossing: ey and cx.
    lister = src[src.index("void list_crossings("):]
    lister = lister[lister.index("const bool c1"): lister.index("rows.step[")]
    test, crossing = lister.split("continue;")
    assert count(test) == work.ROW_TEST_F32_OPS == 2
    assert count(crossing.replace("q * kRowCross + slot", "")) == work.CROSSING_F32_OPS == 4
    summed = src[src.index("for (int c = 0; c < cnt; ++c)"):]
    summed = summed[: summed.index("px.wn[k] +=")].replace("q * kRowCross + c", "")
    assert count(summed) == work.CROSSING_PIXEL_F32_OPS == 1


def _brute_row_work(coords, tmeta, TP, words):
    """Row tests, crossings and crossing-pixel compares of a launch, one
    glyph, segment and bitmap row at a time, in the kernels' f32."""
    tm = tmeta.astype(np.int64)
    bits = None if words is None else np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little")
    tests = crossings = compares = 0
    for t0 in np.flatnonzero(tm[6] == 0):
        _, y0, w, h, n, off = tm[:6, t0]
        k = 0
        while t0 + k < tm.shape[1] and (k == 0 or tm[6, t0 + k]) and tm[6, t0 + k] < w * h:
            k += 1
        in_row = np.bincount(np.arange(k * TP) // max(w, 1)) if k else []
        for lane in range(off, off + (n if words is None else max(n - 1, 0)) * bool(k)):
            if bits is not None and not bits[lane]:
                continue
            vy, wy = coords[1, lane], (coords[3, lane] if words is None else coords[1, lane + 1])
            for q, cnt in enumerate(in_row):
                yc = np.float32(y0) + np.float32(h - 1 - q) + np.float32(0.5)
                tests += 1
                if (vy <= yc) != (wy <= yc):
                    crossings += 1
                    compares += int(cnt)
    return tests, crossings, compares


@pytest.mark.parametrize("case", ["pts|curved", "pts|degenerate", "pts|unaligned", "pts|tp64",
                                  "min|curved", "grid|curved", "grid|curved_tp256", "grid|eight_tiles"])
def test_row_shared_work_against_brute_force(case):
    """`work.row_shared_work`, the count behind the render and min-field
    rows' bounds: the pairs and bytes of `tile_kernel_work`, and the row
    tests, crossings and their pixel compares counted one at a time."""
    kind, name = case.split("|")
    out = {"out_bytes_per_pixel": 12, "pixel_ops": 0} if kind == "min" else {}
    if kind in ("pts", "min"):
        coords, words, tmeta, TP = _pts_case(name)
    else:
        coords, meta, P, TP = _grid_case(name)
        words, tmeta = None, sdf_torch.grid_tmeta(_t(meta), P, TP).numpy()
    w = work.row_shared_work(coords, tmeta, TP, words, **out)
    old = work.tile_kernel_work(tmeta, words, TP, coords.shape[1], lane_rows=coords.shape[0], **out)
    assert {k: w[k] for k in ("tiles", "pairs", "pixels", "bytes")} == {
        k: old[k] for k in ("tiles", "pairs", "pixels", "bytes")}
    assert w["f32_ops_per_pair_test"] == old["f32_ops"] and w["pairs"] > 0
    assert (w["row_tests"], w["crossings"], w["crossing_pixels"]) == _brute_row_work(
        coords, tmeta, TP, words)
    assert w["crossings"] > 0
    assert w["f32_ops"] == (16 * w["pairs"] + 2 * w["row_tests"] + 4 * w["crossings"]
                            + w["crossing_pixels"] + out.get("pixel_ops", 8) * w["pixels"]) < old["f32_ops"]


def test_ptxas_report_parses_a_log(tmp_path):
    so = tmp_path / "k.so"
    (tmp_path / "k.so.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aILi4EEvPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi4EEvPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1b' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1b\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 380 bytes cmem[0]\n")
    assert _build.ptxas_report(str(so)) == [
        {"kernel": "_Z1aILi4EEvPKf", "registers": 40, "spill_stores": 0, "spill_loads": 0, "smem": 8192},
        {"kernel": "_Z1b", "registers": 255, "spill_stores": 8, "spill_loads": 12, "smem": 0},
    ]


def test_kernel_turns_variants_and_no_card(monkeypatch, capsys):
    assert kernel_turns.parse_variant("shipped") == {
        "label": "shipped", "r": None, "threads": None, "warps": None}
    assert kernel_turns.parse_variant("r2,r=2")["r"] == 2
    assert kernel_turns.parse_variant("t,threads=128")["threads"] == 128
    assert kernel_turns.parse_variant("a,threads=256,r=4") == {
        "label": "a", "r": 4, "threads": 256, "warps": None}
    assert kernel_turns.parse_variant("w,warps=2,threads=64") == {
        "label": "w", "r": None, "threads": 64, "warps": 2}
    assert kernel_turns.KERNELS == {
        "sdf_tiles_pts": ("r",), "sdf_grid_flat": ("threads",), "sdf_tiles_flat": ("r",),
        "sdf_min_field_padded": ("threads", "r"), "sdf_min_field_pts": ("r",),
        "sdf_min_field_padded_bwd": ("threads", "warps")}
    assert set(kernel_turns.KERNELS) <= set(sdf_cuda.KERNELS)
    for bad in ("x,r=two", "x,r", ",r=2", "x,speed=9", "x,warps=", "x,warps=-1"):
        with pytest.raises(ValueError):
            kernel_turns.parse_variant(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf_cuda.reset_launches()
    for kernel in kernel_turns.KERNELS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernel_turns.main(["--kernel", kernel])
    # An option the kernel does not take is refused before anything runs.
    for kernel, variant in (("sdf_tiles_flat", "t,threads=64"), ("sdf_grid_flat", "r,r=2"),
                            ("sdf_min_field_pts", "t,threads=64"), ("sdf_min_field_pts", "w,warps=2"),
                            ("sdf_min_field_padded_bwd", "r,r=2"), ("sdf_tiles_pts", "w,warps=2")):
        with pytest.raises(ValueError, match="takes no"):
            kernel_turns.main(["--kernel", kernel, "--variant", variant])
    assert capsys.readouterr().out == "" and not any(sdf_cuda.LAUNCHES.values())
    # Outputs are held element for element, floats by their bits.
    a = (torch.tensor([0.0, 1.0]), torch.tensor([1, 2], dtype=torch.int32))
    b = (torch.tensor([-0.0, 1.0]), torch.tensor([1, 3], dtype=torch.int32))
    assert kernel_turns.values_differ(a, a) == 0 and kernel_turns.values_differ(a, b) == 2
    with pytest.raises(AssertionError):
        kernel_turns.values_differ(a, a[:1])


def test_parameters_default_to_the_card():
    """`params_from_numpy` and `init_params` place the parameters on the
    card unless the caller names a device, and raise where there is
    none."""
    curves = np.zeros((2, 3, 4, 2), np.float32)
    params = {"curves": curves, "translate": np.zeros((2, 2), np.float32),
              "log_gain": np.zeros((), np.float32)}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fitting.params_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fitting.init_params(curves)
    assert fitting.init_params(curves, device="cpu")["curves"].device.type == "cpu"
    got = fitting.params_from_numpy(params, device="cpu")
    assert all(t.device.type == "cpu" and t.requires_grad for t in got.values())
