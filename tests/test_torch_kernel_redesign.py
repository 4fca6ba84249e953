"""The decomposition of the redesigned kernels, on the CPU.

``csrc/sdf_tiles_pts.cu`` (TPU kernel 1), ``csrc/sdf_tiles_flat.cu``
(TPU kernel 6), ``csrc/sdf_grid_flat.cu`` (TPU kernel 7) and
``csrc/sdf_min_field_padded.cu`` (TPU kernel 4) compute their plain
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

Tolerance: 0 bytes, 0 bits.
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
    PADDED_EDGE_CASES, curved_preps, padded_edge_case, row_list_edge_preps, unaligned_point_chain,
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


PTS_CASES = ("curved", "heavy", "degenerate", "unaligned", "fallbacks", "tp64")
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


def test_sizes_are_the_sources():
    """The launchers' constants against ``csrc/sdf_pair.cuh``,
    ``csrc/sdf_grid_flat.cu`` and ``csrc/sdf_min_field_padded.cu``."""
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
    assert kernel_turns.parse_variant("shipped") == {"label": "shipped", "r": None, "threads": None}
    assert kernel_turns.parse_variant("r2,r=2")["r"] == 2
    assert kernel_turns.parse_variant("t,threads=128")["threads"] == 128
    assert kernel_turns.parse_variant("a,threads=256,r=4") == {"label": "a", "r": 4, "threads": 256}
    assert kernel_turns.KERNELS == {
        "sdf_tiles_pts": ("r",), "sdf_grid_flat": ("threads",), "sdf_tiles_flat": ("r",),
        "sdf_min_field_padded": ("threads", "r")}
    assert set(kernel_turns.KERNELS) <= set(sdf_cuda.KERNELS)
    for bad in ("x,r=two", "x,r", ",r=2", "x,speed=9"):
        with pytest.raises(ValueError):
            kernel_turns.parse_variant(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf_cuda.reset_launches()
    for kernel in kernel_turns.KERNELS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernel_turns.main(["--kernel", kernel])
    # An option the kernel does not take is refused before anything runs.
    for kernel, variant in (("sdf_tiles_flat", "t,threads=64"), ("sdf_grid_flat", "r,r=2")):
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
