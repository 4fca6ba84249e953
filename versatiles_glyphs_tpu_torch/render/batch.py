"""Glyph-group packing: host geometry → the device wire arrays.

Copies of the packers of `versatiles_glyphs_tpu.render.batch`, which
imports `ops.sdf_jax` at its top. They return the same arrays, array
for array, including the lane slack (`WINDOW_LANES`) and the shape
buckets, so the wire that crosses between the two packages is one
format. Their arena buffers have keys of their own (``torch_`` prefix),
so the two packages never hand out one buffer to each other.
`pack_segments` and `pack_block` pack the padded per-glyph layout of
the ``padded`` backend (the JAX ``jax`` renderer's).

`wire_to_device` turns a pack tuple into tensors on an explicit device
with blocking copies; the render session makes them on a `DeviceLane`'s
upload stream and fetches its outputs asynchronously on its fetch
stream.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.sdf_torch import DX, DY, DYINV, L2INV, VX, VY, WY
from ..utils.arena import get_array

SC = 128  # lanes of one chunk row of the TPU kernel's layout
# The TPU kernel's historical window slack (`sdf_pallas.WINDOW_LANES`);
# kept so that N_pad matches the JAX packers exactly.
WINDOW_LANES = 12 * SC

S_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
P_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
N_BUCKETS = tuple([16384, 32768] + [65536 * k for k in range(1, 65)])
T_BUCKETS = (256, 1024, 4096, 8192, 12288)
K_BUCKETS = (1024, 4096, 8192, 16384, 24576, 32768, 49152, 65536, 131072)


def bucket(value: int, buckets) -> int:
    """Smallest bucket ≥ value; past the largest, round up to its
    multiple."""
    for b in buckets:
        if value <= b:
            return b
    step = buckets[-1]
    return ((value + step - 1) // step) * step


def pack_segments(seg_list: list[np.ndarray], S_pad: int | None = None) -> np.ndarray:
    """Pack per-glyph (S_i, 4) float64 segment soups into the padded
    [G, 8, S_pad] float32 component layout of `ops.sdf_torch.
    render_bitmaps_padded` (rows `VX` … `WY`). The differences and the
    two reciprocals are taken in f64 and then rounded to f32, as the JAX
    packer does, so the rows are its rows bit for bit."""
    G = len(seg_list)
    max_s = max((s.shape[0] for s in seg_list), default=0)
    if S_pad is None:
        S_pad = bucket(max(max_s, 1), S_BUCKETS)
    out = np.zeros((G, 8, S_pad), dtype=np.float32)
    for g, segs in enumerate(seg_list):
        n = segs.shape[0]
        if n == 0:
            continue
        vx = segs[:, 0]
        vy = segs[:, 1]
        wx = segs[:, 2]
        wy = segs[:, 3]
        dx = wx - vx
        dy = wy - vy
        l2 = dx * dx + dy * dy
        with np.errstate(divide="ignore"):
            l2inv = np.where(l2 > 0.0, 1.0 / l2, 0.0)
            dyinv = np.where(dy != 0.0, 1.0 / dy, 0.0)
        out[g, VX, :n] = vx
        out[g, VY, :n] = vy
        out[g, DX, :n] = dx
        out[g, DY, :n] = dy
        out[g, L2INV, :n] = l2inv
        out[g, DYINV, :n] = dyinv
        out[g, WY, :n] = wy
    return out


def pack_block(preps, P_pad: int | None = None, S_pad: int | None = None):
    """Pack non-empty `GlyphPrep`s into the padded layout: (segs [G, 8,
    S_pad] f32 from `pack_segments`, meta [G, 8] i32 rows x0, y0, w, h,
    nseg, 0, 0, 0, P_pad the pixel bucket of the largest bitmap)."""
    G = len(preps)
    segs = pack_segments([p.segments for p in preps], S_pad=S_pad)
    max_p = max((p.width * p.height for p in preps), default=0)
    if P_pad is None:
        P_pad = bucket(max(max_p, 1), P_BUCKETS)
    meta = np.zeros((G, 8), dtype=np.int32)
    for g, p in enumerate(preps):
        meta[g, :5] = (p.x0, p.y0, p.width, p.height, p.segments.shape[0])
    return segs, meta, P_pad


def _group_meta(preps):
    G = len(preps)
    meta = np.zeros((max(G, 1), 8), dtype=np.int32)
    npts = np.asarray([p.npts for p in preps] + [0] * (not G), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(npts)[:-1]])
    if G:
        meta[:G, 0] = [p.x0 for p in preps]
        meta[:G, 1] = [p.y0 for p in preps]
        meta[:G, 2] = [p.width for p in preps]
        meta[:G, 3] = [p.height for p in preps]
        meta[:G, 4] = npts[:G]
        meta[:G, 5] = offs[:G]
    return meta, npts, offs


def _n_pad(npts: np.ndarray) -> int:
    N = int(npts.sum())
    s_slack = bucket(int(npts.max(initial=1)) + WINDOW_LANES + 256, S_BUCKETS)
    return bucket(max(N + s_slack, SC), N_BUCKETS)


def _mask_words(preps, N: int, N_pad: int, arena_tag: str) -> np.ndarray:
    valid = get_array(f"torch_pack_valid{arena_tag}", (N_pad,), np.uint8)
    valid[N:] = 0
    if preps and N:
        np.concatenate([p.valid8 for p in preps], out=valid[:N])
    return np.packbits(valid, bitorder="little").view("<u4").view(np.int32)


def pack_flat(preps, N_pad: int | None = None):
    """Pack non-empty `GlyphPrep`s into the flat segment layout.

    Returns (flat [4, N_pad] f32 rows vx, vy, wx, wy, meta [G, 8] i32
    rows x0, y0, w, h, nseg, seg_off, 0, 0, P_pad the pixel bucket of
    the largest bitmap). Each glyph's run starts at an SC-aligned lane; an
    S-bucket of slack follows the last run. Lanes outside each glyph's
    ``[seg_off, seg_off + nseg)`` may hold stale values: every consumer
    masks by nseg."""
    G = len(preps)
    meta = np.zeros((max(G, 1), 8), dtype=np.int32)
    if G:
        cols = np.array(
            [(p.x0, p.y0, p.width, p.height, p.segments.shape[0]) for p in preps],
            dtype=np.int64,
        )
        runs = -(-np.maximum(cols[:, 4], 1) // SC) * SC
        offs = np.concatenate([[0], np.cumsum(runs)[:-1]])
        meta[:G, :5] = cols
        meta[:G, 5] = offs
        off = int(runs.sum())
    else:
        off = 0
    if N_pad is None:
        s_slack = bucket(max((int(m) for m in meta[:, 4]), default=1), S_BUCKETS)
        N_pad = bucket(max(off + s_slack, SC), N_BUCKETS)
    flat = get_array("torch_pack_flat", (4, N_pad), np.float32)
    for g, p in enumerate(preps):
        n = p.segments.shape[0]
        if n:
            o = int(meta[g, 5])
            flat[:, o : o + n] = p.segments.T
    max_p = max((p.width * p.height for p in preps), default=0)
    P_pad = bucket(max(max_p, 1), P_BUCKETS)
    return flat, meta, P_pad


def pack_points(preps, N_pad: int | None = None, dtype=np.float32, arena_tag: str = ""):
    """Pack non-empty `GlyphPrep`s into the point-chain layout.

    Returns (pts [2, N_pad] f32 or i16 x/y rows, mask_words [N_pad//32]
    i32 — bit j of word w is lane 32w+j —, meta [G, 8] i32 with x0, y0,
    w, h, npts, off; the JAX packer's fourth item, a pixel bucket, has
    no use here). ``dtype=np.int16`` is the q16 wire; every prep must
    then be ``q16_ok``. Lanes past each glyph's run may hold stale
    values: every consumer masks them."""
    meta, npts, _ = _group_meta(preps)
    N = int(npts.sum())
    if N_pad is None:
        N_pad = _n_pad(npts)
    i16 = np.dtype(dtype) == np.int16
    pts = get_array(f"torch_pack_points_{'i16' if i16 else 'f32'}{arena_tag}", (2, N_pad), dtype)
    if preps and N:
        chains = [p.chain16 if i16 else p.chain32 for p in preps]
        np.concatenate(chains, axis=1, out=pts[:, :N])
    return pts, _mask_words(preps, N, N_pad, arena_tag), meta


def pack_points_delta(preps, N_pad: int | None = None, arena_tag: str = ""):
    """Pack non-empty `GlyphPrep`s into the i8-delta wire.

    Lane-to-lane deltas of the q16 chain that fit a signed byte ship as
    i8; the others (and every glyph's lane 0) are anchors whose true
    delta rides in a sparse side table, scatter-added back before one
    cumsum (`ops.sdf_torch.reconstruct_delta`). Returns (deltas
    [2, N_pad] i8, mask_words [N_pad//32] i32, anchors [3, K_pad] i32 —
    lane, x jump, y jump; padding columns are (0, 0, 0) —, meta [G, 8]
    i32 as in `pack_points`)."""
    G = len(preps)
    meta, npts, offs = _group_meta(preps)
    N = int(npts.sum())
    if N_pad is None:
        N_pad = _n_pad(npts)
    deltas = get_array(f"torch_pack_delta_d8{arena_tag}", (2, N_pad), np.int8)
    caches = [p.delta_cache for p in preps]
    ancs = np.fromiter((c[1].shape[0] for c in caches), dtype=np.int64, count=G)
    astarts = np.zeros(G, np.int64)
    if G:
        np.cumsum(ancs[:-1] + 1, out=astarts[1:])
    K = int(ancs.sum()) + G
    K_pad = bucket(max(K, 1), K_BUCKETS)
    anchors = get_array(f"torch_pack_delta_anc{arena_tag}", (3, K_pad), np.int32)
    anchors[:, K:] = 0
    if G:
        if N:
            np.concatenate([c[0] for c in caches], axis=1, out=deltas[:, :N])
        # Lane-0 jump of glyph g: q_first[g] − q_last[g−1] (q_last[−1] = 0).
        qf_all = np.concatenate([c[3] for c in caches]).reshape(G, 2).T
        ql_all = np.concatenate([c[4] for c in caches]).reshape(G, 2).T
        j0 = qf_all.copy()
        j0[:, 1:] -= ql_all[:, :-1]
        anchors[0, astarts] = offs
        anchors[1:3, astarts] = j0
        Ka = int(ancs.sum())
        if Ka:
            ai_all = np.concatenate([c[1] for c in caches]).astype(np.int64)
            aj_all = np.concatenate([c[2] for c in caches], axis=1)
            within = np.arange(Ka) - np.repeat(
                np.concatenate([[0], np.cumsum(ancs)[:-1]]), ancs
            )
            dst = np.repeat(astarts + 1, ancs) + within
            anchors[0, dst] = ai_all + np.repeat(offs[:G], ancs)
            anchors[1:3, dst] = aj_all
    return deltas, _mask_words(preps, N, N_pad, arena_tag), anchors, meta


def tile_starts(meta: np.ndarray, G: int, TP: int):
    """Per-glyph first tile and the used tile count of a packed group:
    glyph g's bitmap is ``out.reshape(-1)[starts[g]*TP : starts[g]*TP
    + w·h]``."""
    if G == 0:
        return np.zeros(0, np.int64), 0
    npix = meta[:G, 2].astype(np.int64) * meta[:G, 3]
    ntiles = np.maximum(1, -(-npix // TP))
    starts = np.concatenate([[0], np.cumsum(ntiles)[:-1]])
    return starts, int(ntiles.sum())


def plan_tiles(preps, meta: np.ndarray, TP: int, T_pad: int | None = None):
    """The tile table [T_pad, 8] i32 of a group: glyph g owns
    ``ceil(w·h / TP)`` consecutive rows ``[x0, y0, w, h, npts, off,
    pix_base, 0]``; padding rows are zeros (w·h = 0, skipped). Returns
    (tmeta, starts [G] i64, T_used)."""
    G = len(preps)
    if G == 0:
        T0 = T_pad if T_pad is not None else T_BUCKETS[0]
        return np.zeros((T0, 8), dtype=np.int32), np.zeros(0, np.int64), 0
    starts, T = tile_starts(meta, G, TP)
    if T_pad is None:
        T_pad = bucket(max(T, 1), T_BUCKETS)
    if T > T_pad:
        raise ValueError(f"{T} tiles exceed T_pad={T_pad}")
    ntiles = np.diff(np.append(starts, T))
    tmeta = get_array("torch_plan_tiles", (T_pad, 8), np.int32)
    tmeta[T:] = 0
    g_of_tile = np.repeat(np.arange(G), ntiles)
    tmeta[:T] = meta[g_of_tile]
    tmeta[:T, 6] = (np.arange(T) - starts[g_of_tile]) * TP
    return tmeta, starts, T


def wire_to_device(pack_tuple, device: torch.device) -> tuple:
    """The numpy arrays of a pack tuple as tensors on ``device``, each a
    blocking copy (the packers' arena buffers are rewritten by the next
    pack, so nothing may still read them)."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)
        for a in pack_tuple
    )


class DeviceLane:
    """One device of a render session and its streams.

    On a CUDA device: a compute stream (the i8 decode, the tile table and
    the kernel), an upload stream and a fetch stream. The upload is a
    blocking copy from the packers' pageable arena buffers, which the
    next pack rewrites; on a stream of its own it waits for nothing but
    itself, not for the kernel of the group before. The fetch of a group
    is queued after its kernel's event and not awaited, so it overlaps
    the next group's pack and kernel (the card has a copy engine each
    way). A CUDA stream is the thread's current stream only inside `on`.
    On the CPU the streams are None and every step is done when it
    returns; events are None. One card listed twice as the local devices
    gives two lanes, two sets of streams.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.Stream(self.device)
            self.upload = torch.cuda.Stream(self.device)
            self.fetch = torch.cuda.Stream(self.device)
        else:
            self.compute = self.upload = self.fetch = None

    def on(self, stream):
        """Make ``stream`` the calling thread's current stream."""
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    @staticmethod
    def record(stream):
        """An event at the end of what is queued on ``stream`` (None on
        the CPU)."""
        if stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def to_device(self, arrays) -> tuple:
        """The numpy ``arrays`` as tensors on the lane's device, copied on
        the upload stream (`wire_to_device`: complete when it returns, so
        the arrays may be rewritten and the compute stream may read the
        tensors at once). They are marked as in use by the compute
        stream, so the upload stream cannot reuse their memory before
        the kernel has read it."""
        with self.on(self.upload):
            dev = wire_to_device(arrays, self.device)
        if self.cuda:
            for t in dev:
                t.record_stream(self.compute)
        return dev

    def fetch_to_host(self, out: torch.Tensor, ready):
        """Queue the copy of ``out`` to a fresh host tensor on the fetch
        stream, after the event ``ready`` (the kernel's). Returns (host
        [numel] u8, the copy's event). On a card the host tensor is
        pinned, the copy asynchronous, and ``out`` is marked as in use
        by the fetch stream, so the compute stream cannot reuse its
        memory before the copy has read it."""
        with self.on(self.fetch):
            if ready is not None:
                self.fetch.wait_event(ready)
            host = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=self.cuda)
            host.copy_(out.reshape(-1), non_blocking=self.cuda)
            done = self.record(self.fetch)
        if self.cuda:
            out.record_stream(self.fetch)
        return host, done

    def synchronize(self) -> None:
        """Wait for everything queued on the lane's streams."""
        if self.cuda:
            for s in (self.upload, self.compute, self.fetch):
                s.synchronize()


_LANES: dict = {}


def device_lanes(devices) -> list:
    """A `DeviceLane` for each entry of ``devices`` (a device listed
    twice gets two), kept for the life of the process: the caching
    allocator keeps freed device memory per stream, so a session that
    reused no streams would allocate afresh what the last one freed."""
    lanes, seen = [], {}
    for d in devices:
        d = torch.device(d)
        k = seen[d] = seen.get(d, -1) + 1
        lane = _LANES.get((d, k))
        if lane is None:
            lane = _LANES[(d, k)] = DeviceLane(d)
        lanes.append(lane)
    return lanes
