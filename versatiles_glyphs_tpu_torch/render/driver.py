"""Render driver: pluggable SDF backends and the batched render session
(counterpart of `versatiles_glyphs_tpu.render.driver`).

Backends:

- ``"cuda"``  — the hand-written tile kernel (`ops.sdf_cuda`) on the
                first CUDA device, or on every local one
                (`Renderer.start_session`); raises when there is none.
- ``"torch"`` — the same session and wire on the CPU, through the
                kernel's plain PyTorch version.
- ``"padded"`` — the padded-layout render of the JAX ``"jax"`` backend
                (`batch.pack_block`, `ops.sdf_torch.render_bitmaps_padded`,
                the same bytes) on the first CUDA device, raising when
                there is none, or on the device the caller names.
- ``"exact"`` — the float64 native/NumPy renderer (`proto.native`,
                `ops.sdf_ref`), on the CPU.
- ``"zeros"`` — empty bitmaps of the right size (``--dummy``).
- ``"auto"``  — ``"cuda"``: the default is the card, and without one the
                constructor raises. The CPU backends are chosen by name.

This module loads without the font parser: `prep_glyph` and
`prep_block` reach a font entry only through its methods (`glyph_key`,
`prep_cores`, `outline_rings`, `hor_advance`), so fitted and
synthesized glyphs render through them too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import cuda_device
from ..proto.pbf import PbfGlyph
from ..utils import trace
from .metrics import GlyphPrep, prepare_glyph

# Bytes the device backends uploaded and fetched, and their groups, since
# the last `reset_wire_stats` (counterpart of the JAX driver's ledger):
# every wire array of a group once, and its whole output; the groups'
# glyphs, the 256-pixel tiles the kernel renders for them, and their
# bitmaps' own pixels (w·h).
WIRE_STATS = {"upload_bytes": 0, "fetch_bytes": 0, "groups": 0, "glyphs": 0, "tiles": 0,
              "pixels": 0}


def reset_wire_stats() -> None:
    for k in WIRE_STATS:
        WIRE_STATS[k] = 0


BACKENDS = ("auto", "cuda", "torch", "padded", "exact", "zeros")
TRANSPORTS = ("auto", "i8", "i16", "f32")

_SURROGATE_LO, _SURROGATE_HI = 0xD800, 0xDFFF


def _valid_cp(cp: int) -> bool:
    """The reference's `char::from_u32` filter (`renderer.rs:104`):
    scalar values only. Shared by `prep_glyph` and the hoisted
    `prep_block` loop so the two paths cannot diverge."""
    return cp <= 0x10FFFF and not (_SURROGATE_LO <= cp <= _SURROGATE_HI)


class Renderer:
    # Soft caps on one device group (lanes, 256-px tiles), as in the JAX
    # driver: a group closes when the next glyph would pass either.
    _LANES_SOFT = 600_000
    _TILES_SOFT = 4096

    def __init__(self, backend: str = "auto", transport: str = "auto", device=None):
        """``device``: the ``padded`` backend's torch device or its name
        (None or ``"cuda"``: the first CUDA device, which raises without
        one); the other backends have fixed devices and refuse one."""
        if backend == "auto":
            backend = "cuda"
        if backend not in BACKENDS:
            raise ValueError(f"unknown renderer backend {backend!r}")
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown point transport {transport!r}")
        if device is not None and backend != "padded":
            raise ValueError(f"the {backend!r} renderer runs on a fixed device: "
                             "a device is chosen only for 'padded'")
        self.backend = backend
        # "i8" (default): i8 lane deltas of the q16 chain plus a sparse
        # anchor table; "i16": the q16 chain (same decoded points, so the
        # same bytes); "f32": f32 points (tighter parity, twice the bytes).
        self.transport = "i8" if transport == "auto" else transport
        self.device: torch.device | None = None
        if backend == "cuda":
            self.device = cuda_device()
        elif backend == "torch":
            self.device = torch.device("cpu")
        elif backend == "padded":
            self.device = cuda_device() if device in (None, "cuda") else torch.device(device)

    # -- per-glyph host prep --------------------------------------------

    def prep_glyph(self, entry, codepoint: int) -> GlyphPrep | None:
        """Host metric computation for one codepoint; None when the font
        has no glyph for it (or it is not a valid char — the reference's
        `char::from_u32` filter, `renderer.rs:104`)."""
        if not _valid_cp(codepoint):
            return None
        key = entry.glyph_key(codepoint)
        if key is None:
            return None
        cores = entry.prep_cores
        if cores is not None:
            core = cores.get(key)
            if core is not None:
                # Vectorized font-level prep: metrics + transport caches
                # were computed once for the whole font; codepoints
                # sharing a glyph share the core's arrays.
                return core.make_prep(codepoint)
        # Per-glyph path: an entry without a core table, or a glyph
        # whose core failed (its outline is read again, and raises).
        rings = entry.outline_rings(key)
        return prepare_glyph(codepoint, rings, entry.units_per_em, entry.hor_advance(key))

    def prep_block(self, sources) -> list[GlyphPrep]:
        """Host prep for a block's (codepoint, entry) pairs — the
        manager's hot loop. Equivalent to `prep_glyph` per pair but
        with the per-call indirection hoisted: consecutive pairs
        sharing an entry reuse its core table and key map directly.
        Returns preps for mapped codepoints only."""
        out: list[GlyphPrep] = []
        cur_entry = None
        cores = gmap = None
        for cp, entry in sources:
            if entry is not cur_entry:
                cur_entry = entry
                cores = entry.prep_cores
                gmap = entry._gid_map if cores is not None else None
            if gmap is not None and _valid_cp(cp):
                gid = gmap.get(cp)
                if gid is None:
                    continue
                core = cores.get(gid)
                if core is not None:
                    out.append(core.make_prep(cp))
                    continue
            p = self.prep_glyph(entry, cp)
            if p is not None:
                out.append(p)
        return out

    # -- PBF assembly ------------------------------------------------------

    @staticmethod
    def assemble_glyphs(preps, bitmap_iter) -> list[PbfGlyph]:
        """Pair preps with bitmaps (one from ``bitmap_iter`` per non-empty
        prep, in order) into PbfGlyph messages."""
        out = []
        for p in preps:
            if p.empty:
                out.append(PbfGlyph.empty(p.codepoint, p.advance))
                continue
            out.append(PbfGlyph(
                id=p.codepoint,
                bitmap=np.asarray(next(bitmap_iter), dtype=np.uint8).tobytes(),
                width=p.pbf_width, height=p.pbf_height,
                left=p.pbf_left, top=p.pbf_top, advance=p.advance,
            ))
        return out

    def render_block_glyphs(self, glyph_sources) -> list[PbfGlyph]:
        """Render a block: (codepoint, font entry) pairs → PbfGlyphs in
        codepoint order. Mirrors `GlyphBlock::render`
        (`src/font/glyph_block.rs:69-80`) with device batching. (The
        manager normally batches across *all* blocks of a run instead —
        see `FontManager.render_glyphs` — this entry point renders one
        block standalone.)"""
        preps: list[GlyphPrep] = []
        for cp, entry in glyph_sources:
            p = self.prep_glyph(entry, cp)
            if p is not None:
                preps.append(p)

        nonempty = [p for p in preps if not p.empty]
        bitmaps = self.render_bitmaps(nonempty)
        return self.assemble_glyphs(preps, iter(bitmaps))

    # -- batched rendering -----------------------------------------------

    def start_session(self, parallel: bool = True, progress=None) -> "RenderSession":
        """Open an incremental render session (see `RenderSession`).
        ``parallel=True`` deals the batch over every local device of the
        backend's kind when there are two or more
        (`parallel.mesh.data_devices`); ``False`` keeps it on one device
        (the reference's ``--single-thread``)."""
        return RenderSession(self, parallel=parallel, progress=progress)

    def render_bitmaps(self, preps, parallel: bool = True, progress=None) -> list:
        """Quantized uint8 bitmaps (flat, Y-flipped, len w·h) of non-empty
        preps through one `RenderSession` (counterpart of the JAX
        `Renderer.render_bitmaps`; ``parallel`` as in `start_session`)."""
        if not preps:
            return []
        with self.start_session(parallel=parallel, progress=progress) as session:
            session.add(preps)
            return list(session.results())

    # Caps on one bin of the several-device path (`_lpt_rounds`): the JAX
    # driver's SMEM caps, kept so that the bins equal its bins.
    _LANES_MAX = 1_500_000
    _TILES_MAX = 12288

    def _dispatch_group(self, gitems, wire: str, TP: int, lane):
        """Pack one group, check its lane runs on the host arrays, upload
        it and queue its render and its fetch on the ``lane``'s streams;
        nothing is awaited but the upload (see `batch.DeviceLane`). A
        plan that fails the check raises before anything is uploaded.
        Returns the group's `_Group`."""
        from ..ops import sdf_cuda
        from .batch import pack_points, pack_points_delta, plan_tiles, tile_starts

        gpreps = [p for _, p in gitems]
        G = len(gpreps)
        with trace.span("session.pack"):
            if wire == "i8":
                deltas, words, anchors, meta = pack_points_delta(gpreps)
                starts, T = tile_starts(meta, G, TP)
                sdf_cuda.check_lane_runs(deltas.shape[1], meta[:, 4], meta[:, 5], anchors[0])
                arrays = (deltas, words, anchors, meta)
            else:
                dt = np.int16 if wire == "i16" else np.float32
                pts, words, meta = pack_points(gpreps, dtype=dt)
                starts, T = tile_starts(meta, G, TP)
                tmeta, _, _ = plan_tiles(gpreps, meta, TP, T_pad=T)
                sdf_cuda.check_lane_runs(pts.shape[1], tmeta[:, 4], tmeta[:, 5])
                arrays = (pts, words, tmeta.T)
        with trace.span("session.upload"):
            dev = lane.to_device(arrays)
        WIRE_STATS["upload_bytes"] += sum(a.nbytes for a in arrays)
        with trace.span("session.launch"):
            with lane.on(lane.compute):
                if wire == "i8":
                    out = sdf_cuda.render_bitmaps_cuda_delta(*dev, TP, T_pad=T, checked=True)
                else:
                    out = sdf_cuda.render_bitmaps_cuda_pts(*dev, TP, checked=True)
                rendered = lane.record(lane.compute)
            host, fetched = lane.fetch_to_host(out, rendered)
        WIRE_STATS["fetch_bytes"] += host.numel()
        WIRE_STATS["groups"] += 1
        WIRE_STATS["glyphs"] += G
        WIRE_STATS["tiles"] += T
        WIRE_STATS["pixels"] += int((meta[:G, 2].astype(np.int64) * meta[:G, 3]).sum())
        return _Group(gitems, starts, host, fetched)

    def _lpt_rounds(self, items, D: int, TP: int):
        """Balance (index, prep) items across ``D`` devices: greedy
        longest-processing-time bin packing by tile count into ``k·D``
        bins, growing ``k`` until every bin fits the SMEM caps. Returns
        a list of rounds, each a list of D bins (possibly empty)."""

        def tiles(p):
            return max(1, -(-(p.width * p.height) // TP))

        order = sorted(items, key=lambda ip: -tiles(ip[1]))
        k = 1
        while True:
            nb = D * k
            bins: list[list] = [[] for _ in range(nb)]
            loads = [0] * nb
            lanes = [0] * nb
            for i, p in order:
                b = loads.index(min(loads))
                bins[b].append((i, p))
                loads[b] += tiles(p)
                lanes[b] += p.npts
            if max(loads) <= self._TILES_MAX and max(lanes) <= self._LANES_MAX:
                return [bins[r * D : (r + 1) * D] for r in range(k)]
            k += 1

    def _render_devices(self, lanes, main, aux, TP: int) -> list:
        """The several-device path (counterpart of the JAX
        `_render_tpu_mesh`): each partition's items dealt by
        `_lpt_rounds` over the lanes, every non-empty bin of every round
        dispatched as one group on its own lane, all in flight at once.
        The main partition keeps the session's wire, the aux one ships
        f32. Returns the groups' `_Group`s in dispatch order; the session
        places their bitmaps by submit index."""
        out = []
        for items, wire in ((main, self.transport), (aux, "f32")):
            if not items:
                continue
            for round_bins in self._lpt_rounds(items, len(lanes), TP):
                for lane, b in zip(lanes, round_bins):
                    if b:
                        out.append(self._dispatch_group(b, wire, TP, lane))
        return out


class _Group:
    """A dispatched group: its (submit index, prep) items, each glyph's
    first tile, the host tensor its bitmaps are fetched into and the
    fetch's event (None on the CPU)."""

    __slots__ = ("items", "starts", "host", "fetched")

    def __init__(self, items, starts, host, fetched):
        self.items, self.starts, self.host, self.fetched = items, starts, host, fetched

    def wait(self) -> np.ndarray:
        """The fetched tiles, flat, once the fetch has completed."""
        if self.fetched is not None:
            self.fetched.synchronize()
        return self.host.numpy()


class RenderSession:
    """Incremental batched render (see `Renderer.start_session`).

    ::

        with renderer.start_session(progress=tick) as s:
            for block in blocks:
                s.add(nonempty_preps_of(block))
            for bitmap in s.results():   # in add() order
                ...

    Device backends route preps to a q16 "main" buffer (the i8 or i16
    wire) and an f32 "aux" buffer (glyphs outside the q16 range,
    `GlyphPrep.q16_ok`).

    One device: a buffer that reaches the soft caps becomes a group at
    once. `add` packs it, checks it on the host, uploads it and queues
    its launch and its fetch on the lane's streams (`batch.DeviceLane`)
    without waiting for the card, so the card renders group g while the
    caller prepares and packs group g+1. `results` dispatches the rest,
    then waits for each group's fetch in order and yields bitmaps in
    submit order: the caller's encode of group g overlaps the later
    groups' kernels and copies. Everything runs on the caller's thread:
    pack and encode are Python and hold the GIL, so a dispatch thread
    overlapped neither and made a warm render 7-28 % slower (median of
    16 in turns, NVIDIA H100 80GB HBM3 at 700 W, `tools.session_turns`;
    `PERF.md` §6). The arena buffers the packers return are rewritten only
    by the next pack, after the blocking upload has read them; an
    asynchronous copy from a pinned staging ring cost more host time
    than it hid (`PERF.md` §6).

    Several devices (``parallel`` and two or more of them): dispatch is
    deferred to `results`. With at least two items a device, the batch
    is dealt by `Renderer._render_devices`; with fewer, it goes as the
    one-device groups on the first device.

    The ``padded``, ``exact`` and ``zeros`` backends render inside `add`;
    ``padded`` packs and renders each call's preps as one batch on its
    device, as the JAX ``jax`` backend does, and never falls back to
    another device or backend.

    `close` waits for every copy and kernel in flight and drops every
    pending group. `results` calls it when it ends, is left early or
    raises, and so does leaving a ``with`` block.
    """

    _TP = 256  # the tile size `GlyphPrep.ntiles256` bakes in

    def __init__(self, renderer: Renderer, parallel: bool = True, progress=None):
        self.r = renderer
        self.tick = progress or (lambda n: None)
        self.groups = 0  # device groups dispatched
        self._n = 0  # preps submitted
        self._eager: list[np.ndarray] = []
        self._pending: list[_Group] = []
        self._main: list = []
        self._aux: list = []
        self._main_sz = [0, 0]
        self._aux_sz = [0, 0]
        self._closed = False
        self._lanes: list = []
        self._several = False
        # The wire backends render in device groups; the rest in `add`.
        self._wire = renderer.backend in ("cuda", "torch")
        if self._wire:
            from ..parallel import mesh
            from .batch import device_lanes

            devices = mesh.data_devices(device_type=renderer.device.type) if parallel else None
            self._several = devices is not None and len(devices) >= 2
            self._lanes = device_lanes(devices if self._several else [renderer.device])

    def __enter__(self) -> "RenderSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True
        for lane in self._lanes:
            lane.synchronize()
        self._pending = []
        self._eager = []
        self._main = []
        self._aux = []

    # -- submission ------------------------------------------------------

    def add(self, preps) -> None:
        """Submit non-empty preps; may dispatch filled device groups."""
        with trace.span("session.add"):
            self._add(preps)

    def _add(self, preps) -> None:
        if self._closed:
            raise RuntimeError("render session is closed")
        r = self.r
        if self._wire:
            q16 = r.transport in ("i8", "i16")
            for p in preps:
                item = (self._n, p)
                self._n += 1
                if q16 and not p.q16_ok:
                    self._buf_add(self._aux, self._aux_sz, item, "f32")
                else:
                    self._buf_add(self._main, self._main_sz, item, r.transport)
            return
        self._n += len(preps)
        if not preps:
            return
        if r.backend == "zeros":
            self._eager.extend(np.zeros(p.width * p.height, dtype=np.uint8) for p in preps)
            self.tick(len(preps))
            return
        if r.backend == "padded":
            from ..ops.sdf_torch import render_bitmaps_padded
            from .batch import pack_block

            segs, meta, P = pack_block(preps)
            out = render_bitmaps_padded(
                torch.from_numpy(segs).to(r.device), torch.from_numpy(meta).to(r.device), P
            ).cpu().numpy()
            self._eager.extend(out[g, : p.width * p.height].copy() for g, p in enumerate(preps))
            self.tick(len(preps))
            return
        from ..proto import native

        if native.available():
            for i in range(0, len(preps), 512):
                chunk = preps[i : i + 512]
                self._eager.extend(native.render_sdf_batch(chunk))
                self.tick(len(chunk))
        else:
            from ..ops.sdf_ref import render_sdf_exact

            for p in preps:
                self._eager.append(render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0))
                self.tick(1)

    def _buf_add(self, buf: list, sz: list, item, wire: str) -> None:
        _, p = item
        if not self._several and buf and (
            sz[0] + p.npts > self.r._LANES_SOFT or sz[1] + p.ntiles256 > self.r._TILES_SOFT
        ):
            self._dispatch(buf, wire)
            del buf[:]
            sz[0] = sz[1] = 0
        buf.append(item)
        sz[0] += p.npts
        sz[1] += p.ntiles256

    def _dispatch(self, items: list, wire: str) -> None:
        self._pending.append(
            self.r._dispatch_group(list(items), wire, self._TP, self._lanes[0]))
        self.groups += 1

    # -- consumption -----------------------------------------------------

    def results(self):
        """Yield bitmaps in `add` order (a generator; see class doc)."""
        if self._closed:
            raise RuntimeError("render session is closed")
        try:
            if not self._wire:
                yield from self._eager
                return
            if self._several and self._n >= 2 * len(self._lanes):
                groups = self.r._render_devices(
                    self._lanes, self._main, self._aux, self._TP)
                self._pending += groups
                self.groups += len(groups)
            else:
                if self._main:
                    self._dispatch(self._main, self.r.transport)
                if self._aux:
                    self._dispatch(self._aux, "f32")
            self._main, self._aux = [], []

            TP = self._TP
            placed: list = [None] * self._n
            ptr = 0
            for group in self._pending:
                with trace.span("session.fetch_wait"):
                    flat = group.wait()
                # Placed by submit index: the q16/aux partition and the
                # bins of several devices reorder.
                for g, (i, p) in enumerate(group.items):
                    s0 = group.starts[g] * TP
                    placed[i] = flat[s0 : s0 + p.width * p.height]
                self.tick(len(group.items))
                while ptr < self._n and placed[ptr] is not None:
                    yield placed[ptr]
                    placed[ptr] = False  # drop the reference once consumed
                    ptr += 1
            if ptr != self._n:
                raise RuntimeError(f"render session lost results ({ptr} of {self._n})")
        finally:
            self.close()
