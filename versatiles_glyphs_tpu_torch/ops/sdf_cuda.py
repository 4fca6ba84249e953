"""Kernel wrappers (counterparts of `versatiles_glyphs_tpu.ops.sdf_pallas`
and of the Pallas kernels of `ops.sdf_grad`, `ops.legacy` and the
measurement scripts).

The port's fourteen hand-written kernels, each on the current stream:

- ``sdf_tiles_pts`` (render): `render_bitmaps_cuda_pts`,
  `render_bitmaps_cuda_delta`. A block of TP / R threads a tile, R
  pixels a thread (`pixels_per_thread`); it stages only a chunk's live
  segments, as 32-byte records, and tests a segment's crossing once a
  bitmap row of the tile instead of once a pixel;
- ``sdf_min_field_pts`` (fitting forward): `min_field_cuda_pts`. The
  render tile kernel's body with the first argmin kept: a staged
  segment carries its global lane (`min_field_pixels_per_thread`);
- ``sdf_min_field_bwd`` (fitting backward): `min_field_bwd_cuda`. A
  warp walks a glyph's pixels in order and routes each pixel's terms to
  its argmin lane's accumulators, the lanes of a step grouped by lane
  (`flat_bwd_launch_shape`); no scan of the lanes;
- ``sdf_min_field_padded`` (padded-layout fitting forward):
  `min_field_cuda_padded`. A block renders a span of up to four pixels
  a thread of one glyph (`padded_launch_shape`), stages the glyph's live
  segments in order with their indices carried for the argmin, and
  takes the winding from the same per-row crossing lists;
- ``sdf_min_field_padded_bwd`` (its backward): `min_field_padded_bwd_cuda`.
  A warp walks a glyph's pixels in order and routes each pixel's terms
  to its argmin segment's accumulators, the lanes of a step grouped by
  segment (`padded_bwd_launch_shape`); no scan of the segments;
- ``sdf_tiles_flat`` and ``sdf_grid_flat`` (render over the flat
  segment layout): wrapped in `ops.legacy`; the flat tile kernel is
  ``sdf_tiles_pts``'s tile body over a staged soup, and the grid kernel
  shares its records and row lists (`legacy.grid_launch_shape`);
- ``sdf_tiles_pts_acc`` (the render tile kernel with a pixel's segments
  split over a sub-warp; the same function and plain version as
  ``sdf_tiles_pts``): `render_bitmaps_cuda_pts_acc`, for
  `tools.kernel_ab`;
- ``alu_roof`` (the synthetic ALU roof on the tile kernel's launch
  shape): `alu_roof_cuda`, for `tools.roofline`;
- ``adam_flat`` (the fit's Adam update, every leaf in one launch): wrapped
  in `ops.adam`, whose plain version it gives bit for bit;
- ``flat_chain_fwd``, ``flat_loss_fwd``, ``flat_loss_bwd`` and
  ``flat_chain_bwd`` (the fused flat-fit loss around the min-field pair:
  the point chain, each glyph's loss, the cotangent of d² and the
  leaves' gradients): wrapped in `ops.flat_loss`, whose plain versions
  they give bit for bit.

On CUDA tensors a wrapper launches its kernel (``csrc/<name>.cu``); on
CPU tensors it runs the kernel's plain version in `ops.sdf_torch`.
There is no fallback from one to the other: a build or launch that
fails raises. Each wrapper checks dtypes, shapes and the tile table's
bounds (one host sync) before it launches; ``launch_*`` is the launch
alone, for a caller that has checked its inputs (the fitter checks its
static plan once, `check_flat_plan`; the render session checks each
group's host arrays, `check_lane_runs`, and passes ``checked=True``).

The i8-delta decode, the dequantize and the tile table (the XLA
prepass steps of the TPU path) are plain PyTorch ops on the tensor's
device. The TPU prepass's chunk-row restructuring has no counterpart:
the kernels read the flat point chain and the mask bits directly.

``LAUNCHES[name]`` counts each kernel's launches since `reset_launches`.
A launch recorded into a CUDA graph runs at each replay: `capturing`
takes a capture's launches back out of the counts (nothing ran) and
`count_replay` adds them once a replay.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ..constants import CUTOFF, SDF_RADIUS

from . import _build
from .sdf_torch import (
    ALU_ROOF_TRIPLES,
    alu_roof,
    dequantize,
    derive_tmeta,
    min_field_bwd_pts,
    min_field_padded,
    min_field_padded_bwd,
    min_field_pts,
    reconstruct_delta,
    render_tiles_pts,
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# kernel name -> (C symbol, ctypes argument types)
_SIGNATURES = {
    "sdf_tiles_pts": ("vg_sdf_tiles_pts", [_P, _I, _P, _P, _I, _I, _I, _F, _F, _P, _P]),
    "sdf_min_field_pts": ("vg_sdf_min_field_pts", [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "sdf_min_field_bwd": ("vg_sdf_min_field_bwd", [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "sdf_min_field_padded": (
        "vg_sdf_min_field_padded", [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P]),
    "sdf_min_field_padded_bwd": (
        "vg_sdf_min_field_padded_bwd", [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "sdf_tiles_flat": ("vg_sdf_tiles_flat", [_P, _I, _P, _I, _I, _I, _F, _F, _P, _P]),
    "sdf_grid_flat": ("vg_sdf_grid_flat", [_P, _I, _P, _I, _I, _I, _I, _F, _F, _P, _P]),
    "alu_roof": ("vg_alu_roof", [_I, _I, _I, _F, _I, _P, _P]),
    # The same function as sdf_tiles_pts, so its plain version is
    # `sdf_torch.render_tiles_pts` too.
    "sdf_tiles_pts_acc": (
        "vg_sdf_tiles_pts_acc", [_P, _I, _P, _P, _I, _I, _I, _F, _F, _P, _P]),
    # Adam's update of the fit's leaves (`ops.adam`; host arrays of
    # pointers, counts and scalars).
    "adam_flat": ("vg_adam_flat", [_I, _P, _P, _P, _P]),
    # The fused flat-fit loss (`ops.flat_loss`): the chain, the loss and
    # their backwards around kernels 2 and 3.
    "flat_chain_fwd": ("vg_flat_chain_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "flat_loss_fwd": ("vg_flat_loss_fwd", [_P, _P, _P, _P, _I, _P, _I, _P, _P]),
    "flat_loss_bwd": (
        "vg_flat_loss_bwd", [_P, _L, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P]),
    "flat_chain_bwd": (
        "vg_flat_chain_bwd", [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
}
# ``sdf_min_field_padded``: the most threads a block and pixels a
# thread of the launcher's shape (`padded_launch_shape`: two blocks of
# 128 threads a glyph at P = 768, the fastest of the shapes that
# `tools.kernel_turns` timed on both synthesized fonts' fit batches),
# and the most the kernel is compiled for (kMaxThreads, kMaxR of the
# source).
PADDED_THREADS = 128
PADDED_PIXELS_PER_THREAD = 3
PADDED_THREADS_MAX = 256
PADDED_PIXELS_PER_THREAD_MAX = 4
# ``sdf_min_field_padded_bwd``: threads a block (each warp a glyph, or
# one of the ranges of a glyph's pixels; 64 to 512 are within 2 % of
# each other on the text font's fit batch, 128 is faster than 256 and
# 512 on the heavy font's, `tools.kernel_turns`), the pixels up to which one
# warp walks a whole glyph, and the shared memory a block's
# accumulators may take (kSmemMax of the source; 16 bytes a segment and
# warp), which sizes the chunk of segments a pass covers.
PADDED_BWD_THREADS = 128
PADDED_BWD_WARP_PIXELS = 2048
PADDED_BWD_SMEM = 48 * 1024
# ``sdf_min_field_bwd``: threads a block (a warp a tile-table row; the
# warps of a glyph's other rows return at once) and the shared memory a
# block's accumulators may take (kSmemMax of the source; 16 bytes a
# lane and warp), which sizes the segment lanes a pass covers. 256
# threads (384 lanes a pass) ran 0.0195 / 0.0230 ms against 0.0259 /
# 0.0251 at 128 (768 lanes) on the synthesized fonts' flat plans
# (`tools.kernel_turns`, CUDA graph replays): at 48 KB a block, blocks of
# 256 threads keep all of a plan's rows resident at once.
FLAT_BWD_THREADS = 256
FLAT_BWD_SMEM = 48 * 1024
# Pixel indices below this split into rows by integer div and mod as the
# TPU's f32 division does (`versatiles_glyphs_tpu.ops.sdf_grad._pixel_coords`).
MAX_PADDED_PIXELS = 1 << 23
# Independent accumulators a thread of ``alu_roof`` (kChains of the
# source): a launch executes T·TP·n_chunk·ALU_ROOF_CHAINS·30 f32 ops.
ALU_ROOF_CHAINS = 4
# Threads a pixel of ``sdf_tiles_pts_acc`` by default: TP·4 = 1,024
# threads a block at TP = 256 (2 and 4 within 2 % of each other on both
# synthesized fonts, 1 slower on the heavy one, `tools.kernel_turns`; 8
# would need 2,048 threads a block).
ACC_SPLIT = 4
# Pixels a thread of ``sdf_tiles_pts`` and ``sdf_tiles_flat`` where TP
# allows it (a block of TP / 2 threads a tile: faster than 1 and than 4
# on both synthesized fonts, `tools.kernel_turns`; the kernels are
# compiled for 1 and 2).
TILE_PIXELS_PER_THREAD = 2
# Pixels a thread of ``sdf_min_field_pts`` where TP allows it (a block
# of TP / 4 threads a tile: faster than 1 and than 2 on both synthesized
# fonts' fit plans, `tools.kernel_turns`; the kernel is compiled for 1,
# 2 and 4).
MIN_FIELD_PIXELS_PER_THREAD = 4
# Sizes of ``csrc/sdf_pair.cuh`` that shape the work of ``sdf_tiles_pts``,
# ``sdf_tiles_flat``, ``sdf_min_field_pts``, ``sdf_grid_flat`` and
# ``sdf_min_field_padded``:
# segments a staged chunk (kRecChunk), bitmap
# rows of a block's pixels that get a crossing list (kRowsMax), and
# crossings a row lists for one chunk (kRowCross); past either the
# block tests every pair's crossing itself.
REC_CHUNK = 256
ROWS_MAX = 64
ROW_CROSS = 16
# ``sdf_grid_flat``: threads a block (the fastest of 64, 128 and 256 on
# both fonts) and the most the kernel is compiled for; pixels a thread
# of a full span (kMaxR of the source).
GRID_THREADS = 128
GRID_THREADS_MAX = 256
GRID_PIXELS_PER_THREAD = 4
KERNELS = tuple(_SIGNATURES)
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph capture: yields a dict that, on exit, holds
    the launches each kernel recorded into the graph, which are taken
    back out of `LAUNCHES` (a capture runs nothing)."""
    before = dict(LAUNCHES)
    recorded: dict = {}
    try:
        yield recorded
    finally:
        recorded.update({name: LAUNCHES[name] - before[name] for name in KERNELS})
        LAUNCHES.update(before)


def count_replay(recorded: dict) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``
    (`capturing`): a replay runs every launch the capture recorded."""
    for name, n in recorded.items():
        LAUNCHES[name] += n


def _launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry point with ``args`` and the current
    stream of ``device``; raise if it reports a CUDA error."""
    symbol, argtypes = _SIGNATURES[name]
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check(pts, mask_words, tmeta, TP: int) -> None:
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[0] != 2:
        raise ValueError(f"pts must be [2, N] float32, got {tuple(pts.shape)} {pts.dtype}")
    _check_plan_shapes(pts.shape[1], mask_words, tmeta, TP)
    if pts.device != tmeta.device:
        raise ValueError("pts, mask_words and tmeta must be on one device")


def _check_plan_shapes(N: int, mask_words, tmeta, TP: int) -> None:
    """Mask words and tile table of a point chain of N lanes: dtypes,
    shapes and one device (no host sync)."""
    if N % 32 or mask_words.dtype != torch.int32 or tuple(mask_words.shape) != (N // 32,):
        raise ValueError(
            f"mask_words must be [{N // 32}] int32 for N={N} (a multiple of 32), "
            f"got {tuple(mask_words.shape)} {mask_words.dtype}"
        )
    _check_tmeta(tmeta, TP)
    if mask_words.device != tmeta.device:
        raise ValueError("pts, mask_words and tmeta must be on one device")


def _check_tmeta(tmeta, TP: int) -> None:
    if tmeta.dtype != torch.int32 or tmeta.dim() != 2 or tmeta.shape[0] != 8:
        raise ValueError(f"tmeta must be [8, T] int32, got {tuple(tmeta.shape)} {tmeta.dtype}")
    if TP % 32 or not 32 <= TP <= 1024:
        raise ValueError(f"TP={TP} must be a multiple of 32 in [32, 1024]")


def _cuda_inputs(*tensors) -> None:
    """Raise unless every tensor is contiguous on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")


def _lanes_out_of_bounds(tmeta, N: int) -> torch.Tensor:
    """Rows whose lane run [off, off + npts) leaves [0, N)."""
    return (tmeta[5] < 0) | (tmeta[4] < 0) | (tmeta[5] + tmeta[4] > N)


def _check_cuda_lanes(pts, mask_words, tmeta) -> None:
    """The forward kernels' launch checks (one host sync)."""
    _cuda_inputs(pts, mask_words, tmeta)
    N = pts.shape[1]
    if tmeta.shape[1] and bool(_lanes_out_of_bounds(tmeta, N).any()):
        raise ValueError(f"tile table addresses lanes outside [0, {N})")


def check_lane_runs(N: int, npts, off, anchor_lanes=None) -> None:
    """The render path's lane checks on a group's host arrays, before
    they are uploaded (no device sync): every run ``[off, off + npts)``
    (the tile table's rows, or meta's, from which the i8 path derives
    it) inside ``[0, N)``, and every i8 anchor lane too (the decode's
    scatter-add would fault on the card). The render session checks
    here and then launches with ``checked=True``."""
    npts = np.asarray(npts, dtype=np.int64)
    off = np.asarray(off, dtype=np.int64)
    if ((off < 0) | (npts < 0) | (off + npts > N)).any():
        raise ValueError(f"tile table addresses lanes outside [0, {N})")
    if anchor_lanes is not None:
        lanes = np.asarray(anchor_lanes, dtype=np.int64)
        if ((lanes < 0) | (lanes >= N)).any():
            raise ValueError(f"i8 anchors address lanes outside [0, {N})")


def render_bitmaps_cuda_pts(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256,
    *, checked: bool = False,
) -> torch.Tensor:
    """Quantized uint8 bitmaps [T, TP] over the point-chain layout
    (counterpart of `sdf_pallas.render_bitmaps_pallas_pts`).

    pts: [2, N] f32, or i16 q16 fixed point (dequantized first);
    mask_words: [N//32] i32; tmeta: [8, T] i32 (`render.batch.plan_tiles`
    transposed). ``checked``: the caller has checked the lane runs on
    its host arrays (`check_lane_runs`), so the card is not asked (the
    dtypes, shapes and devices are still checked, with no sync)."""
    if pts.dtype == torch.int16:
        pts = dequantize(pts)
    _check(pts, mask_words, tmeta, TP)
    if pts.device.type == "cpu":
        return render_tiles_pts(pts, mask_words, tmeta, TP)
    if checked:
        _cuda_inputs(pts, mask_words, tmeta)
    else:
        _check_cuda_lanes(pts, mask_words, tmeta)
    return launch_tiles_pts(pts, mask_words, tmeta, TP)


def pixels_per_thread(TP: int) -> int:
    """Pixels a thread of the render tile kernels at tile size ``TP``:
    ``TILE_PIXELS_PER_THREAD`` where that leaves a block of whole warps
    (TP a multiple of 64), else 1."""
    return TILE_PIXELS_PER_THREAD if TP % (32 * TILE_PIXELS_PER_THREAD) == 0 else 1


def launch_tiles_pts(pts, mask_words, tmeta, TP: int) -> torch.Tensor:
    """The render tile kernel on inputs the caller has checked (see
    `render_bitmaps_cuda_pts`): allocate the output and launch, a block
    of TP / `pixels_per_thread` threads a tile."""
    N, T = pts.shape[1], tmeta.shape[1]
    out = torch.empty((T, TP), dtype=torch.uint8, device=pts.device)
    if T:
        _launch(
            "sdf_tiles_pts", pts.device, pts.data_ptr(), N, mask_words.data_ptr(),
            tmeta.data_ptr(), T, TP, pixels_per_thread(TP), 256.0 / SDF_RADIUS, CUTOFF,
            out.data_ptr(),
        )
    return out


def render_bitmaps_cuda_pts_acc(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256,
    split: int = ACC_SPLIT,
) -> torch.Tensor:
    """`render_bitmaps_cuda_pts` through the split variant of the tile
    kernel (counterpart of ``render_acc`` in the JAX package's
    ``scripts/kernel_ab.py``): ``split`` threads a pixel, each over every
    ``split``-th staged segment, reduced once a tile. The same function,
    so the same bytes and, on the CPU, the same plain version. pts f32."""
    _check(pts, mask_words, tmeta, TP)
    if split not in (1, 2, 4, 8, 16, 32) or TP * split > 1024:
        raise ValueError(f"split={split} must be a power of two with TP·split ≤ 1024 (TP={TP})")
    if pts.device.type == "cpu":
        return render_tiles_pts(pts, mask_words, tmeta, TP)
    _check_cuda_lanes(pts, mask_words, tmeta)
    return launch_tiles_pts_acc(pts, mask_words, tmeta, TP, split)


def launch_tiles_pts_acc(pts, mask_words, tmeta, TP: int, split: int = ACC_SPLIT) -> torch.Tensor:
    """The split tile kernel on inputs the caller has checked (see
    `render_bitmaps_cuda_pts_acc`): allocate the output and launch."""
    N, T = pts.shape[1], tmeta.shape[1]
    out = torch.empty((T, TP), dtype=torch.uint8, device=pts.device)
    if T:
        _launch(
            "sdf_tiles_pts_acc", pts.device, pts.data_ptr(), N, mask_words.data_ptr(),
            tmeta.data_ptr(), T, TP, split, 256.0 / SDF_RADIUS, CUTOFF, out.data_ptr(),
        )
    return out


def alu_roof_ops(T: int, TP: int, n_chunk: int) -> int:
    """The f32 operations one `alu_roof_cuda` launch executes (every
    chain counted; the one add a chunk that advances x is left out)."""
    return T * TP * n_chunk * ALU_ROOF_CHAINS * 3 * ALU_ROOF_TRIPLES


def alu_roof_cuda(T: int, TP: int, n_chunk: int, device, fused: bool = False) -> torch.Tensor:
    """The synthetic ALU roof on the tile kernel's launch shape
    (counterpart of the ``roof`` call in the JAX package's
    ``scripts/roofline.py``): [T, TP] f32, the recurrence of
    `sdf_torch.alu_roof` after ``n_chunk`` chunks. ``device`` decides:
    the kernel on a CUDA device, the plain version on the CPU.
    ``fused`` runs the recurrence with a fused multiply-add (a rate
    reading only: other bits, no plain version)."""
    device = torch.device(device)
    if TP % 32 or not 32 <= TP <= 1024:
        raise ValueError(f"TP={TP} must be a multiple of 32 in [32, 1024]")
    if T < 0 or n_chunk < 0:
        raise ValueError(f"T={T} and n_chunk={n_chunk} must not be negative")
    if device.type == "cpu":
        if fused:
            raise ValueError("the fused ALU roof has no plain version")
        return alu_roof(T, TP, n_chunk, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((T, TP), dtype=torch.float32, device=device)
    if T:
        # spread = 0.25: the extra chains start apart from chain 0.
        _launch("alu_roof", device, T, TP, n_chunk, 0.25, int(fused), out.data_ptr())
    return out


def render_bitmaps_cuda_delta(
    deltas: torch.Tensor,
    mask_words: torch.Tensor,
    anchors: torch.Tensor,
    meta: torch.Tensor,
    TP: int = 256,
    *,
    T_pad: int,
    checked: bool = False,
) -> torch.Tensor:
    """Render over the i8-delta wire (counterpart of
    `sdf_pallas.render_bitmaps_pallas_delta`): decode, dequantize,
    derive the [8, T_pad] tile table from meta [G, 8], then the tile
    kernel. Inputs are the `render.batch.pack_points_delta` arrays.
    ``checked`` as in `render_bitmaps_cuda_pts` (meta's runs and the
    anchors' lanes checked on the host)."""
    pts = dequantize(reconstruct_delta(deltas, anchors))
    tmeta = derive_tmeta(meta, TP, T_pad)
    return render_bitmaps_cuda_pts(pts, mask_words, tmeta, TP, checked=checked)


def min_field_cuda_pts(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256
):
    """Min-distance residuals over the point-chain layout (counterpart
    of `sdf_pallas.min_field_pallas_pts`): (d2 [T, TP] f32, wn [T, TP]
    i32, am [T, TP] i32 first-argmin lane, 2³¹−1 where no segment is
    live); skip rows are 0. Inputs as `render_bitmaps_cuda_pts`, pts
    f32 only (the fitting path's live parameters)."""
    _check(pts, mask_words, tmeta, TP)
    if pts.device.type == "cpu":
        return min_field_pts(pts, mask_words, tmeta, TP)
    _check_cuda_lanes(pts, mask_words, tmeta)
    return launch_min_field_pts(pts, mask_words, tmeta, TP)


def min_field_pixels_per_thread(TP: int, r: int = MIN_FIELD_PIXELS_PER_THREAD) -> int:
    """Pixels a thread of the min-field tile kernel at tile size ``TP``:
    the largest of 1, 2 and 4 that is at most ``r`` and leaves a block
    of whole warps (TP a multiple of 32 times it)."""
    if r not in (1, 2, 4):
        raise ValueError(f"r={r} must be 1, 2 or 4")
    while TP % (32 * r):
        r //= 2
    return r


def launch_min_field_pts(pts, mask_words, tmeta, TP: int, r: int | None = None):
    """The min-field kernel on inputs the caller has checked (see
    `min_field_cuda_pts`): allocate the outputs and launch, a block of
    TP / r threads a tile (``r`` pixels a thread: 1, 2 or 4 with TP a
    multiple of 32·r; None: `min_field_pixels_per_thread`)."""
    N, T = pts.shape[1], tmeta.shape[1]
    d2 = torch.empty((T, TP), dtype=torch.float32, device=pts.device)
    wn = torch.empty((T, TP), dtype=torch.int32, device=pts.device)
    am = torch.empty((T, TP), dtype=torch.int32, device=pts.device)
    if T:
        _launch(
            "sdf_min_field_pts", pts.device, pts.data_ptr(), N, mask_words.data_ptr(),
            tmeta.data_ptr(), T, TP, r or min_field_pixels_per_thread(TP), d2.data_ptr(),
            wn.data_ptr(), am.data_ptr(),
        )
    return d2, wn, am


def _bad_glyph_rows(tmeta, N: int, TP: int) -> torch.Tensor:
    """Rows the backward kernel cannot take: a live row (pix_base < w·h)
    with its lanes out of bounds, a negative pix_base, or not in a run
    of consecutive rows of one glyph with pix_base 0, TP, 2·TP, …"""
    base = tmeta[6]
    npix = tmeta[2] * tmeta[3]
    live = base < npix
    same = (tmeta[:6, 1:] == tmeta[:6, :-1]).all(0) & (base[1:] == base[:-1] + TP)
    no = torch.zeros(1, dtype=torch.bool, device=tmeta.device)
    has_prev = torch.cat([no, same])
    has_next = torch.cat([same, no])
    broken = ((base > 0) & ~has_prev) | ((base + TP < npix) & ~has_next)
    return live & (_lanes_out_of_bounds(tmeta, N) | (base < 0) | broken)


def check_flat_plan(N: int, mask_words, tmeta, TP: int) -> None:
    """Both launch checks of the flat fitting pair, `min_field_cuda_pts`'s
    and `min_field_bwd_cuda`'s, on a static plan (mask words and tile
    table on one device) for a point chain of ``N`` lanes: what a
    caller runs once before it steps through `launch_min_field_pts` and
    `launch_min_field_bwd` (one host sync for a plan on the card)."""
    _check_plan_shapes(N, mask_words, tmeta, TP)
    if not (mask_words.is_contiguous() and tmeta.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if not tmeta.shape[1]:
        return
    bad = _lanes_out_of_bounds(tmeta, N).any() | _bad_glyph_rows(tmeta, N, TP).any()
    if bool(bad):
        raise ValueError(
            f"tile table addresses lanes outside [0, {N}) or its rows are not "
            f"consecutive per glyph (TP={TP})"
        )


def min_field_bwd_cuda(
    pts: torch.Tensor,
    am: torch.Tensor,
    ct_d2: torch.Tensor,
    tmeta: torch.Tensor,
    TP: int = 256,
) -> torch.Tensor:
    """Backward reduction of the min field (counterpart of
    `sdf_grad._min_field_bwd_pallas`): dpts [2, N] f32 from the argmin
    lanes am [T, TP] i32 and the cotangent of d², ct_d2 [T, TP] f32. A
    pixel counts if it is below w·h and its am is a segment lane of its
    row's run; the sentinel 2³¹−1 adds nothing.

    The kernel is deterministic (no atomics): each lane's sum is taken
    in pixel order, the bits of `sdf_torch.min_field_bwd_pts_ordered`.
    It needs each glyph's tile rows to be consecutive and glyph lane
    runs to be disjoint, as `models.fitting.build_flat_plan` lays them
    out; the first is checked."""
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[0] != 2:
        raise ValueError(f"pts must be [2, N] float32, got {tuple(pts.shape)} {pts.dtype}")
    _check_tmeta(tmeta, TP)
    T = tmeta.shape[1]
    if am.dtype != torch.int32 or tuple(am.shape) != (T, TP):
        raise ValueError(f"am must be [{T}, {TP}] int32, got {tuple(am.shape)} {am.dtype}")
    if ct_d2.dtype != torch.float32 or tuple(ct_d2.shape) != (T, TP):
        raise ValueError(
            f"ct_d2 must be [{T}, {TP}] float32, got {tuple(ct_d2.shape)} {ct_d2.dtype}"
        )
    if not (pts.device == am.device == ct_d2.device == tmeta.device):
        raise ValueError("pts, am, ct_d2 and tmeta must be on one device")
    if pts.device.type == "cpu":
        return min_field_bwd_pts(pts, am, ct_d2, tmeta, TP)
    _cuda_inputs(pts, am, ct_d2, tmeta)
    N = pts.shape[1]
    if T and bool(_bad_glyph_rows(tmeta, N, TP).any()):
        raise ValueError(
            "tile table rows out of bounds or not consecutive per glyph "
            f"(N={N}, TP={TP})"
        )
    return launch_min_field_bwd(pts, am, ct_d2, tmeta, TP)


def flat_bwd_launch_shape(threads: int = FLAT_BWD_THREADS, lanes: int | None = None
                          ) -> tuple[int, int]:
    """(threads a block, segment lanes a pass) of the flat backward
    kernel: a warp a tile-table row, and ``lanes`` a pass (None: as many
    as ``FLAT_BWD_SMEM`` holds for the block's warps, 384 at 256 threads;
    a glyph of more segment lanes is walked once a pass)."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads={threads} must be a multiple of 32 in [32, 1024]")
    most = FLAT_BWD_SMEM // (16 * (threads // 32))
    if lanes is not None and not 1 <= lanes <= most:
        raise ValueError(f"lanes={lanes} must be in [1, {most}] at {threads} threads a block")
    return threads, lanes or most


def launch_min_field_bwd(pts, am, ct_d2, tmeta, TP: int, shape=None) -> torch.Tensor:
    """The backward kernel on inputs the caller has checked (see
    `min_field_bwd_cuda`): zero the output and launch. ``shape``:
    (threads a block, segment lanes a pass); None:
    `flat_bwd_launch_shape`."""
    N, T = pts.shape[1], tmeta.shape[1]
    dpts = torch.zeros((2, N), dtype=torch.float32, device=pts.device)
    if T:
        _launch(
            "sdf_min_field_bwd", pts.device, pts.data_ptr(), N, am.data_ptr(),
            ct_d2.data_ptr(), tmeta.data_ptr(), T, TP, *(shape or flat_bwd_launch_shape()),
            dpts.data_ptr(),
        )
    return dpts


def _padded_inputs(segs, mask, meta, P: int):
    """Check the padded pair's segments, mask, meta and P; returns mask
    as f32 and meta as [B, 4] i32, both contiguous."""
    if segs.dtype != torch.float32 or segs.dim() != 3 or segs.shape[2] != 4:
        raise ValueError(f"segs must be [B, S, 4] float32, got {tuple(segs.shape)} {segs.dtype}")
    B, S = segs.shape[:2]
    if mask is not None and tuple(mask.shape) != (B, S):
        raise ValueError(f"mask must be [{B}, {S}], got {tuple(mask.shape)}")
    if meta.dim() != 2 or meta.shape[0] != B or meta.shape[1] < 4:
        raise ValueError(f"meta must be [{B}, >=4], got {tuple(meta.shape)}")
    if not 0 <= P <= MAX_PADDED_PIXELS:
        raise ValueError(
            f"P={P} must be in [0, {MAX_PADDED_PIXELS}] (the TPU kernel's f32 row split "
            "equals integer division only below 2^23)"
        )
    if any(t.device != segs.device for t in (meta, *(() if mask is None else (mask,)))):
        raise ValueError("segs, mask and meta must be on one device")
    mask = None if mask is None else mask.to(torch.float32).contiguous()
    return mask, meta[:, :4].to(torch.int32).contiguous()


def min_field_cuda_padded(segs: torch.Tensor, mask: torch.Tensor, meta: torch.Tensor, P: int):
    """Min-distance residuals on the padded per-glyph layout (counterpart
    of `sdf_grad._run_fwd` without the TPU's paddings): (d2 [B, P] f32,
    wn [B, P] i32, am [B, P] i32 first argmin segment, 2³¹−1 where no
    segment is live).

    segs [B, S, 4] f32 (vx, vy, wx, wy), mask [B, S] (nonzero = live,
    any dtype), meta [B, ≥4] of integral values in any real dtype (x0,
    y0, w, h; cast to i32 as the JAX package casts it), P ≤ 2²³ pixels
    per glyph in flat PBF order."""
    mask, meta = _padded_inputs(segs, mask, meta, P)
    if segs.device.type == "cpu":
        return min_field_padded(segs, mask, meta, P)
    _cuda_inputs(segs, mask, meta)
    return launch_min_field_padded(segs, mask, meta, P)


def padded_launch_shape(
    P: int, threads: int = PADDED_THREADS, r: int = PADDED_PIXELS_PER_THREAD
) -> tuple[int, int, int]:
    """(threads a block, pixels a thread, blocks a glyph) of the padded
    min-field kernel for P ≥ 1 pixels a glyph: a block renders a span of
    ``r`` pixels a thread, ``threads`` threads at most, and the spans of
    a glyph are sized evenly, so a glyph takes the fewest blocks that
    can cover P and each is the whole warps that cover its share (two
    blocks of 128 threads at P = 768). Fewer pixels a thread where P is
    under ``r`` warps. The launcher keeps the defaults; the kernel takes
    any multiple of 32 up to ``PADDED_THREADS_MAX`` and 1 to
    ``PADDED_PIXELS_PER_THREAD_MAX`` pixels, which `tools.kernel_turns`
    times."""
    if threads % 32 or not 32 <= threads <= PADDED_THREADS_MAX:
        raise ValueError(
            f"threads={threads} must be a multiple of 32 in [32, {PADDED_THREADS_MAX}]")
    if not 1 <= r <= PADDED_PIXELS_PER_THREAD_MAX:
        raise ValueError(f"r={r} must be in [1, {PADDED_PIXELS_PER_THREAD_MAX}]")
    blocks = -(-P // (threads * r))
    share = -(-P // blocks)
    r = min(r, -(-share // 32))
    nt = -(-share // (32 * r)) * 32
    r = -(-share // nt)  # no slot of nt pixels that every span leaves empty
    return nt, r, -(-P // (nt * r))


def launch_min_field_padded(segs, mask, meta, P: int):
    """The padded min-field kernel on inputs the caller has checked (see
    `min_field_cuda_padded`: mask f32, meta [B, 4] i32): allocate the
    outputs and launch (`padded_launch_shape`; the grid is the kernel's
    own to derive)."""
    B, S = segs.shape[:2]
    d2 = torch.empty((B, P), dtype=torch.float32, device=segs.device)
    wn = torch.empty((B, P), dtype=torch.int32, device=segs.device)
    am = torch.empty((B, P), dtype=torch.int32, device=segs.device)
    if B and P:
        nt, r, _ = padded_launch_shape(P)
        _launch(
            "sdf_min_field_padded", segs.device, segs.data_ptr(), mask.data_ptr(), B, S,
            meta.data_ptr(), P, nt, r, d2.data_ptr(), wn.data_ptr(), am.data_ptr(),
        )
    return d2, wn, am


def min_field_padded_bwd_cuda(
    segs: torch.Tensor, meta: torch.Tensor, am: torch.Tensor, ct_d2: torch.Tensor
) -> torch.Tensor:
    """Backward of the padded min field (counterpart of
    `sdf_grad._run_bwd` without the TPU's lane padding): dsegs [B, S, 4]
    f32 (dvx, dvy, dwx, dwy) from the argmin segments am [B, P] i32 and
    the cotangent of d², ct_d2 [B, P] f32. An am outside [0, S) (the
    sentinel 2³¹−1) adds nothing. The kernel is deterministic (no
    atomics): while one warp walks a glyph (`padded_bwd_launch_shape`)
    each segment's sum is taken in pixel order, the bits of
    `sdf_torch.min_field_padded_bwd_ordered`."""
    P = am.shape[1] if am.dim() == 2 else -1
    _, meta = _padded_inputs(segs, None, meta, max(P, 0))
    B = segs.shape[0]
    if am.dtype != torch.int32 or tuple(am.shape) != (B, P):
        raise ValueError(f"am must be [{B}, P] int32, got {tuple(am.shape)} {am.dtype}")
    if ct_d2.dtype != torch.float32 or tuple(ct_d2.shape) != (B, P):
        raise ValueError(
            f"ct_d2 must be [{B}, {P}] float32, got {tuple(ct_d2.shape)} {ct_d2.dtype}"
        )
    if not (segs.device == am.device == ct_d2.device):
        raise ValueError("segs, meta, am and ct_d2 must be on one device")
    if segs.device.type == "cpu":
        return min_field_padded_bwd(segs, meta, am, ct_d2)
    _cuda_inputs(segs, meta, am, ct_d2)
    if segs.data_ptr() % 16:
        raise ValueError("segs must be 16-byte aligned (the kernel loads a segment at once)")
    return launch_min_field_padded_bwd(segs, meta, am, ct_d2)


def padded_bwd_launch_shape(
    S: int, P: int, threads: int = PADDED_BWD_THREADS, warps: int | None = None
) -> tuple[int, int, int]:
    """(threads a block, warps a glyph, segments a pass) of the padded
    backward kernel for S ≥ 1 segments and P pixels a glyph. A block is
    ``threads`` threads; a glyph takes ``warps`` of its warps, each a
    contiguous range of the glyph's pixels (None: one warp while a glyph
    has at most ``PADDED_BWD_WARP_PIXELS`` pixels, which keeps each
    segment's sum in pixel order, else the fewest warps that divide the
    block's and leave a warp at most that many pixels, up to the whole
    block). A warp's accumulators take 16 bytes a segment; a pass covers
    as many of the S segments as ``PADDED_BWD_SMEM`` holds for the
    block's warps, and a glyph of more is walked once a pass."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads={threads} must be a multiple of 32 in [32, 1024]")
    n_warps = threads // 32
    if warps is None:
        fits = [w for w in range(1, n_warps + 1)
                if n_warps % w == 0 and -(-P // w) <= PADDED_BWD_WARP_PIXELS]
        warps = fits[0] if fits else n_warps
    if warps < 1 or n_warps % warps:
        raise ValueError(f"warps={warps} must divide the block's {n_warps} warps")
    return threads, warps, max(1, min(S, PADDED_BWD_SMEM // (16 * n_warps)))


def launch_min_field_padded_bwd(segs, meta, am, ct_d2, shape=None) -> torch.Tensor:
    """The padded backward kernel on inputs the caller has checked (see
    `min_field_padded_bwd_cuda`: meta [B, 4] i32): allocate the output
    (the kernel writes all of it) and launch. ``shape``: (threads a
    block, warps a glyph, segments a pass); None:
    `padded_bwd_launch_shape`."""
    B, S = segs.shape[:2]
    P = am.shape[1]
    dsegs = torch.empty((B, S, 4), dtype=torch.float32, device=segs.device)
    if B and S:
        _launch(
            "sdf_min_field_padded_bwd", segs.device, segs.data_ptr(), B, S, meta.data_ptr(),
            am.data_ptr(), ct_d2.data_ptr(), P, *(shape or padded_bwd_launch_shape(S, P)),
            dsegs.data_ptr(),
        )
    return dsegs
