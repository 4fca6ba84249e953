"""Render over the flat segment layout (counterparts of
`versatiles_glyphs_tpu.ops.legacy`).

The JAX package keeps two older Pallas render kernels over the segment
soup of `render.batch.pack_flat` (flat [4, N] f32 rows vx, vy, wx, wy,
one segment a lane; each glyph's run starts at an SC-aligned lane):
a single launch over a tile table and a padded [G, P] grid. Here each
is a hand-written kernel on the records and per-row crossing lists of
the point-chain render kernel (``csrc/sdf_pair.cuh``):

- ``sdf_tiles_flat``: `render_bitmaps_cuda_tiles`. The point-chain
  kernel's tile body (a block of TP / R threads a tile row, R pixels a
  thread, `sdf_cuda.pixels_per_thread`) over the glyph's staged soup,
  every lane live;
- ``sdf_grid_flat``: `render_bitmaps_cuda_grid`. A block renders a span
  of four pixels a thread of one glyph (`grid_launch_shape`), stages the
  glyph's segments as 32-byte records and tests a segment's crossing
  once a bitmap row of the span instead of once a pixel.

On CUDA tensors a wrapper launches its kernel; on CPU tensors it runs
the plain version in `ops.sdf_torch`. There is no fallback from one to
the other. Each wrapper checks dtypes, shapes and that every glyph's
lanes lie inside the flat array (one host sync) before it launches;
``launch_*`` is the launch alone. Launches count in
`ops.sdf_cuda.LAUNCHES`.
"""

from __future__ import annotations

import torch

from ..constants import CUTOFF, SDF_RADIUS

from .sdf_cuda import (
    GRID_PIXELS_PER_THREAD,
    GRID_THREADS,
    GRID_THREADS_MAX,
    _check_tmeta,
    _cuda_inputs,
    _lanes_out_of_bounds,
    _launch,
    pixels_per_thread,
)
from .sdf_torch import render_grid_flat, render_tiles_flat


def _check_flat(flat) -> None:
    if flat.dtype != torch.float32 or flat.dim() != 2 or flat.shape[0] != 4:
        raise ValueError(f"flat must be [4, N] float32, got {tuple(flat.shape)} {flat.dtype}")


def _check_cuda_runs(flat, table, rows) -> None:
    """The launch checks: flat and the table contiguous on one CUDA
    device, and every segment run [seg_off, seg_off + nseg) of ``rows``
    (the table as [8, T]) inside [0, N) (one host sync)."""
    _cuda_inputs(flat, table)
    N = flat.shape[1]
    if rows.numel() and bool(_lanes_out_of_bounds(rows, N).any()):
        raise ValueError(f"a glyph's segment run leaves the flat array's lanes [0, {N})")


def render_bitmaps_cuda_tiles(flat: torch.Tensor, tmeta: torch.Tensor, TP: int = 256) -> torch.Tensor:
    """Quantized uint8 bitmaps [T, TP] over a flat tile table
    (counterpart of `legacy.render_bitmaps_pallas_tiles`).

    flat: [4, N] f32 (`render.batch.pack_flat`); tmeta: [8, T] i32
    (`render.batch.plan_tiles` of the pack_flat meta, transposed), rows
    ``x0, y0, w, h, nseg, seg_off, pix_base, _``. A glyph's bitmap is
    the first w·h bytes from its first row. TP: a multiple of 32 in
    [32, 1024] (the TPU needed 128)."""
    _check_flat(flat)
    _check_tmeta(tmeta, TP)
    if flat.device != tmeta.device:
        raise ValueError("flat and tmeta must be on one device")
    if flat.device.type == "cpu":
        return render_tiles_flat(flat, tmeta, TP)
    _check_cuda_runs(flat, tmeta, tmeta)
    return launch_tiles_flat(flat, tmeta, TP)


def launch_tiles_flat(flat, tmeta, TP: int) -> torch.Tensor:
    """The flat tile kernel on inputs the caller has checked (see
    `render_bitmaps_cuda_tiles`): allocate the output and launch, a
    block of TP / `sdf_cuda.pixels_per_thread` threads a tile."""
    N, T = flat.shape[1], tmeta.shape[1]
    out = torch.empty((T, TP), dtype=torch.uint8, device=flat.device)
    if T:
        _launch(
            "sdf_tiles_flat", flat.device, flat.data_ptr(), N, tmeta.data_ptr(), T, TP,
            pixels_per_thread(TP), 256.0 / SDF_RADIUS, CUTOFF, out.data_ptr(),
        )
    return out


def render_bitmaps_cuda_grid(
    flat: torch.Tensor, meta: torch.Tensor, P: int, TP: int = 1024
) -> torch.Tensor:
    """Quantized uint8 bitmaps [G, P] on a padded grid (counterpart of
    `legacy.render_bitmaps_pallas`).

    flat: [4, N] f32 (`render.batch.pack_flat`); meta: [G, 8] i32
    (x0, y0, w, h, nseg, seg_off, _, _); P: pixels per glyph, a multiple
    of TP (`pack_flat`'s P_pad with TP = min(1024, P_pad)); TP: a
    multiple of 32 in [32, 1024]. Tiles at or past w·h are zeros."""
    _check_flat(flat)
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 8:
        raise ValueError(f"meta must be [G, 8] int32, got {tuple(meta.shape)} {meta.dtype}")
    if TP % 32 or not 32 <= TP <= 1024 or P < 0 or P % TP:
        raise ValueError(f"P={P} must be a multiple of TP={TP}, a multiple of 32 in [32, 1024]")
    if flat.device != meta.device:
        raise ValueError("flat and meta must be on one device")
    if flat.device.type == "cpu":
        return render_grid_flat(flat, meta, P, TP)
    _check_cuda_runs(flat, meta, meta.T)
    return launch_grid_flat(flat, meta, P, TP)


def grid_launch_shape(G: int, P: int, threads: int = GRID_THREADS) -> tuple[int, tuple[int, int]]:
    """(threads a block, grid) of the flat grid kernel for G glyphs of P
    pixels (a multiple of 32): a block renders a span of
    ``GRID_PIXELS_PER_THREAD`` pixels a thread of one glyph, so the
    block is the whole warps that cover P at that rate, ``threads`` at
    most, and a glyph takes ceil(P / span) blocks. The launcher keeps
    ``GRID_THREADS``; the kernel takes any multiple of 32 up to
    ``GRID_THREADS_MAX``, which `tools.kernel_turns` times."""
    if threads % 32 or not 32 <= threads <= GRID_THREADS_MAX:
        raise ValueError(f"threads={threads} must be a multiple of 32 in [32, {GRID_THREADS_MAX}]")
    nt = min(threads, max(32, -(-P // (32 * GRID_PIXELS_PER_THREAD)) * 32))
    return nt, (G, -(-P // (nt * GRID_PIXELS_PER_THREAD)))


def launch_grid_flat(flat, meta, P: int, TP: int) -> torch.Tensor:
    """The flat grid kernel on inputs the caller has checked (see
    `render_bitmaps_cuda_grid`): allocate the output and launch
    (`grid_launch_shape`; the grid is the kernel's own to derive)."""
    N, G = flat.shape[1], meta.shape[0]
    out = torch.empty((G, P), dtype=torch.uint8, device=flat.device)
    if G and P:
        nt, _ = grid_launch_shape(G, P)
        _launch(
            "sdf_grid_flat", flat.device, flat.data_ptr(), N, meta.data_ptr(), G, P, TP, nt,
            256.0 / SDF_RADIUS, CUTOFF, out.data_ptr(),
        )
    return out
