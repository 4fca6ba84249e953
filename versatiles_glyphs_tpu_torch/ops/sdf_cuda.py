"""Kernel wrappers of the atlas render path (counterpart of
`versatiles_glyphs_tpu.ops.sdf_pallas`).

`render_bitmaps_cuda_pts` and `render_bitmaps_cuda_delta` take the
packed wire as tensors. On CUDA tensors they launch the hand-written
kernel ``csrc/sdf_tiles_pts.cu`` on the current stream; on CPU tensors
they run its plain version, `ops.sdf_torch.render_tiles_pts`. There is
no fallback from one to the other: a CUDA launch that fails raises.

The i8-delta decode, the dequantize and the tile table (the XLA
prepass steps of the TPU path) are plain PyTorch ops on the tensor's
device. The TPU prepass's chunk-row restructuring has no counterpart:
the kernel reads the flat point chain and the mask bits directly.

``LAUNCHES`` counts the kernel's launches since `reset_launches`.
"""

from __future__ import annotations

import ctypes

import torch

from versatiles_glyphs_tpu.constants import CUTOFF, SDF_RADIUS

from . import _build
from .sdf_torch import dequantize, derive_tmeta, reconstruct_delta, render_tiles_pts

KERNEL = "sdf_tiles_pts"
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.vg_sdf_tiles_pts
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, P, P, I, I, F, F, P, P]
        fn.restype = ctypes.c_int
    return lib


def _check(pts, mask_words, tmeta, TP: int) -> None:
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[0] != 2:
        raise ValueError(f"pts must be [2, N] float32, got {tuple(pts.shape)} {pts.dtype}")
    N = pts.shape[1]
    if N % 32 or mask_words.dtype != torch.int32 or tuple(mask_words.shape) != (N // 32,):
        raise ValueError(
            f"mask_words must be [{N // 32}] int32 for N={N} (a multiple of 32), "
            f"got {tuple(mask_words.shape)} {mask_words.dtype}"
        )
    if tmeta.dtype != torch.int32 or tmeta.dim() != 2 or tmeta.shape[0] != 8:
        raise ValueError(f"tmeta must be [8, T] int32, got {tuple(tmeta.shape)} {tmeta.dtype}")
    if TP % 32 or not 32 <= TP <= 1024:
        raise ValueError(f"TP={TP} must be a multiple of 32 in [32, 1024]")
    if not (pts.device == mask_words.device == tmeta.device):
        raise ValueError("pts, mask_words and tmeta must be on one device")


def _launch(pts, mask_words, tmeta, TP: int) -> torch.Tensor:
    global LAUNCHES
    if not (pts.is_contiguous() and mask_words.is_contiguous() and tmeta.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    N = pts.shape[1]
    T = tmeta.shape[1]
    if T and bool(((tmeta[5] < 0) | (tmeta[4] < 0) | (tmeta[5] + tmeta[4] > N)).any()):
        raise ValueError(f"tile table addresses lanes outside [0, {N})")
    out = torch.empty((T, TP), dtype=torch.uint8, device=pts.device)
    if T == 0:
        return out
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _lib().vg_sdf_tiles_pts(
            pts.data_ptr(), N, mask_words.data_ptr(), tmeta.data_ptr(), T, TP,
            256.0 / SDF_RADIUS, CUTOFF, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def render_bitmaps_cuda_pts(
    pts: torch.Tensor, mask_words: torch.Tensor, tmeta: torch.Tensor, TP: int = 256
) -> torch.Tensor:
    """Quantized uint8 bitmaps [T, TP] over the point-chain layout
    (counterpart of `sdf_pallas.render_bitmaps_pallas_pts`).

    pts: [2, N] f32, or i16 q16 fixed point (dequantized first);
    mask_words: [N//32] i32; tmeta: [8, T] i32 (`render.batch.plan_tiles`
    transposed)."""
    if pts.dtype == torch.int16:
        pts = dequantize(pts)
    _check(pts, mask_words, tmeta, TP)
    if pts.device.type == "cpu":
        return render_tiles_pts(pts, mask_words, tmeta, TP)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    return _launch(pts, mask_words, tmeta, TP)


def render_bitmaps_cuda_delta(
    deltas: torch.Tensor,
    mask_words: torch.Tensor,
    anchors: torch.Tensor,
    meta: torch.Tensor,
    TP: int = 256,
    *,
    T_pad: int,
) -> torch.Tensor:
    """Render over the i8-delta wire (counterpart of
    `sdf_pallas.render_bitmaps_pallas_delta`): decode, dequantize,
    derive the [8, T_pad] tile table from meta [G, 8], then the tile
    kernel. Inputs are the `render.batch.pack_points_delta` arrays."""
    pts = dequantize(reconstruct_delta(deltas, anchors))
    tmeta = derive_tmeta(meta, TP, T_pad)
    return render_bitmaps_cuda_pts(pts, mask_words, tmeta, TP)
