"""Graft entry points of the PyTorch/CUDA port (counterpart of
`__graft_entry__.py`): a one-device render check and a dry run over
several devices.

- `entry()` returns a batched SDF render and example arguments: on a
  CUDA device the main path's render (the i8-delta wire decoded on the
  device, the tile table derived there, the tile kernel); without one
  the plain PyTorch version of the padded-grid render, as the JAX entry
  takes its jnp twin off the TPU.
- `dryrun_multichip(n)` shards one fitting step of each gradient
  backend over ``n`` devices in one process (the glyph batch split, the
  shared gain's gradient summed over the shards) and renders a
  synthesized font through `FontManager.render_glyphs` over the same
  devices, against the one-device render byte for byte.

Both import torch and the port (`versatiles_glyphs_tpu_torch`), never
JAX or the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _square_rings(lo: float, hi: float):
    return [np.array([(lo, lo), (hi, lo), (hi, hi), (lo, hi), (lo, lo)], dtype=np.float64) * 40.0]


def _example_batch():
    """A tiny packed glyph batch on the flat segment layout: two square
    glyphs (`render.batch.pack_flat`)."""
    from versatiles_glyphs_tpu_torch.render.batch import pack_flat
    from versatiles_glyphs_tpu_torch.render.metrics import GlyphPrep

    def square_prep(cp, lo, hi):
        ring = np.array([(lo, lo), (hi, lo), (hi, hi), (lo, hi), (lo, lo)], dtype=np.float64)
        segs = np.concatenate([ring[:-1], ring[1:]], axis=1)
        return GlyphPrep(codepoint=cp, advance=10, empty=False, width=16, height=16,
                         x0=-2, y0=-2, x1=14, y1=14, segments=segs)

    return pack_flat([square_prep(65, 1.0, 5.0), square_prep(66, 2.0, 9.0)])


def entry():
    """(fn, example_args): ``fn(*example_args)`` renders a batch of two
    square glyphs to uint8 SDF bytes.

    On a CUDA device, the main path's render:
    `ops.sdf_cuda.render_bitmaps_cuda_delta` (i8-delta wire of
    `render.batch.pack_points_delta`, meta padded to [32, 8], TP = 256,
    T_pad = 256) on tensors on the first CUDA device; it returns
    [T_pad, 256] bytes, one row a pixel tile. Without one,
    `ops.sdf_torch.render_grid_flat` over `render.batch.pack_flat` on
    CPU tensors, [2, P] bytes: the plain version of the padded-grid
    kernel, as the JAX entry returns its jnp twin off the TPU. It writes
    zeros on pixel tiles past a glyph's w·h, where that twin computes
    them."""
    if torch.cuda.is_available():
        from versatiles_glyphs_tpu_torch.device import cuda_device
        from versatiles_glyphs_tpu_torch.ops.sdf_cuda import render_bitmaps_cuda_delta
        from versatiles_glyphs_tpu_torch.render.batch import pack_points_delta
        from versatiles_glyphs_tpu_torch.render.metrics import prepare_glyph

        preps = [
            prepare_glyph(65, _square_rings(1.0, 5.0), 1000, 500),
            prepare_glyph(66, _square_rings(2.0, 9.0), 1000, 600),
        ]
        deltas, words, anchors, meta = pack_points_delta(preps)
        meta_p = np.zeros((32, 8), np.int32)
        meta_p[: len(preps)] = meta[: len(preps)]
        dev = cuda_device()
        # torch.tensor copies: the packer's arrays are reused buffers.
        args = tuple(torch.tensor(a, device=dev) for a in (deltas, words, anchors, meta_p))
        return functools.partial(render_bitmaps_cuda_delta, TP=256, T_pad=256), args

    from versatiles_glyphs_tpu_torch.ops.sdf_torch import render_grid_flat

    flat, meta, P = _example_batch()
    fn = functools.partial(render_grid_flat, P=P, TP=min(1024, P))
    return fn, (torch.tensor(flat), torch.tensor(meta))


def _tiny_fit_batch(B: int):
    """The JAX dry run's batch: B glyphs of four line cubics (a square)
    with seeded noise, 256 pixels each, zero targets."""
    from versatiles_glyphs_tpu_torch.models.fitting import FitBatch

    rng = np.random.default_rng(0)
    pts = np.array([(1, 2), (5, 2), (5, 6), (1, 6)], dtype=np.float32)
    curves = np.zeros((4, 4, 2), np.float32)
    for i in range(4):
        s, e = pts[i], pts[(i + 1) % 4]
        curves[i] = [s, s + (e - s) / 3, s + 2 * (e - s) / 3, e]
    curves0 = np.tile(curves, (B, 1, 1, 1))
    curves0 += rng.normal(0, 0.1, curves0.shape).astype(np.float32)
    P = 256
    i = np.arange(P)
    x = (i % 16).astype(np.float32)
    y = (15 - i // 16).astype(np.float32)
    return FitBatch(
        curves0=curves0,
        curve_mask=np.ones((B, 4), bool),
        px=np.tile((-2 + x + 0.5)[None], (B, 1)),
        py=np.tile((-1 + y + 0.5)[None], (B, 1)),
        pix_mask=np.ones((B, P), np.float32),
        target=np.zeros((B, P), np.float32),
    )


class _CaptureWriter:
    """What a writer receives, in memory: every file's name and bytes
    (the JAX dry run's `DummyWriter` keeps only their lengths)."""

    def __init__(self):
        self.files: list[tuple[str, bytes]] = []

    def write_file(self, file_name: str, data: bytes) -> None:
        self.files.append((file_name, bytes(data)))

    def write_directory(self, dir_name: str) -> None:
        self.files.append((dir_name, b""))

    def finish(self) -> None:
        pass


def dryrun_multichip(n_devices: int) -> dict:
    """One sharded fitting step of each backend over ``n_devices``
    devices (tiny shapes), and the production render over them against
    one device. The devices are `parallel.mesh.local_devices`: the
    first ``n_devices`` CUDA devices, the first listed ``n_devices``
    times where fewer are visible (the JAX dry run falls back to virtual
    CPU devices there); without a card, the CPU listed ``n_devices``
    times. Raises on a non-finite loss or a render that differs from the
    one-device render. Returns the devices, both losses and the
    render's byte count."""
    import dataclasses

    from versatiles_glyphs_tpu_torch.font.manager import FontManager
    from versatiles_glyphs_tpu_torch.font.names import name_to_id
    from versatiles_glyphs_tpu_torch.font.wrapper import FontWrapper
    from versatiles_glyphs_tpu_torch.models.fitting import FontFitter
    from versatiles_glyphs_tpu_torch.parallel import mesh
    from versatiles_glyphs_tpu_torch.render.driver import Renderer
    from versatiles_glyphs_tpu_torch.utils.synth_font import SynthEntry

    if torch.cuda.is_available():
        devices = mesh.local_devices(n_devices)
        if len(devices) < n_devices:
            devices = [devices[0]] * n_devices
    else:
        devices = mesh.local_devices(n_devices, "cpu")

    # The torch backend: autograd of the pair-tensor model on each shard.
    batch = _tiny_fit_batch(2 * n_devices)
    fitter = FontFitter(devices=devices, depth=2, learning_rate=0.01)
    params, opt, shards = fitter.init(batch)
    _, _, loss = fitter.step(params, opt, shards)
    loss_torch = float(loss)
    if not np.isfinite(loss_torch):
        raise RuntimeError(f"non-finite sharded loss {loss_torch}")

    # The flat backend: the min-field kernel pair once a shard.
    batch_k = dataclasses.replace(
        batch, meta=np.tile(np.array([[-2, -1, 16, 16]], np.int32), (batch.curves0.shape[0], 1))
    )
    fitter_k = FontFitter(devices=devices, depth=2, learning_rate=0.01, backend="flat")
    params_k, opt_k, shards_k = fitter_k.init(batch_k)
    _, _, loss_k = fitter_k.step(params_k, opt_k, shards_k)
    loss_flat = float(loss_k)
    if not np.isfinite(loss_flat):
        raise RuntimeError(f"non-finite sharded flat loss {loss_flat}")

    # The production render over the same devices: `FontManager.render_glyphs`
    # (prep, the session's several-device path, PBF encode) on a
    # synthesized font, against the one-device run byte for byte.
    backend = "cuda" if devices[0].type == "cuda" else "torch"
    entry_ = SynthEntry(4 * n_devices, 65, seed=0)
    real_data_devices = mesh.data_devices
    mesh.data_devices = lambda *a, **kw: devices  # pin the dry run's devices
    try:
        captures = {}
        for parallel in (True, False):
            manager = FontManager(parallel=parallel)
            fid = name_to_id(entry_.metadata.generate_name())
            manager.fonts[fid] = FontWrapper()
            manager.fonts[fid].add_file(entry_)
            writer = _CaptureWriter()
            manager.render_glyphs(writer, Renderer(backend))
            captures[parallel] = writer.files
    finally:
        mesh.data_devices = real_data_devices
    if captures[True] != captures[False]:
        raise RuntimeError("the render over several devices differs from the one-device render")
    return {
        "devices": [str(d) for d in devices],
        "loss_torch": loss_torch,
        "loss_flat": loss_flat,
        "render_bytes": sum(len(data) for _, data in captures[True]),
    }
