"""versatiles_glyphs_tpu_torch — the atlas render path on PyTorch and CUDA.

A port of `versatiles_glyphs_tpu` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``). The JAX
package stays the reference every module here is held against. This
package imports `torch` and never `jax`.

Reused by import from `versatiles_glyphs_tpu` (free of JAX, so byte
parity of metrics, PBF and tar holds by construction):

- ``font.{entry, wrapper, block, index_files, names}``
- ``render.metrics``
- ``proto.{pbf, native}``
- ``writer``
- ``ops.{flatten, sdf_ref}``
- ``utils.{arena, progress, output_dir, synth_font}``
- ``constants``

A module has a counterpart here only where its import chain or call
path reaches JAX.

Layers, from the entry point down to the device:

- ``cli``             — recurse / merge / debug (``--renderer cuda``)
- ``font.manager``    — the JAX package's scheduler, single-process
- ``render.driver``   — `Renderer` backends and the `RenderSession`
                        that packs glyph groups and dispatches them
- ``render.batch``    — the point-chain and i8-delta packers, and
                        `wire_to_device`
- ``ops.sdf_cuda``    — kernel wrappers with the launch counter
- ``ops.sdf_torch``   — plain PyTorch versions of every device op
- ``ops._build``      — nvcc build of ``csrc/*.cu``, loaded by ctypes
- ``csrc/sdf_tiles_pts.cu`` — the per-pixel SDF tile kernel
- ``device``          — the CUDA device predicate (no CPU fallback)
"""

__version__ = "0.1.0"
