"""versatiles_glyphs_tpu_torch — the atlas render and outline-fitting
paths on PyTorch and CUDA.

A port of `versatiles_glyphs_tpu` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``). The JAX
package stays the reference every module here is held against. This
package imports `torch` and never `jax`, and no optax or orbax; it
reads fonts without fontTools (`font.sfnt` and the native parsers),
which it imports only for the few fonts they do not cover.

The package stands alone: it imports nothing of `versatiles_glyphs_tpu`.
The host modules that are free of JAX there (f64 metrics and q16 chains,
PBF and tar encoders, the native C++ runtime, the font parser, the
exact renderer) have their own copies here under the same names, so the
trees mirror each other and the tests hold each copy against its
original byte for byte.

Layers, from the entry points down to the device:

- ``cli``                   — recurse / merge / debug (``--renderer
                              cuda``) and fit (``--backend {torch,flat}``,
                              ``--device``, ``--resume``, ``--render``)
- ``tools.{roofline,kernel_ab}`` — measurement entry points on the card:
                              the tile kernel against the measured ALU
                              and copy roofs, and against its split
                              variant
- ``tools.session_turns``   — warm renders through the render session,
                              in turns against another checkout's
- ``font.manager``          — the render scheduler; across processes,
                              each renders its share of the blocks
- ``parallel.mesh``         — the local devices a batch is dealt over,
                              and the processes of a run
                              (`torch.distributed`) with their partition
- ``font.{sfnt,entry,pens,wrapper,block,names,index_files}`` — the
                              font parser (sfnt directory, name table;
                              fontTools pens only for its fallback),
                              font stacks, 256-codepoint
                              blocks, names and the index files
- ``models.fitting``        — `FontFitter` (`ops.adam.adam_step` on a
                              `torch.optim.Adam`, torch checkpoints), the
                              flat plan, the Bernstein point chain, the
                              batches, the carry of JAX parameters and
                              optax state, and the padded-layout loss
                              `batch_loss_kernel` on its own batch
- ``models.glyph_model``    — the differentiable pair-tensor model (the
                              ``torch`` backend)
- ``models.render_fitted``  — fitted parameters → a glyph atlas
- ``render.driver``         — `Renderer` backends and the `RenderSession`
                              that packs glyph groups and dispatches them
                              over one or several devices
- ``render.metrics``        — `GlyphPrep`: f64 metrics, q16 chains and the
                              font-level prep cores
- ``proto.{pbf,native}``    — the PBF encoder and the native runtime
                              (``csrc/vg_native.cpp``, built with g++ at
                              first use into ``build/native/``)
- ``writer``                — directory, tar and in-memory writers
- ``render.batch``          — the point-chain, i8-delta and flat
                              segment packers, `wire_to_device`, and the
                              session's streams (`DeviceLane`)
- ``ops.sdf_grad``          — `signed_field_flat`, the autograd function
                              over the fitting kernels, `flat_fit_losses`
                              (`FlatFitLoss`), the ``flat`` backend's
                              fused loss, and `signed_field_padded` over
                              the padded pair
- ``ops.flat_loss``         — the fused loss's chain and loss kernels
                              around the fitting pair, their plain
                              versions and the plan's checks
- ``ops.legacy``            — the renders over the flat segment layout
- ``ops.sdf_cuda``          — kernel wrappers with the launch counters
- ``ops.sdf_torch``         — plain PyTorch versions of every device op
- ``ops.{flatten,sdf_ref}`` — curve flattening and the exact f64 renderer
- ``ops._build``            — nvcc build of ``csrc/*.cu``, loaded by ctypes
- ``csrc/sdf_tiles_pts.cu``     — the per-pixel SDF tile kernel (render)
- ``csrc/sdf_min_field_pts.cu`` — min d², winding, first argmin (fit
                                  forward)
- ``csrc/sdf_min_field_bwd.cu`` — the deterministic per-lane gradient
                                  reduction (fit backward)
- ``csrc/sdf_min_field_padded{,_bwd}.cu`` — the padded-layout pair
                                  (min field and its per-segment backward)
- ``csrc/sdf_{tiles,grid}_flat.cu`` — the render over the flat segment
                                  layout, by tile table or padded grid
- ``csrc/sdf_tiles_pts_acc.cu``  — the tile kernel with the segments of a
                                  pixel split over a sub-warp
- ``csrc/alu_roof.cu``          — the synthetic ALU roof on the tile
                                  kernel's launch shape
- ``csrc/sdf_pair.cuh``         — the per-pixel math the kernels share
- ``csrc/flat_{chain,loss}_{fwd,bwd}.cu``, ``csrc/flat_loss.cuh`` — the
                                  fused flat-fit loss around the fitting
                                  pair
- ``device``                — the CUDA device predicate (no CPU fallback)
- ``utils.synth_font``      — synthesized curved fonts, fit batches and
                              entries, with no font file
- ``utils.{arena,progress,output_dir}``, ``constants`` — host helpers
"""

__version__ = "0.1.0"
