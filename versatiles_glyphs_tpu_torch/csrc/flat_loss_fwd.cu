// Loss forward of the fused flat-fit loss, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the signed field
// and the loss around its min-field kernel with XLA ops
// (`ops/sdf_grad._signed_field_flat_tpu_fwd`, the row_map gather and
// `models/glyph_model.sdf_loss`). In the port those were some twenty
// PyTorch ops a step over a [B, P_pad] copy of the field; this kernel
// reads the min-field kernel's d^2 and winding where that kernel wrote
// them, in the tile layout, and writes each glyph's loss.
//
// One block of kThreads threads a glyph. The glyph's w*h live pixels are
// the first w*h slots of its consecutive tile rows (from tile0 * TP), and
// the target was laid out once in the same tile layout, so a pixel i < w*h
// is read at tile0 * TP + i; pixels past w*h are never read (the loss's
// pixel mask). Thread t sums the terms of pixels t, t + kThreads, ...
// in order (vgl::pixel_terms: sd = sgn * sqrt(max(d^2, 1e-12)), pred =
// sd * exp(log_gain), diff = clip(pred) - clip(target), term diff^2),
// the block adds the partials in a fixed order (vgl::block_sum), and
// loss_g = sum / max(w*h, 1).
//
// Bound: bytes, 12 a live pixel (d^2, winding, target) and 4 a glyph.

#include <cstdint>

#include <cuda_runtime.h>

#include "flat_loss.cuh"

namespace {

__global__ void __launch_bounds__(vgl::kThreads) flat_loss_fwd_kernel(
    const float* __restrict__ d2, const int32_t* __restrict__ wn,
    const float* __restrict__ target, const int32_t* __restrict__ glyph_rows,
    const float* __restrict__ log_gain, int tp, float* __restrict__ loss) {
  __shared__ float sh[vgl::kThreads];
  const int g = blockIdx.x;
  const vgl::GlyphRow G = vgl::load_glyph(glyph_rows, g);
  const float gain = vgl::gain_of(log_gain);
  const size_t base = static_cast<size_t>(G.tile0) * tp;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < G.npix; i += vgl::kThreads) {
    const vgl::Pixel p = vgl::pixel_terms(d2[base + i], wn[base + i], target[base + i], gain);
    acc = __fadd_rn(acc, __fmul_rn(p.diff, p.diff));
  }
  const float sum = vgl::block_sum(acc, sh);
  if (threadIdx.x == 0) loss[g] = __fdiv_rn(sum, static_cast<float>(G.npix > 1 ? G.npix : 1));
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Device pointers: d2 f32 and wn i32 [n_rows, tp]
// (the min-field kernel's outputs), target [n_rows, tp] f32 in the same
// tile layout, glyph_rows [n_glyphs, 4] i32 (tile0, w*h, lane0, npts),
// log_gain [] f32, and the output loss [n_glyphs] f32. The caller checks
// shapes and that each glyph's rows lie in the table.
extern "C" int vg_flat_loss_fwd(const void* d2, const void* wn, const void* target,
                                const void* glyph_rows, int n_glyphs, const void* log_gain,
                                int tp, void* loss, void* stream) {
  if (n_glyphs == 0) return 0;
  if (n_glyphs < 0 || tp < 1) return static_cast<int>(cudaErrorInvalidValue);
  flat_loss_fwd_kernel<<<n_glyphs, vgl::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<const int32_t*>(wn),
      static_cast<const float*>(target), static_cast<const int32_t*>(glyph_rows),
      static_cast<const float*>(log_gain), tp, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}
