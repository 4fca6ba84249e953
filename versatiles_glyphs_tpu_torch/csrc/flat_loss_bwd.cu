// Loss backward of the fused flat-fit loss, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates the loss
// around its min-field kernels with XLA (`jax.grad` of `sdf_loss`, the
// gather's scatter, `_signed_field_flat_tpu_bwd`'s ct * sgn * 0.5 / d).
// In the port those were the autograd of some twenty PyTorch ops a step
// (the index_select's backward among them, which zeroes a [T_pad, TP]
// buffer and adds into it); this kernel writes the cotangent of d^2 that
// the backward min-field kernel (sdf_min_field_bwd.cu) reads, in the
// tile layout, and each glyph's share of log_gain's gradient.
//
// One block of kThreads threads a glyph, over every slot of its tile
// rows. With per = ct_g / max(w*h, 1) (the cotangent of each pixel's
// term of the glyph's mean; ct read at g * ct_stride, so a stride-0
// cotangent, a sum's backward, is read as it is), a live pixel i < w*h
// recomputes the forward's terms (vgl::pixel_terms) and writes
//   dpred = per * (2 * diff) through both clips (vgl::pred_grad: half
//           the gradient at a bound, none beyond),
//   ct_d2 = ((dpred * gain) * sgn) * (0.5 / d),
// and adds dpred * sd to its thread's partial of the gain's gradient;
// a slot past w*h gets 0. The partials are added in a fixed order
// (vgl::block_sum) into gain_part[g]; flat_chain_bwd.cu adds those over
// the glyphs and multiplies by the gain. Block 0 also zeroes the table's
// padding rows past the last glyph's, so every slot of ct_d2 is written.
//
// Bound: bytes, 12 read and 4 written a live pixel, 4 written a dead
// slot, 8 a glyph.

#include <cstdint>

#include <cuda_runtime.h>

#include "flat_loss.cuh"

namespace {

__global__ void __launch_bounds__(vgl::kThreads) flat_loss_bwd_kernel(
    const float* __restrict__ ct, long long ct_stride, const float* __restrict__ d2,
    const int32_t* __restrict__ wn, const float* __restrict__ target,
    const int32_t* __restrict__ glyph_rows, int n_glyphs, const float* __restrict__ log_gain,
    int tp, int n_rows, float* __restrict__ ct_d2, float* __restrict__ gain_part) {
  __shared__ float sh[vgl::kThreads];
  const int g = blockIdx.x;
  const vgl::GlyphRow G = vgl::load_glyph(glyph_rows, g);
  const float gain = vgl::gain_of(log_gain);
  const float per = __fdiv_rn(ct[g * ct_stride], static_cast<float>(G.npix > 1 ? G.npix : 1));
  const size_t base = static_cast<size_t>(G.tile0) * tp;
  const int span = vgl::tiles_of(G.npix, tp) * tp;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < span; i += vgl::kThreads) {
    float out = 0.0f;
    if (i < G.npix) {
      const vgl::Pixel p = vgl::pixel_terms(d2[base + i], wn[base + i], target[base + i], gain);
      const float dpred = vgl::pred_grad(per, p);
      const float dsd = __fmul_rn(dpred, gain);
      out = __fmul_rn(p.inside ? -dsd : dsd, __fdiv_rn(0.5f, p.d));
      acc = __fadd_rn(acc, __fmul_rn(dpred, p.sd));
    }
    ct_d2[base + i] = out;
  }
  const float sum = vgl::block_sum(acc, sh);
  if (threadIdx.x == 0) gain_part[g] = sum;
  if (g == 0) {
    const vgl::GlyphRow L = vgl::load_glyph(glyph_rows, n_glyphs - 1);
    const size_t end = static_cast<size_t>(n_rows) * tp;
    for (size_t i = (static_cast<size_t>(L.tile0) + vgl::tiles_of(L.npix, tp)) * tp +
                    threadIdx.x;
         i < end; i += vgl::kThreads)
      ct_d2[i] = 0.0f;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Device pointers: ct [n_glyphs] f32 at stride
// ct_stride elements (0 for a broadcast cotangent), d2 f32, wn i32 and
// target f32 [n_rows, tp], glyph_rows [n_glyphs, 4] i32 (tile0, w*h,
// lane0, npts; each glyph's rows consecutive, glyphs in row order),
// log_gain [] f32; outputs ct_d2 [n_rows, tp] f32 (every slot written)
// and gain_part [n_glyphs] f32. The caller checks shapes and that the
// glyphs' rows lie in the table.
extern "C" int vg_flat_loss_bwd(const void* ct, long long ct_stride, const void* d2,
                                const void* wn, const void* target, const void* glyph_rows,
                                int n_glyphs, const void* log_gain, int tp, int n_rows,
                                void* ct_d2, void* gain_part, void* stream) {
  if (n_glyphs == 0) return 0;
  if (n_glyphs < 0 || tp < 1 || n_rows < 1 || ct_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flat_loss_bwd_kernel<<<n_glyphs, vgl::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ct), ct_stride, static_cast<const float*>(d2),
      static_cast<const int32_t*>(wn), static_cast<const float*>(target),
      static_cast<const int32_t*>(glyph_rows), n_glyphs, static_cast<const float*>(log_gain), tp,
      n_rows, static_cast<float*>(ct_d2), static_cast<float*>(gain_part));
  return static_cast<int>(cudaGetLastError());
}
