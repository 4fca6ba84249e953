// Chain backward of the fused flat-fit loss, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its chain
// points with XLA (`models/fitting._place_chunks`' custom VJP gathers a
// block's cotangent through `inv_chunk`, then the matmul's and the add's
// transposes). In the port those were the backward of the gather (a
// zeroed buffer and an index_add), of the pad, of the Bernstein einsum
// and of the translate's broadcast; this kernel gathers each curve's K
// lanes straight from the backward min-field kernel's dpts, as JAX's
// inv_chunk does, and adds log_gain's gradient.
//
// Blocks 0 .. B-1, one a glyph: its curves' gradients
//   dcurves[g, c, i, d] = sum over j = 0 .. K-1 of M_ji * dpts[d, lane0_g + c*K + j]
// in j order (a curve past the glyph's chain, c*K + K > npts_g, gets 0),
// written by the block's threads, then
//   dtranslate[g, d] = sum over (c, i) in order of dcurves[g, c, i, d]
// by one thread a coordinate. Block B: d log_gain, the glyphs' gain_part
// added in a fixed order (thread t the glyphs t, t + kThreads, ..., then
// vgl::block_sum), times exp(log_gain). No float atomics.
//
// Bound: bytes: each glyph reads its chain's lanes (8 bytes a point) and
// writes 32 bytes a curve and 8 for its translate.

#include <cstdint>

#include <cuda_runtime.h>

#include "flat_loss.cuh"

namespace {

__global__ void __launch_bounds__(vgl::kThreads) flat_chain_bwd_kernel(
    const float* __restrict__ dpts, int n_lanes, const float* __restrict__ bern,
    const int32_t* __restrict__ glyph_rows, int n_glyphs, int n_curves, int k,
    const float* __restrict__ gain_part, const float* __restrict__ log_gain, float* dcurves,
    float* __restrict__ dtranslate, float* __restrict__ dlog_gain) {
  __shared__ float sh[vgl::kThreads];
  const int b = blockIdx.x;
  if (b == n_glyphs) {
    float acc = 0.0f;
    for (int g = threadIdx.x; g < n_glyphs; g += vgl::kThreads)
      acc = __fadd_rn(acc, gain_part[g]);
    const float sum = vgl::block_sum(acc, sh);
    if (threadIdx.x == 0) *dlog_gain = __fmul_rn(sum, vgl::gain_of(log_gain));
    return;
  }
  const vgl::GlyphRow G = vgl::load_glyph(glyph_rows, b);
  float* out = dcurves + static_cast<size_t>(b) * n_curves * 8;
  for (int e = threadIdx.x; e < n_curves * 8; e += vgl::kThreads) {
    const int c = e >> 3;
    const int i = (e >> 1) & 3;
    float v = 0.0f;
    if ((c + 1) * k <= G.npts) {
      const float* p = dpts + static_cast<size_t>(e & 1) * n_lanes + G.lane0 + c * k;
      for (int j = 0; j < k; ++j) v = __fadd_rn(v, __fmul_rn(bern[4 * j + i], p[j]));
    }
    out[e] = v;
  }
  __syncthreads();  // the block's writes of out are seen by the two threads below
  if (threadIdx.x < 2) {
    float t = 0.0f;
    for (int q = 0; q < n_curves * 4; ++q) t = __fadd_rn(t, out[2 * q + threadIdx.x]);
    dtranslate[2 * b + threadIdx.x] = t;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Device pointers: dpts [2, n_lanes] f32 (the
// backward min-field kernel's output), bern [k, 4] f32, glyph_rows
// [n_glyphs, 4] i32 (tile0, w*h, lane0, npts), gain_part [n_glyphs] f32
// (flat_loss_bwd.cu's), log_gain [] f32; outputs dcurves [n_glyphs,
// n_curves, 4, 2], dtranslate [n_glyphs, 2] and dlog_gain [] f32, all
// written. The caller checks shapes and that each glyph's run lies in
// [0, n_lanes).
extern "C" int vg_flat_chain_bwd(const void* dpts, int n_lanes, const void* bern,
                                 const void* glyph_rows, int n_glyphs, int n_curves, int k,
                                 const void* gain_part, const void* log_gain, void* dcurves,
                                 void* dtranslate, void* dlog_gain, void* stream) {
  if (n_glyphs < 0 || n_curves < 1 || k < 2 || n_lanes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flat_chain_bwd_kernel<<<n_glyphs + 1, vgl::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dpts), n_lanes, static_cast<const float*>(bern),
      static_cast<const int32_t*>(glyph_rows), n_glyphs, n_curves, k,
      static_cast<const float*>(gain_part), static_cast<const float*>(log_gain),
      static_cast<float*>(dcurves), static_cast<float*>(dtranslate),
      static_cast<float*>(dlog_gain));
  return static_cast<int>(cudaGetLastError());
}
