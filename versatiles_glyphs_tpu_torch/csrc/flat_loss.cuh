// Shared pieces of the fused flat-fit loss, for Hopper (sm_90a): the
// four kernels flat_chain_fwd.cu, flat_loss_fwd.cu, flat_loss_bwd.cu and
// flat_chain_bwd.cu, which take the place of the PyTorch ops around the
// min-field pair (sdf_min_field_pts.cu, sdf_min_field_bwd.cu) in the
// flat backend's loss.
//
// Every value is f32 and each operation is rounded once (the intrinsics
// below and the build's --fmad=false), in the op order of the plain
// versions in ops/flat_loss.py, so each kernel gives their bits. No
// float atomics: every sum is taken in a fixed order (`block_sum`).

#pragma once

#include <cstdint>

namespace vgl {

// Threads a block: one glyph a block in the loss kernels and the chain
// backward, and the width of every fixed-order sum (ops/flat_loss.THREADS).
constexpr int kThreads = 256;
// Lanes of a chunk of the plan's lane layout (render/batch.SC).
constexpr int kLaneChunk = 128;
// The SDF's clip, constants.SDF_RADIUS.
constexpr float kRadius = 8.0f;
// The floor of d^2 before its square root (sd = sgn * sqrt(max(d^2, floor))).
constexpr float kD2Floor = 1e-12f;

// A row of the plan's glyph table [B, 4] i32: the glyph's first tile
// row, its w*h pixels (the live pixels of its tiles, in order from the
// first row's first), its first lane and its chain's point count.
struct GlyphRow {
  int tile0, npix, lane0, npts;
};

__device__ __forceinline__ GlyphRow load_glyph(const int32_t* __restrict__ rows, int g) {
  GlyphRow r;
  r.tile0 = rows[4 * g];
  r.npix = rows[4 * g + 1];
  r.lane0 = rows[4 * g + 2];
  r.npts = rows[4 * g + 3];
  return r;
}

// Tile rows of a glyph of npix pixels: at least one (the flat plan's rule).
__device__ __forceinline__ int tiles_of(int npix, int tp) {
  return npix > tp ? (npix + tp - 1) / tp : 1;
}

// exp(log_gain), taken in f64 and rounded once to f32 (the plain version's
// torch.exp of the f64 value).
__device__ __forceinline__ float gain_of(const float* __restrict__ log_gain) {
  return static_cast<float>(exp(static_cast<double>(*log_gain)));
}

// torch.minimum(torch.maximum(x, -R), R): NaN passes through, as there.
__device__ __forceinline__ float clip(float x) {
  const float m = x < -kRadius ? -kRadius : x;
  return m > kRadius ? kRadius : m;
}

// What a live pixel's loss term is made of: d = sqrt(max(d^2, floor)),
// sd = -d where the winding is non-zero (inside), pred = sd * gain and diff =
// clip(pred) - clip(target); its loss term is diff * diff.
struct Pixel {
  bool inside;  // winding non-zero: sgn = -1
  float d, sd, pred, diff;
};

__device__ __forceinline__ Pixel pixel_terms(float d2, int32_t wn, float target, float gain) {
  Pixel p;
  p.inside = wn != 0;
  p.d = __fsqrt_rn(d2 < kD2Floor ? kD2Floor : d2);
  p.sd = p.inside ? -p.d : p.d;
  p.pred = __fmul_rn(p.sd, gain);
  p.diff = __fsub_rn(clip(p.pred), clip(target));
  return p;
}

// The cotangent of pred from `per`, the cotangent of the pixel's loss
// term: per * (2 * diff) through the two clips, each of which passes half
// at equality with its bound and none beyond it (the gradients of
// torch.minimum and torch.maximum).
__device__ __forceinline__ float pred_grad(float per, const Pixel& p) {
  float g = __fmul_rn(per, __fmul_rn(2.0f, p.diff));
  const float m = p.pred < -kRadius ? -kRadius : p.pred;
  g = m > kRadius ? 0.0f : (m == kRadius ? __fdiv_rn(g, 2.0f) : g);
  return p.pred < -kRadius ? 0.0f : (p.pred == -kRadius ? __fdiv_rn(g, 2.0f) : g);
}

// The sum of the block's kThreads values v, in a fixed order: halves
// added pairwise, sh[t] += sh[t + s] for s = kThreads/2, ..., 1. Every
// thread of the block calls it; the sum is returned to thread 0 (and to
// every thread). sh: kThreads floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = __fadd_rn(sh[t], sh[t + s]);
    __syncthreads();
  }
  const float sum = sh[0];
  __syncthreads();  // sh may be reused after
  return sum;
}

}  // namespace vgl
