// Backward of the padded-layout fitting min field, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in
// versatiles_glyphs_tpu/ops/sdf_grad.py (launched by `_run_bwd`, reached
// from the custom VJP `_min_d2_wn` of `signed_field_pallas`). Given the
// forward's argmin segment am and the cotangent g of d^2 per pixel, the
// gradient of the hard min flows to the argmin segment alone. With tc
// and q = p - (v + tc*d) recomputed in the forward's op order
// (sdf_pair.cuh, the JAX package's `_pair_terms`), segment s of glyph b
// gets, summed over the pixels p < P whose am is s,
//   dv = sum of 2g*q*(tc - 1)   and   dw = -(sum of 2g*q*tc).
// The segments of the padded layout are independent (segs [B, S, 4]),
// so unlike kernel 3 no sum carries from one segment to the next. The
// TPU kernel's [B, Sp, 128] lane padding of the segments and of the
// output is a layout artefact; this kernel reads segs [B, S, 4] and
// writes dsegs [B, S, 4] (dvx, dvy, dwx, dwy).
//
// Work, DETERMINISTIC (no atomics; every output written by one thread,
// its sums taken in one fixed order): grid (B, ceil(S / TS)), one block
// per (glyph, chunk of TS segments) and one thread per segment, its
// segment's terms in registers. The block walks the glyph's P pixels
// in order in tiles of TS; each tile's (am, g) pairs are staged in
// shared memory, every thread scans them for its segment and recomputes
// the pair terms only on a match. Pixels past w*h count as the TPU
// kernel counts them (the caller's cotangent masks them); the sentinel
// 2^31 - 1 matches no segment.
//
// Bound: shared-memory broadcast reads, P * S compares a glyph; the
// pair math runs once per pixel (25 f32 operations,
// tools/work.BWD_PIXEL_F32_OPS, so the least time the card could take
// is that of the bytes). Parity with the plain version
// (ops/sdf_torch.min_field_padded_bwd): within 1e-4 of the largest
// gradient, since that version's index_add_ sums in another order.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_min_field_padded_bwd_kernel(
    const float* __restrict__ segs, int n_seg,
    const int32_t* __restrict__ meta,
    const int32_t* __restrict__ am, const float* __restrict__ ct, int n_pix,
    float* __restrict__ dsegs) {
  extern __shared__ float smem[];
  const int ts = blockDim.x;
  int* s_am = reinterpret_cast<int*>(smem);
  float* s_ct = smem + ts;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = blockIdx.y * ts + tid;
  const bool is_seg = s < n_seg;
  const int32_t* m = meta + 4 * static_cast<size_t>(b);
  vg::TileRow r;
  r.x0 = m[0];
  r.y0 = m[1];
  r.w = m[2];
  r.h = m[3];
  r.npts = r.off = r.base = 0;  // unused here

  float vx = 0.0f, vy = 0.0f, dx = 0.0f, dy = 0.0f, l2inv = 0.0f;
  if (is_seg) {
    const float* v = segs + (static_cast<size_t>(b) * n_seg + s) * 4;
    vx = v[0];
    vy = v[1];
    dx = v[2] - vx;
    dy = v[3] - vy;
    l2inv = vg::l2_inverse(dx, dy);
  }

  const size_t row = static_cast<size_t>(b) * n_pix;
  float avx = 0.0f, avy = 0.0f, awx = 0.0f, awy = 0.0f;
  for (int p0 = 0; p0 < n_pix; p0 += ts) {
    __syncthreads();  // the previous tile's reads are done
    if (p0 + tid < n_pix) {
      s_am[tid] = am[row + p0 + tid];
      s_ct[tid] = ct[row + p0 + tid];
    }
    __syncthreads();
    if (!is_seg) continue;
    const int n = min(ts, n_pix - p0);
    for (int j = 0; j < n; ++j) {
      if (s_am[j] != s) continue;
      float pxc, pyc;
      vg::pixel_center(r, p0 + j, pxc, pyc);
      float tc, qx, qy;
      vg::project(pxc - vx, pyc - vy, dx, dy, l2inv, tc, qx, qy);
      const float g = s_ct[j];
      const float gqx = (2.0f * qx) * g;
      const float gqy = (2.0f * qy) * g;
      avx += gqx * (tc - 1.0f);
      avy += gqy * (tc - 1.0f);
      awx -= gqx * tc;
      awy -= gqy * tc;
    }
  }

  if (is_seg) {
    float* o = dsegs + (static_cast<size_t>(b) * n_seg + s) * 4;
    o[0] = avx;
    o[1] = avy;
    o[2] = awx;
    o[3] = awy;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: segs [n_glyphs,
// n_seg, 4] f32, meta [n_glyphs, 4] i32, am [n_glyphs, n_pix] i32, ct
// [n_glyphs, n_pix] f32 (the cotangent of d^2), dsegs [n_glyphs, n_seg,
// 4] f32 (every element written). ts is the block size (a multiple of
// 32, at most 1024). The caller checks shapes.
extern "C" int vg_sdf_min_field_padded_bwd(
    const void* segs, int n_glyphs, int n_seg, const void* meta, const void* am,
    const void* ct, int n_pix, int ts, void* dsegs, void* stream) {
  if (n_glyphs == 0 || n_seg == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(ts) * sizeof(float);
  const dim3 grid(n_glyphs, (n_seg + ts - 1) / ts);
  sdf_min_field_padded_bwd_kernel<<<grid, ts, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs), n_seg, static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(am), static_cast<const float*>(ct), n_pix,
      static_cast<float*>(dsegs));
  return static_cast<int>(cudaGetLastError());
}
