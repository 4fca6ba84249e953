// Backward reduction of the outline-fitting min field, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_flat` in
// versatiles_glyphs_tpu/ops/sdf_grad.py (launched by
// `_min_field_bwd_pallas`, reached from the custom VJP
// `_signed_field_flat_tpu_bwd`). Given the forward's argmin lane am and
// the cotangent g of d^2 per pixel, the gradient of the hard min flows
// to the argmin segment (a, a + 1) alone. With tc and q = p - (v + tc*d)
// recomputed in the forward's op order (sdf_pair.cuh), per lane L
//   A_L = sum of 2g*q,  B_L = sum of 2g*q*tc  over pixels with am == L,
// and dpts[L] = (B_L - A_L) - B_{L-1}: 2g*q*(tc - 1) at the segment's
// start point and -2g*q*tc at its end point.
//
// The TPU kernel visits every (pixel, segment chunk) pair so that it
// never scatters. Here the reduction is segment-major and DETERMINISTIC:
// no atomics, every output lane written by exactly one thread, and each
// lane's sums taken in one fixed order (tiles up, pixels up). Work: one
// thread block per tile-table row; only a glyph's first row (pix_base 0,
// w*h > 0) works, the others return at once. That block owns the
// glyph's lanes [off, off + npts) (glyph lane runs are disjoint and a
// glyph's rows are consecutive, as the flat plan lays them out) in
// chunks of TP lanes, one thread per lane. For each chunk it walks the
// glyph's rows in order, stages the row's am and g in shared memory, and
// every thread scans them for its lane, recomputing the pair terms only
// on a match. B of the last lane of a chunk carries to the next chunk in
// a register. Lanes outside every glyph are left as the caller's zeros.
//
// Bound: shared-memory broadcast reads, one (am, g) pair per pixel per
// lane of the chunk; the pair math runs once per pixel (25 f32
// operations, tools/work.BWD_PIXEL_F32_OPS, so the least time the card
// could take is that of the bytes). Pixels past
// w*h, skip rows and the sentinel 2^31 - 1 contribute nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_min_field_bwd_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ am, const float* __restrict__ ct,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float* __restrict__ dpts) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  int* s_am = reinterpret_cast<int*>(smem);
  float* s_ct = smem + tp;
  float* s_bx = s_ct + tp;
  float* s_by = s_bx + tp;

  const int tid = threadIdx.x;
  const vg::TileRow g = vg::load_tile(tmeta, n_tiles, blockIdx.x);
  const int npix = g.w * g.h;
  if (g.base != 0 || npix <= 0) return;  // the same for every thread
  const int n_rows = (npix + tp - 1) / tp;
  const int end = g.off + g.npts;   // point lanes [off, end)
  const int last = end - 1;         // segment lanes [off, last)

  float carry_bx = 0.0f, carry_by = 0.0f;  // B of the lane before the chunk
  for (int c0 = g.off; c0 < end; c0 += tp) {
    const int lane = c0 + tid;
    const bool is_seg = lane < last;
    float vx = 0.0f, vy = 0.0f, dx = 0.0f, dy = 0.0f, l2inv = 0.0f;
    if (is_seg) {
      vx = pts[lane];
      vy = pts[n_lanes + lane];
      dx = pts[lane + 1] - vx;
      dy = pts[n_lanes + lane + 1] - vy;
      l2inv = vg::l2_inverse(dx, dy);
    }
    float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f;
    for (int k = 0; k < n_rows; ++k) {
      const int t = blockIdx.x + k;
      const size_t o = static_cast<size_t>(t) * tp + tid;
      __syncthreads();  // the previous row's reads are done
      s_am[tid] = am[o];
      s_ct[tid] = ct[o];
      __syncthreads();
      if (!is_seg) continue;
      const int base = tmeta[6 * n_tiles + t];
      const int nj = min(tp, npix - base);  // pixels past w*h drop out
      for (int j = 0; j < nj; ++j) {
        if (s_am[j] != lane) continue;
        float pxc, pyc;
        vg::pixel_center(g, base + j, pxc, pyc);
        float tc, qx, qy;
        vg::project(pxc - vx, pyc - vy, dx, dy, l2inv, tc, qx, qy);
        const float g2 = 2.0f * s_ct[j];
        const float gqx = g2 * qx;
        const float gqy = g2 * qy;
        ax += gqx;
        ay += gqy;
        bx += gqx * tc;
        by += gqy * tc;
      }
    }
    s_bx[tid] = bx;
    s_by[tid] = by;
    __syncthreads();
    const float prev_bx = tid ? s_bx[tid - 1] : carry_bx;
    const float prev_by = tid ? s_by[tid - 1] : carry_by;
    if (lane < end) {
      dpts[lane] = (bx - ax) - prev_bx;
      dpts[n_lanes + lane] = (by - ay) - prev_by;
    }
    carry_bx = s_bx[tp - 1];
    carry_by = s_by[tp - 1];
    // s_bx/s_by are rewritten only after the next chunk's row syncs.
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, am [n_tiles, tp] i32, ct [n_tiles, tp] f32 (the cotangent of
// d^2), tmeta [8, n_tiles] i32, dpts [2, n_lanes] f32 zeroed by the
// caller. tp is the block size (a multiple of 32, at most 1024). The
// caller checks shapes, bounds and that each glyph's rows are
// consecutive.
extern "C" int vg_sdf_min_field_bwd(
    const void* pts, int n_lanes, const void* am, const void* ct,
    const void* tmeta, int n_tiles, int tp, void* dpts, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(tp) * sizeof(float);
  sdf_min_field_bwd_kernel<<<n_tiles, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(am), static_cast<const float*>(ct),
      static_cast<const int32_t*>(tmeta), n_tiles, static_cast<float*>(dpts));
  return static_cast<int>(cudaGetLastError());
}
