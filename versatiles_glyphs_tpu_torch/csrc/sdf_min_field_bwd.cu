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
// never scatters. Here the reduction is pixel-major: a pixel is routed
// to its argmin lane once, with no scan of the lanes, no atomics and
// every output lane written by one thread. The work is a glyph's w*h
// pixels, not its pixels times its lanes.
//
// - A warp is given a row of the tile table and returns at once unless
//   the row is a glyph's first (pix_base 0, w*h > 0). A glyph's rows
//   are consecutive with pix_base 0, TP, 2*TP, ... (the flat plan lays
//   them out so, the wrapper checks it), so its am and g are contiguous
//   from row*TP for w*h pixels. The warp walks them in order, 32 pixels
//   a step, am and g loaded one step ahead. A lane recomputes its
//   pixel's tc, qx, qy on segment (a, a + 1) with the parent kernel's
//   op order (g2 = 2g, g2*qx, terms g2*qx, g2*qy, g2*qx*tc, g2*qy*tc).
// - The lanes of a step are grouped by a - off (`vg::match_keys`); the
//   lowest lane of each set adds the set's terms, in lane order, which
//   is pixel order, onto that lane's float4 accumulator (ax, ay, bx, by)
//   in shared memory (`vg::add_in_lane_order`). One warp owns a glyph's
//   accumulators, so no two lanes add to one of them, and each sum is
//   taken in pixel order (tiles up, pixels up): the order of the
//   sequential loop ops/sdf_torch.min_field_bwd_pts_ordered, whose bits
//   this kernel gives. DETERMINISTIC.
// - A pixel counts only if it is below w*h and its am is a segment lane
//   of the glyph's run, [off, off + npts - 1); the sentinel 2^31 - 1,
//   any other lane and the lanes past the walk take key -1, which has no
//   leader. The cotangent past w*h is never read into a sum.
// - Accumulators take 16 bytes a lane and warp, at most 48 KB a block;
//   a glyph with more segment lanes than a pass covers is walked once a
//   pass of lanes, its pixels reread, each pass keeping the pixels whose
//   am lies in it. A lane lies in one pass, so the order of its sum
//   does not change.
// - Epilogue of a pass: every lane L of it is written once,
//   dpts[L] = (bx_L - ax_L) - bx_{L-1}; the bx of the lane before the
//   glyph's run is 0, and across a pass the previous pass's last bx is
//   carried. After the last pass the chain's last point, where no
//   segment starts, gets -bx of the last segment. Glyph lane runs are
//   disjoint, so no lane has two writers; lanes outside every glyph stay
//   the caller's zeros.
//
// Bound: bytes (25 f32 operations a pixel, tools/work.BWD_PIXEL_F32_OPS,
// against 8 bytes read a pixel and 16 a lane). The time is the longest
// glyph's serial walk: a step is a prefetched load, four L1 gathers of
// the point chain, a divide, a warp match and one round of four
// shuffles for each lane of the step's largest set.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

constexpr int kSmemMax = 48 * 1024;  // shared memory a block without opting in

__global__ void sdf_min_field_bwd_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ am, const float* __restrict__ ct,
    const int32_t* __restrict__ tmeta, int n_tiles, int tp, int lanes_a_pass,
    float* __restrict__ dpts) {
  extern __shared__ float4 acc_all[];  // [warps a block][lanes_a_pass]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;  // this warp's tile-table row
  if (t >= n_tiles) return;  // the same for every lane of the warp
  const vg::TileRow g = vg::load_tile(tmeta, n_tiles, t);
  const int npix = g.w * g.h;
  if (g.base != 0 || npix <= 0) return;  // not a glyph's first row
  float4* acc = acc_all + static_cast<size_t>(warp) * lanes_a_pass;
  const size_t row = static_cast<size_t>(t) * tp;  // am, ct of pixel p at row + p
  const int last = g.off + g.npts - 1;  // segment lanes [off, last)

  float carry_x = 0.0f, carry_y = 0.0f;  // bx, by of the lane before the pass
  for (int c0 = g.off; c0 < last; c0 += lanes_a_pass) {
    const int n = min(lanes_a_pass, last - c0);
    for (int s = lane; s < n; s += 32) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();

    int a_next = -1;
    float g_next = 0.0f;
    if (lane < npix) {
      a_next = am[row + lane];
      g_next = ct[row + lane];
    }
    for (int p0 = 0; p0 < npix; p0 += 32) {
      const int p = p0 + lane;
      const int a = a_next;
      const float gc = g_next;
      a_next = -1;
      if (p + 32 < npix) {
        a_next = am[row + p + 32];
        g_next = ct[row + p + 32];
      }
      // Lanes past w*h carry -1, and c0 >= 0.
      const bool in = a >= c0 && a < c0 + n;
      float4 terms = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const float vx = pts[a];
        const float vy = pts[n_lanes + a];
        const float dx = pts[a + 1] - vx;
        const float dy = pts[n_lanes + a + 1] - vy;
        float pxc, pyc, tc, qx, qy;
        vg::pixel_center(g, p, pxc, pyc);
        vg::project(pxc - vx, pyc - vy, dx, dy, vg::l2_inverse(dx, dy), tc, qx, qy);
        const float g2 = 2.0f * gc;
        const float gqx = g2 * qx;
        const float gqy = g2 * qy;
        terms = make_float4(gqx, gqy, gqx * tc, gqy * tc);
      }
      const vg::KeySets sets = vg::match_keys(in ? a - c0 : -1);
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (sets.leader) sum = acc[a - c0];
      vg::add_in_lane_order(sets, terms, sum);
      if (sets.leader) acc[a - c0] = sum;
      __syncwarp();  // the next step's leaders and the epilogue read these
    }

    for (int s = lane; s < n; s += 32) {
      const float4 v = acc[s];
      const float prev_x = s ? acc[s - 1].z : carry_x;
      const float prev_y = s ? acc[s - 1].w : carry_y;
      dpts[c0 + s] = (v.z - v.x) - prev_x;
      dpts[n_lanes + c0 + s] = (v.w - v.y) - prev_y;
    }
    carry_x = acc[n - 1].z;
    carry_y = acc[n - 1].w;
    __syncwarp();  // the accumulators are read before the next pass zeroes them
  }
  // The chain's last point: no segment starts there (bx - ax = +0).
  if (g.npts >= 1 && lane == 0) {
    dpts[last] = 0.0f - carry_x;
    dpts[n_lanes + last] = 0.0f - carry_y;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, am [n_tiles, tp] i32, ct [n_tiles, tp] f32 (the cotangent of
// d^2), tmeta [8, n_tiles] i32, dpts [2, n_lanes] f32 zeroed by the
// caller. threads is the block size (a multiple of 32, at most 1024; a
// warp a tile-table row), and lanes_a_pass >= 1 the segment lanes a
// warp's accumulators cover at a time: 16 * lanes_a_pass * threads / 32
// bytes of shared memory, at most 48 KB. The caller checks shapes,
// bounds and that each glyph's rows are consecutive.
extern "C" int vg_sdf_min_field_bwd(
    const void* pts, int n_lanes, const void* am, const void* ct,
    const void* tmeta, int n_tiles, int tp, int threads, int lanes_a_pass, void* dpts,
    void* stream) {
  if (n_tiles == 0) return 0;
  if (threads % 32 || threads < 32 || threads > 1024 || lanes_a_pass < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = threads / 32;
  const size_t smem = sizeof(float4) * static_cast<size_t>(lanes_a_pass) * warps;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_tiles + warps - 1) / warps;
  sdf_min_field_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(am), static_cast<const float*>(ct),
      static_cast<const int32_t*>(tmeta), n_tiles, tp, lanes_a_pass,
      static_cast<float*>(dpts));
  return static_cast<int>(cudaGetLastError());
}
