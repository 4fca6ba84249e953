// The render tile kernel with a pixel's segments split over a sub-warp,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_acc` of scripts/kernel_ab.py, the
// variant that script holds against the production kernel
// `_sdf_kernel_tiles_pts`. On the TPU the variant keeps a running min
// of d^2 and a winding count per (pixel, lane) and reduces across lanes
// once per tile instead of once per chunk. sdf_tiles_pts.cu has no
// cross-lane reduction at all (one thread owns a pixel and walks every
// segment), so the counterpart here is the other decomposition of the
// same function: L threads a pixel (a sub-warp: threads L*p .. L*p+L-1
// of the block own pixel p), each keeping its own running min d^2 and
// winding over the staged segments j = l, l + L, l + 2L, ..., reduced
// once at the end by __shfl_xor_sync. An f32 min and an i32 sum are
// exact in any order, so the bytes are sdf_tiles_pts.cu's.
//
// This kernel is the per-pair implementation on the card that the
// render kernels (sdf_tiles_pts.cu, sdf_tiles_flat.cu, sdf_grid_flat.cu)
// are held against byte for byte. So it keeps its own route: no
// compaction of live lanes, no crossing lists by row, no shared tile
// body; every pair tests its own crossing (`d2_and_winding` below).
//
// Work: one block per tile-table row, blockDim.x == TP * L threads.
// The segments are staged in shared memory in chunks of blockDim.x
// lanes, one lane a thread and every lane of the chunk, as a 32-byte
// record a slot (SegRecords::put of sdf_pair.cuh: {vx, vy, dx, dy} and
// {1/l2, 1/dy, wy, valid}); the validity bit rides in the record's
// spare word. A pair is two 16-byte broadcast loads, and a masked slot
// is a select (d^2 -> kBig, winding step -> 0), not a branch, so the
// lanes of a warp that stride a chunk across a contour end no longer
// diverge. The loop over a thread's slots is unrolled by 4. Rows whose
// pix_base is at or past w*h write TP zeros.
//
// Bound: FP32 ALU, like sdf_tiles_pts.cu: the same pairs, each with its
// own crossing test (22 f32 operations a pair executed, where the bound
// counts the function by tools/work.row_shared_work, about 16.1), plus
// log2(L) shuffle steps a pixel. The plain version is the production
// kernel's, ops/sdf_torch.render_tiles_pts, because the function is the
// same.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

// d^2 from pixel (pxc, pyc) to the staged record (a, b) and its step of
// the winding count (+1 upward crossing left of the pixel, -1 downward),
// kBig and 0 for a masked slot. The crossing test is the parity form:
// the row crosses iff (vy <= py) != (wy <= py), upward iff vy <= py.
// That is the half-open up/down form vy <= py < wy (+1), wy <= py < vy
// (-1) of the older TPU kernels (ops/legacy.py) written with two
// compares fewer. The expressions are those of SegRecords::pair with
// its winding, in the same order, so the values are the same bits.
__device__ __forceinline__ float d2_and_winding(const float4& a, const float4& b, float pxc,
                                                float pyc, int& wn) {
  const float ex = pxc - a.x;
  const float ey = pyc - a.y;
  float tc, qx, qy;
  vg::project(ex, ey, a.z, a.w, b.x, tc, qx, qy);
  const bool c1 = a.y <= pyc;
  const bool cross = c1 != (b.z <= pyc);
  const float cx = a.x + (ey * b.y) * a.z;
  const bool valid = __float_as_int(b.w) != 0;
  wn += valid && cross && cx <= pxc ? (c1 ? 1 : -1) : 0;
  return valid ? qx * qx + qy * qy : vg::kBig;
}

// A block may have 1,024 threads, which leaves each 64 registers.
__global__ void __launch_bounds__(1024) sdf_tiles_pts_acc_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles, int tp, int split,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float4 smem[];  // 2 * blockDim.x records' halves
  const int nthr = blockDim.x;  // tp * split
  const vg::SegRecords seg(smem);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int pix = tid / split;      // pixel of the tile
  const int l = tid - pix * split;  // this thread's share of the segments
  const vg::TileRow r = vg::load_tile(tmeta, n_tiles, t);
  uint8_t* dst = out + static_cast<size_t>(t) * tp + pix;

  if (r.base >= r.w * r.h) {  // the same for every thread of the block
    if (l == 0) *dst = 0;
    return;
  }

  float pxc, pyc;
  vg::pixel_center(r, r.base + pix, pxc, pyc);

  float dmin = vg::kBig;
  int wn = 0;
  const int last = r.off + r.npts - 1;  // segments are lanes [off, last)
  for (int c0 = r.off; c0 < last; c0 += nthr) {
    const int lane = c0 + tid;
    if (lane < last) {
      const uint32_t word = static_cast<uint32_t>(mask_words[lane >> 5]);
      seg.put(tid, pts[lane], pts[n_lanes + lane], pts[lane + 1], pts[n_lanes + lane + 1],
              (word >> (lane & 31)) & 1u);
    }
    __syncthreads();
    const int nseg = min(nthr, last - c0);
    int j = l;
    for (; j + 3 * split < nseg; j += 4 * split) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = j + u * split;
        dmin = fminf(dmin, d2_and_winding(seg.rec[2 * k], seg.rec[2 * k + 1], pxc, pyc, wn));
      }
    }
    for (; j < nseg; j += split)
      dmin = fminf(dmin, d2_and_winding(seg.rec[2 * j], seg.rec[2 * j + 1], pxc, pyc, wn));
    __syncthreads();
  }

  // The sub-warp's reduction: split is a power of two at most 32 and
  // divides the warp, so the partners of a pixel sit in one warp, and
  // every thread of the block reaches this point.
  for (int o = split >> 1; o > 0; o >>= 1) {
    dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
    wn += __shfl_xor_sync(0xffffffffu, wn, o);
  }
  if (l == 0) *dst = vg::sdf_byte(dmin, wn, scale, cutoff);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, out
// [n_tiles, tp] u8. tp is the pixels a block and split the threads a
// pixel (a power of two, at most 32); the block has tp * split threads
// (a multiple of 32, at most 1024) and stages as many lanes a chunk, 32
// bytes each. The caller checks shapes and bounds.
extern "C" int vg_sdf_tiles_pts_acc(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, int split, float scale, float cutoff, void* out,
    void* stream) {
  if (n_tiles == 0) return 0;
  const int nthr = tp * split;
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(nthr);
  sdf_tiles_pts_acc_kernel<<<n_tiles, nthr, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(mask_words),
      static_cast<const int32_t*>(tmeta), n_tiles, tp, split, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
