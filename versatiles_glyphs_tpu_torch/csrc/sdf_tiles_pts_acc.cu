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
// Work: one block per tile-table row, blockDim.x == TP * L threads.
// The segments are staged in shared memory in chunks of blockDim.x,
// one segment a thread, by the same SegChunk as the production kernel
// (inputs, tile table and output are its). A masked segment is skipped
// by the thread that meets it, which no longer is the whole block at
// once: lanes of a warp stride the chunk, so the test diverges where a
// glyph's run crosses a contour end. Rows whose pix_base is at or past
// w*h write TP zeros.
//
// Bound: FP32 ALU, like sdf_tiles_pts.cu: the same pairs, each with
// its own crossing test (22 f32 operations a pair executed, where the
// bound counts the function by tools/work.row_shared_work, about 16.1),
// plus log2(L) shuffle steps a pixel. Since the three render kernels
// share SegRecords and its row lists, this kernel's per-pair loop over
// SegChunk is the implementation on the card that their bytes are held
// against, beside the plain versions.
// Whether L partial chains a pixel run faster than one is what
// tools/kernel_ab.py measures. The plain version is the production
// kernel's, ops/sdf_torch.render_tiles_pts, because the function is
// the same.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

// A block may have 1,024 threads, which leaves each 64 registers.
__global__ void __launch_bounds__(1024) sdf_tiles_pts_acc_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles, int tp, int split,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int nthr = blockDim.x;  // tp * split
  const vg::SegChunk seg(smem, nthr);

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
    if (lane < last) seg.stage(pts, n_lanes, mask_words, lane, tid);
    __syncthreads();
    const int nseg = min(nthr, last - c0);
    for (int j = l; j < nseg; j += split) {
      if (!seg.ok[j]) continue;
      dmin = fminf(dmin, seg.d2_and_winding(j, pxc, pyc, wn));
    }
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
// (a multiple of 32, at most 1024). The caller checks shapes and
// bounds.
extern "C" int vg_sdf_tiles_pts_acc(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, int split, float scale, float cutoff, void* out,
    void* stream) {
  if (n_tiles == 0) return 0;
  const int nthr = tp * split;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(nthr) * sizeof(float);
  sdf_tiles_pts_acc_kernel<<<n_tiles, nthr, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(mask_words),
      static_cast<const int32_t*>(tmeta), n_tiles, tp, split, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
