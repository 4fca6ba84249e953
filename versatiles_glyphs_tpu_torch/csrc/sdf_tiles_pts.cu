// Per-pixel SDF tile kernel of the atlas render path, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel_tiles_pts` in
// versatiles_glyphs_tpu/ops/sdf_pallas.py (launched by `_launch_pts`,
// reached from `render_bitmaps_pallas_pts` and
// `render_bitmaps_pallas_delta`). It computes what that kernel computes,
// and nothing of its TPU layout is carried over: no chunk-row reshape,
// no lane-shifted w-endpoint arrays, no float validity array, no
// (TP, SC) accumulators.
//
// Work: one thread block per tile-table row, one thread per pixel
// (blockDim.x == TP). Each block reads its own row of the tile table
// (tmeta [8, T] i32: x0, y0, w, h, npts, off, pix_base, _) and walks
// its glyph's lane run [off, off + npts - 1) of the flat point chain
// (pts [2, N] f32; segment i = (pts[:, i], pts[:, i + 1]), live iff
// bit i of mask_words is set) in chunks of TP segments. Per chunk each
// thread stages one segment's derived terms (dx, dy, 1/l2, 1/dy) in
// shared memory, so those divides are paid once per segment and block;
// then every thread reads the chunk by broadcast and keeps the running
// min of d^2 and the winding count in registers. Rows whose pix_base is
// at or past w*h write zeros.
//
// Bound: FP32 ALU. About 30 flops per (pixel, segment) pair against a
// few bytes of global traffic per segment per block, so everything the
// inner loop touches is on-chip. wgmma, TMA and tuning are later work.
//
// Parity with the plain version (ops/sdf_torch.render_tiles_pts) is
// byte equality. The build passes --fmad=false so that no multiply and
// add contract into an FMA, and the divides and the square root are
// the correctly rounded intrinsics. 1/l2 and 1/dy are reciprocals that
// multiply, as on the TPU; they are not folded into one divide. The
// per-pixel math is shared with the fitting kernels (sdf_pair.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_tiles_pts_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  const vg::SegChunk seg(smem, tp);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const vg::TileRow r = vg::load_tile(tmeta, n_tiles, t);
  uint8_t* dst = out + static_cast<size_t>(t) * tp + tid;

  if (r.base >= r.w * r.h) {  // the same for every thread of the block
    *dst = 0;
    return;
  }

  float pxc, pyc;
  vg::pixel_center(r, r.base + tid, pxc, pyc);

  float dmin = vg::kBig;
  int wn = 0;
  const int last = r.off + r.npts - 1;  // segments are lanes [off, last)
  for (int c0 = r.off; c0 < last; c0 += tp) {
    const int lane = c0 + tid;
    if (lane < last) seg.stage(pts, n_lanes, mask_words, lane, tid);
    __syncthreads();
    const int nseg = min(tp, last - c0);
    for (int j = 0; j < nseg; ++j) {
      if (!seg.ok[j]) continue;  // the same segment for every thread
      dmin = fminf(dmin, seg.d2_and_winding(j, pxc, pyc, wn));
    }
    __syncthreads();
  }

  *dst = vg::sdf_byte(dmin, wn, scale, cutoff);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, out
// [n_tiles, tp] u8. tp is the block size (a multiple of 32, at most
// 1024). The caller checks shapes and bounds.
extern "C" int vg_sdf_tiles_pts(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, float scale, float cutoff, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(tp) * sizeof(float);
  sdf_tiles_pts_kernel<<<n_tiles, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(mask_words),
      static_cast<const int32_t*>(tmeta), n_tiles, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
