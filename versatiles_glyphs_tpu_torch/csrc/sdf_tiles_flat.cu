// SDF tile kernel over the flat segment layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel_tiles` in
// versatiles_glyphs_tpu/ops/legacy.py (launched by
// `render_bitmaps_pallas_tiles`). It computes kernel 1's per-pixel math
// (sdf_tiles_pts.cu) on the older segment soup: flat [4, N] f32 rows
// vx, vy, wx, wy, one independent segment a lane (the layout of
// `render.batch.pack_flat`), with no mask bits.
//
// Work: one thread block per tile-table row, one thread per pixel
// (blockDim.x == TP). A row of tmeta [8, T] i32 is x0, y0, w, h, nseg,
// seg_off, pix_base, _; its glyph's segments are lanes
// [seg_off, seg_off + nseg), each live (lane < nseg is the validity
// test of the TPU kernel). The TPU kernel double-buffers 128-lane
// chunks from HBM into VMEM by DMA; here each chunk of TP segments is
// staged in shared memory by the block, with its divides done once per
// segment, and every thread reads it by broadcast while the running min
// of d^2 and the winding count stay in registers. Pixel row and column
// come from integer div and mod, as in the TPU kernel. Rows whose
// pix_base is at or past w*h write zeros.
//
// Bound: f32 instruction slots, as kernel 1: 22 f32 operations per (pixel,
// segment) pair (tools/work.py) against 16 bytes of global reads per
// segment per block, all of it from L2 after the first block of a
// glyph. It keeps the plain loop of SegChunk (one pixel a thread, a
// crossing test a pair) and is the independent implementation that
// kernels 1 and 7, which share SegRecords, are held against.
//
// Parity with the plain version (ops/sdf_torch.render_tiles_flat) is
// byte equality, by the shared op order of sdf_pair.cuh under
// --fmad=false; on the same glyphs the bytes also equal kernel 1's on
// the f32 wire (same endpoints, same op order).

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_tiles_flat_kernel(
    const float* __restrict__ flat, int n_lanes,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const vg::SegChunk seg(smem, blockDim.x);

  const int t = blockIdx.x;
  const vg::TileRow r = vg::load_tile(tmeta, n_tiles, t);
  uint8_t* dst = out + static_cast<size_t>(t) * blockDim.x + threadIdx.x;

  if (r.base >= r.w * r.h) {  // the same for every thread of the block
    *dst = 0;
    return;
  }

  float pxc, pyc;
  vg::pixel_center(r, r.base + threadIdx.x, pxc, pyc);
  int wn = 0;
  // TileRow's npts and off hold nseg and seg_off in this layout.
  const float dmin = vg::soup_min_d2(seg, flat, n_lanes, r.off, r.npts, pxc, pyc, wn);
  *dst = vg::sdf_byte(dmin, wn, scale, cutoff);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: flat [4, n_lanes]
// f32, tmeta [8, n_tiles] i32, out [n_tiles, tp] u8. tp is the block
// size (a multiple of 32, at most 1024). The caller checks shapes and
// that every row's lanes lie in [0, n_lanes).
extern "C" int vg_sdf_tiles_flat(
    const void* flat, int n_lanes, const void* tmeta, int n_tiles, int tp,
    float scale, float cutoff, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(tp) * sizeof(float);
  sdf_tiles_flat_kernel<<<n_tiles, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flat), n_lanes,
      static_cast<const int32_t*>(tmeta), n_tiles, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
