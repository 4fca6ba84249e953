// SDF tile kernel over the flat segment layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel_tiles` in
// versatiles_glyphs_tpu/ops/legacy.py (launched by
// `render_bitmaps_pallas_tiles`). It computes kernel 1's per-pixel math
// (sdf_tiles_pts.cu) on the older segment soup: flat [4, N] f32 rows
// vx, vy, wx, wy, one independent segment a lane (the layout of
// `render.batch.pack_flat`), with no mask bits.
//
// A row of tmeta [8, T] i32 is x0, y0, w, h, nseg, seg_off, pix_base, _;
// its glyph's segments are lanes [seg_off, seg_off + nseg), each live
// (lane < nseg is the validity test of the TPU kernel). The TPU kernel
// double-buffers 128-lane chunks from HBM into VMEM by DMA. Nothing of
// that is carried over: the tile's body is kernel 1's (`render_tile` of
// sdf_pair.cuh), with the soup's staging in place of the chain's:
//
// - one thread block per tile-table row of TP / R threads, thread tid
//   owning pixels tid, tid + TP/R, ... of the tile; R is 2 where TP / 2
//   is whole warps, else 1, the launcher's choice as for kernel 1;
// - the glyph's run is walked in chunks of kRecChunk lanes, each staged
//   as 32-byte records {vx, vy, dx, dy | 1/l2, 1/dy, wy, 0} with the two
//   divides paid once a segment and block (`SoupStaging`: every lane is
//   live, so there is no validity to read and no compaction), and read
//   by two 16-byte broadcast loads that serve the thread's R pixels;
// - the crossings go by bitmap row (`RowLists`): the block tests each
//   staged segment once against each row of the tile's pixels and a
//   pixel sums its row's few crossings, so the loop over the segments,
//   unrolled by four, keeps the 16 distance operations of a pair's 22.
//   A tile of more than kRowsMax rows or a row with more than kRowCross
//   crossings in one chunk takes the loop that tests every pair.
// Rows whose pix_base is at or past w*h write zeros.
//
// Bound: f32 instruction slots, as kernel 1. The function is counted by
// tools/work.row_shared_work (16 f32 operations a pair, 2 a bitmap row
// and segment, 4 a crossing and 1 a pixel of its row) against 16 bytes
// of global reads a segment and block, all of it from L2 after the
// first block of a glyph.
//
// Parity with the plain version (ops/sdf_torch.render_tiles_flat) is
// byte equality, by the shared op order of sdf_pair.cuh under
// --fmad=false; on the same glyphs the bytes also equal kernel 1's on
// the f32 wire (same endpoints, same op order). Kernels 1, 6 and 7 now
// share SegRecords, so the implementations they are held against are
// the plain versions and sdf_tiles_pts_acc.cu, which keeps every lane
// of a chunk and a crossing test a pair.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(1024 / R) sdf_tiles_flat_kernel(
    const float* __restrict__ flat, int n_lanes,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  vg::render_tile<R>(vg::SoupStaging{flat, n_lanes}, tmeta, n_tiles, scale, cutoff, out);
}

template <int R>
void launch_r(const float* flat, int n_lanes, const int32_t* tmeta, int n_tiles, int tp,
              float scale, float cutoff, uint8_t* out, cudaStream_t stream) {
  sdf_tiles_flat_kernel<R><<<n_tiles, tp / R, 0, stream>>>(
      flat, n_lanes, tmeta, n_tiles, scale, cutoff, out);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: flat [4, n_lanes]
// f32, tmeta [8, n_tiles] i32, out [n_tiles, tp] u8. tp is the tile's
// pixel count and r the pixels a thread (1 or 2; tp / r is the block
// size, a multiple of 32, at most 1024 / r). The caller checks shapes
// and that every row's lanes lie in [0, n_lanes).
extern "C" int vg_sdf_tiles_flat(
    const void* flat, int n_lanes, const void* tmeta, int n_tiles, int tp, int r,
    float scale, float cutoff, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  if ((r != 1 && r != 2) || tp % (32 * r)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = r == 2 ? launch_r<2> : launch_r<1>;
  launch(static_cast<const float*>(flat), n_lanes, static_cast<const int32_t*>(tmeta), n_tiles,
         tp, scale, cutoff, static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
