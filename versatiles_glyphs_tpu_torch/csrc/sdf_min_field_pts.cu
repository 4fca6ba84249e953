// Min-field kernel of the outline-fitting forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel_tiles_pts_min` in
// versatiles_glyphs_tpu/ops/sdf_pallas.py (launched by
// `min_field_pallas_pts`, reached from the fitting forward
// `ops/sdf_grad._signed_field_flat_tpu_fwd`). Per pixel it emits the
// min of d^2 over the glyph's live segments, the winding number and the
// global lane of the FIRST argmin segment: the facts the backward
// (sdf_min_field_bwd.cu) needs to route the gradient of the hard min.
// Rows whose pix_base is at or past w*h write zeros in all three
// outputs; pixels past w*h in a live row are computed like the others
// (the backward drops them).
//
// Bound: f32 instruction slots, as the render kernels; the three outputs
// are 12 bytes a pixel. The function is counted by
// tools/work.row_shared_work (16 f32 operations a (pixel, live segment)
// pair, 2 a bitmap row and segment, 4 a crossing and 1 a pixel of its
// row). The design is the render tile kernel's (sdf_tiles_pts.cu), whose
// tile body it shares (sdf_pair.cuh, `tile_body` over `ChainStaging`),
// with the padded min field's pixels (sdf_min_field_padded.cu,
// `MinPixels`):
//
// - one block of TP / R threads a tile-table row, thread tid owning the
//   R pixels tid, tid + TP/R, ... of the tile with their running min of
//   d^2, first argmin and winding count in registers; the three stores
//   of a warp stay contiguous. The launcher picks R
//   (ops/sdf_cuda.min_field_pixels_per_thread);
// - the glyph's lane run is walked in chunks of kRecChunk lanes; only a
//   chunk's live lanes are staged, compacted in lane order by warp
//   ballot, as 32-byte records read by two 16-byte broadcast loads that
//   serve the thread's R pixels. The loop has no validity word and no
//   branch and is unrolled by four; a chunk with no live lane is
//   skipped whole;
// - a record's spare word carries the segment's global lane, which is
//   what the argmin must be (the backward reads it as a lane of pts) and
//   is neither the slot of a compacted segment nor the lane less the
//   run's start;
// - the running (dmin, amin) pair updates on a strict `<` while the
//   staged segments go up in lane order, chunk after chunk, so ties
//   keep the smallest lane also across chunks and with dead lanes
//   between, and a pixel with no live segment keeps 3e38 and the
//   sentinel 2^31 - 1;
// - the winding goes by bitmap row (`RowLists`): the block tests each
//   staged segment once against each row of the tile and a pixel sums
//   its row's few crossings, so the loop over the segments keeps a
//   pair's 16 distance operations, one compare and two selects. A tile
//   of more than kRowsMax rows (a bitmap under 4 pixels wide at TP =
//   256) or a row with more than kRowCross crossings in one chunk takes
//   the loop that tests every pair's crossing.
//
// Parity with the plain version (ops/sdf_torch.min_field_pts): d^2 bit
// for bit, winding and argmin exactly, by the shared op order of
// sdf_pair.cuh under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(1024 / R) sdf_min_field_pts_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float* __restrict__ d2_out, int32_t* __restrict__ wn_out,
    int32_t* __restrict__ am_out) {
  vg::tile_body<R, vg::MinPixels<R>>(vg::ChainStaging{pts, n_lanes, mask_words}, tmeta, n_tiles,
                                     vg::MinFieldStore{d2_out, wn_out, am_out});
}

template <int R>
void launch_r(const float* pts, int n_lanes, const int32_t* mask_words, const int32_t* tmeta,
              int n_tiles, int tp, float* d2, int32_t* wn, int32_t* am, cudaStream_t stream) {
  sdf_min_field_pts_kernel<R><<<n_tiles, tp / R, 0, stream>>>(
      pts, n_lanes, mask_words, tmeta, n_tiles, d2, wn, am);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, and the
// outputs d2 f32, wn i32, am i32, each [n_tiles, tp]. tp is the tile's
// pixel count and r the pixels a thread (1, 2 or 4; tp / r is the block
// size, a multiple of 32, at most 1024 / r). The caller checks shapes
// and bounds.
extern "C" int vg_sdf_min_field_pts(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, int r, void* d2, void* wn, void* am, void* stream) {
  if (n_tiles == 0) return 0;
  if ((r != 1 && r != 2 && r != 4) || tp % (32 * r) || tp < 32 * r || tp > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = r == 4 ? launch_r<4> : r == 2 ? launch_r<2> : launch_r<1>;
  launch(static_cast<const float*>(pts), n_lanes, static_cast<const int32_t*>(mask_words),
         static_cast<const int32_t*>(tmeta), n_tiles, tp, static_cast<float*>(d2),
         static_cast<int32_t*>(wn), static_cast<int32_t*>(am), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
