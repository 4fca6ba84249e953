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
// Bound: f32 instruction slots. A (pixel, live segment) pair tested by
// itself is 22 separately rounded f32 instructions (tools/work.py counts
// them from sdf_pair.cuh) against a few bytes of global traffic a segment and
// block, and an SM starts 128 thread instructions a clock of whatever
// kind. So every shared load, validity test and loop instruction beside
// the 22 is lost f32 work, and the design spends as few as it can:
//
// - one thread block per tile-table row (tmeta [8, T] i32: x0, y0, w, h,
//   npts, off, pix_base, _) of TP / R threads, each thread owning the R
//   pixels tid, tid + TP/R, ... of the tile with their running min of
//   d^2 and winding count in registers (a warp's stores stay contiguous
//   bytes). R is 2 where TP / 2 is whole warps, else 1: two independent
//   chains hide the f32 latency, and four pixels a thread measured no
//   faster on either synthesized font (blocks of 64 threads fill the
//   card less evenly);
// - the glyph's lane run [off, off + npts - 1) of the flat point chain
//   (pts [2, N] f32; segment i = (pts[:, i], pts[:, i + 1]), live iff
//   bit i of mask_words is set) is walked in chunks of kRecChunk lanes.
//   Only a chunk's live lanes are staged in shared memory, compacted in
//   lane order by warp ballot, so the inner loop loads no validity word
//   and has no branch; a chunk with no live lane is skipped whole;
// - a staged segment is one 32-byte record {vx, vy, dx, dy | 1/l2, 1/dy,
//   wy, 0}, read by two 16-byte broadcast loads that serve the thread's
//   R pixels: 2/R loads a pair. The divides are paid once a segment and
//   block;
// - the inner loop is unrolled by four;
// - a pair's crossing test depends on the pixel's row, and on its
//   column only in the last compare. A tile's pixels lie in a few
//   bitmap rows, so the block tests each staged segment once against
//   each of those rows and lists the crossings by row (sdf_pair.cuh,
//   RowLists); a pixel then sums its row's few crossings. The loop over
//   the segments keeps the 16 distance operations of the 22 and no
//   compare, select or integer add: 16 f32 operations a pair and 2 a
//   (row, segment), where the test done pair by pair makes it 22
//   (tools/work.py counts the bound by this route). A tile of more than kRowsMax
//   rows (a bitmap under 4 pixels wide at TP = 256) or a row with more
//   than kRowCross crossings in one chunk takes the loop with all 22.
// Rows whose pix_base is at or past w*h write zeros.
//
// Parity with the plain version (ops/sdf_torch.render_tiles_pts) is
// byte equality: min and an integer sum do not depend on the order of
// the segments, and no expression changed shape. The build passes
// --fmad=false so that no multiply and add contract into an FMA, and
// the divides and the square root are the correctly rounded intrinsics.
// 1/l2 and 1/dy are reciprocals that multiply, as on the TPU; they are
// not folded into one divide. The per-pixel math is shared with the
// other kernels (sdf_pair.cuh), and the tile's body (`render_tile`) with
// sdf_tiles_flat.cu, which stages a segment soup where this kernel
// stages the chain's live lanes (`ChainStaging`).

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(1024 / R) sdf_tiles_pts_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  vg::render_tile<R>(vg::ChainStaging{pts, n_lanes, mask_words}, tmeta, n_tiles, scale, cutoff,
                     out);
}

template <int R>
void launch_r(const float* pts, int n_lanes, const int32_t* mask_words, const int32_t* tmeta,
              int n_tiles, int tp, float scale, float cutoff, uint8_t* out,
              cudaStream_t stream) {
  sdf_tiles_pts_kernel<R><<<n_tiles, tp / R, 0, stream>>>(
      pts, n_lanes, mask_words, tmeta, n_tiles, scale, cutoff, out);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, out
// [n_tiles, tp] u8. tp is the tile's pixel count and r the pixels a
// thread (1 or 2; tp / r is the block size, a multiple of 32, at most
// 1024 / r). The caller checks shapes and bounds.
extern "C" int vg_sdf_tiles_pts(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, int r, float scale, float cutoff, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  if ((r != 1 && r != 2) || tp % (32 * r)) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = r == 2 ? launch_r<2> : launch_r<1>;
  launch(static_cast<const float*>(pts), n_lanes, static_cast<const int32_t*>(mask_words),
         static_cast<const int32_t*>(tmeta), n_tiles, tp, scale, cutoff,
         static_cast<uint8_t*>(out), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
