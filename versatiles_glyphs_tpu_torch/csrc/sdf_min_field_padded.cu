// Min-field kernel of the padded-layout fitting forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// versatiles_glyphs_tpu/ops/sdf_grad.py (launched by `_run_fwd`, reached
// from the custom VJP `_min_d2_wn` of `signed_field_pallas`). Per pixel
// of each glyph's w x h bitmap (flat PBF order, the first P pixels) it
// emits the min of d^2 over the glyph's live segments, the winding
// number and the FIRST argmin segment: the facts the backward
// (sdf_min_field_padded_bwd.cu) needs to route the gradient of the hard
// min. Segments are padded per glyph: segs [B, S, 4] f32 (vx, vy, wx,
// wy), mask [B, S] f32 (nonzero = live), meta [B, 4] i32 (x0, y0, w, h).
//
// The TPU's paddings (pixels to a multiple of 1024, segments to a
// multiple of 128) are artefacts of its layout: this kernel takes S and
// P as they are and writes [B, P]. The TPU splits rows by f32 division,
// which equals integer div and mod for every pixel index below 2^23;
// the wrapper checks P against that bound.
//
// Bound: f32 instruction slots, as the render kernels. The function is
// counted by tools/work.row_shared_work (16 f32 operations a (pixel,
// live segment) pair, 2 a bitmap row and segment, 4 a crossing and 1 a
// pixel of its row) against 20 bytes of global reads a segment and
// block and 12 bytes written a pixel. The design spends as few other
// slots as it can:
//
// - grid (B, ceil(P / (R * NT))), a block of NT threads a glyph and span
//   of R * NT pixels, thread tid owning pixels tid, tid + NT, ... of the
//   span with their running min of d^2, first argmin and winding count
//   in registers. The launcher sizes NT so that the spans of a glyph
//   cover P evenly (ops/sdf_cuda.padded_launch_shape); where P fits one
//   span the glyph is staged, and its two divides a segment paid, once.
//   Slots of NT pixels wholly past P are not computed: a span with
//   fewer than R live slots (the last of a glyph, where P does not fill
//   it) runs its live slots one after the other, one pixel a thread.
//   Pixels in [w*h, P) are computed like the others, from their rows
//   below the bitmap; pixels of a live slot past P are computed and not
//   stored;
// - only live segments are staged, compacted in segment order by warp
//   ballot over the mask (sdf_pair.cuh, `stage_masked`), in chunks of
//   kRecChunk segments, so the loop has no validity branch; a chunk with
//   no live segment is skipped whole;
// - a staged segment is one 32-byte record read by two 16-byte
//   broadcast loads that serve the thread's R pixels. Its spare word
//   carries the segment's index in [0, S), which is what the argmin
//   must be (the backward reads it as an index into segs [B, S, 4]) and
//   is not the slot once masked segments are left out;
// - the running (dmin, amin) pair updates on a strict `<` while the
//   staged segments go up in index order, so ties keep the smallest
//   segment, and a pixel with every segment masked keeps 3e38 and the
//   sentinel 2^31 - 1 (kernel 2's rule; the TPU kernel merges per-chunk
//   first minima to the same result);
// - the winding goes by bitmap row as in the render kernels (`RowLists`):
//   the block tests each staged segment once against each row of its
//   span and a pixel sums its row's few crossings, so the loop over the
//   segments, unrolled by four, keeps a pair's 16 distance operations,
//   one compare and two selects. A span of more than kRowsMax rows (a
//   bitmap under 6 pixels wide at the launcher's 384 pixels a span) or a
//   row with more than kRowCross crossings in one chunk takes the loop
//   that tests every pair's crossing.
//
// Parity with the plain version (ops/sdf_torch.min_field_padded): d^2
// bit for bit, winding and argmin exactly, under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

constexpr int kMaxR = 4;          // pixels a thread, at most
constexpr int kMaxThreads = 256;  // threads a block, at most

// Pixels r.base + tid + k * NT, k < R, of the glyph in row r (segs
// [n_seg, 4], mask [n_seg]) against its live segments; stores those
// below n_pix.
template <int R>
__device__ __forceinline__ void min_field_span(
    const vg::SegRecords& seg, vg::RowLists& rows, const float* __restrict__ segs,
    const float* __restrict__ mask, int n_seg, const vg::TileRow& r, int n_pix,
    float* __restrict__ d2_out, int32_t* __restrict__ wn_out, int32_t* __restrict__ am_out) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  // Bitmap rows of the span's pixels [base, base + R * NT).
  const int ws = max(r.w, 1);
  const int row0 = r.base / ws;
  const int nrows = (r.base + nt * R - 1) / ws - row0 + 1;
  const bool use_rows = nrows <= vg::kRowsMax;
  vg::MinPixels<R> px;
  px.init(r, r.base + tid, nt, row0);
  for (int c0 = 0; c0 < n_seg; c0 += vg::kRecChunk) {
    const int n = seg.stage_masked(segs, mask, c0, min(c0 + vg::kRecChunk, n_seg));
    if (n == 0) continue;  // the same for every thread of the block
    if (use_rows) rows.clear(nrows);
    __syncthreads();
    seg.reduce<R>(n, px, rows, use_rows, r, row0, nrows);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = r.base + tid + k * nt;
    if (p < n_pix) {
      d2_out[p] = px.dmin[k];
      wn_out[p] = px.wn[k];
      am_out[p] = px.amin[k];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) sdf_min_field_padded_kernel(
    const float* __restrict__ segs, const float* __restrict__ mask, int n_seg,
    const int32_t* __restrict__ meta, int n_pix,
    float* __restrict__ d2_out, int32_t* __restrict__ wn_out,
    int32_t* __restrict__ am_out) {
  __shared__ float4 smem[2 * vg::kRecChunk];
  __shared__ vg::RowLists rows;
  const vg::SegRecords seg(smem);

  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int32_t* m = meta + 4 * static_cast<size_t>(b);
  vg::TileRow r;
  r.x0 = m[0];
  r.y0 = m[1];
  r.w = m[2];
  r.h = m[3];
  r.npts = r.off = 0;  // unused here
  r.base = blockIdx.y * nt * R;

  const float* gs = segs + static_cast<size_t>(b) * n_seg * 4;
  const float* gm = mask + static_cast<size_t>(b) * n_seg;
  const size_t o = static_cast<size_t>(b) * n_pix;
  // Slots of NT pixels of this span that hold a pixel below P: the same
  // for every thread of the block, and at least one by the grid.
  const int slots = min((n_pix - r.base + nt - 1) / nt, R);
  if (slots == R) {
    min_field_span<R>(seg, rows, gs, gm, n_seg, r, n_pix, d2_out + o, wn_out + o, am_out + o);
    return;
  }
  if constexpr (R > 1) {
    for (int s = 0; s < slots; ++s, r.base += nt)
      min_field_span<1>(seg, rows, gs, gm, n_seg, r, n_pix, d2_out + o, wn_out + o, am_out + o);
  }
}

template <int R>
void launch_r(const float* segs, const float* mask, int n_glyphs, int n_seg, const int32_t* meta,
              int n_pix, int nt, float* d2, int32_t* wn, int32_t* am, cudaStream_t stream) {
  const int span = nt * R;
  const dim3 grid(n_glyphs, (n_pix + span - 1) / span);
  sdf_min_field_padded_kernel<R><<<grid, nt, 0, stream>>>(
      segs, mask, n_seg, meta, n_pix, d2, wn, am);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: segs [n_glyphs,
// n_seg, 4] f32 (16-byte aligned), mask [n_glyphs, n_seg] f32, meta
// [n_glyphs, 4] i32, and the outputs d2 f32, wn i32, am i32, each
// [n_glyphs, n_pix]. nt is the block size (a multiple of 32, at most
// 256) and r the pixels a thread (1 to 4); a glyph takes
// ceil(n_pix / (nt * r)) blocks. The caller checks shapes and
// n_pix <= 2^23.
extern "C" int vg_sdf_min_field_padded(
    const void* segs, const void* mask, int n_glyphs, int n_seg, const void* meta,
    int n_pix, int nt, int r, void* d2, void* wn, void* am, void* stream) {
  if (n_glyphs == 0 || n_pix == 0) return 0;
  if (nt % 32 || nt < 32 || nt > kMaxThreads || r < 1 || r > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = r == 4 ? launch_r<4> : r == 3 ? launch_r<3> : r == 2 ? launch_r<2> : launch_r<1>;
  launch(static_cast<const float*>(segs), static_cast<const float*>(mask), n_glyphs, n_seg,
         static_cast<const int32_t*>(meta), n_pix, nt, static_cast<float*>(d2),
         static_cast<int32_t*>(wn), static_cast<int32_t*>(am), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
