// SDF kernel over the flat segment layout on a padded [G, P] grid, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel` in
// versatiles_glyphs_tpu/ops/legacy.py (launched by
// `render_bitmaps_pallas`). The per-pixel math is kernel 6's
// (sdf_tiles_flat.cu) over the same segment soup, flat [4, N] f32 rows
// vx, vy, wx, wy; only the pixel base comes from the grid instead of a
// tile table, so every glyph pays its live tiles of TP pixels whole.
//
// Glyph g's row of meta [G, 8] i32 is x0, y0, w, h, nseg, seg_off, _, _;
// its segments are lanes [seg_off, seg_off + nseg), all live. A pixel
// tile (TP pixels, TP divides P) whose base is at or past w*h is zeros.
// The pixels in [w*h, P) of a live tile are computed from their
// out-of-range coordinates (rows below the bitmap), as the TPU kernel
// does.
//
// Bound: f32 instruction slots, as kernel 1 (sdf_tiles_pts.cu): a
// (pixel, segment) pair tested by itself is 22 f32 instructions,
// everything else on-chip; the bound counts the function by the
// row-shared route below (tools/work.row_shared_work: 16 a pair, 2 a
// bitmap row and segment, 4 a crossing, 1 a pixel of its row). The
// design spends as few other slots as it can:
//
// - grid (G, ceil(P / (4 * NT))), a block of NT threads a glyph and
//   span of 4 * NT pixels. A thread owns up to four pixels of the span,
//   tid, tid + NT, ..., with their running min of d^2 and winding count
//   in registers; a block whose span holds one or two live slots of NT
//   pixels runs the loop for those only. At P <= 4 * NT a glyph's soup
//   is staged, and its two divides a segment paid, once and not once a
//   tile;
// - a staged segment is one 32-byte record read by two 16-byte
//   broadcast loads that serve all of the thread's pixels (sdf_pair.cuh,
//   SegRecords), in chunks of kRecChunk segments, the loop unrolled by
//   four;
// - the crossings go by row, as in kernel 1: the block tests each staged
//   segment once against each bitmap row of its span and a pixel sums
//   its row's few crossings (sdf_pair.cuh, RowLists), so the loop over
//   the segments keeps the 16 distance operations of the 22. A span of
//   more than kRowsMax rows or a row with more than kRowCross crossings
//   in one chunk takes the loop with all 22.
//
// The TPU kernel writes the crossing test in its up/down form
// (`up = vy <= py < wy`, `dn = wy <= py < vy`, step up - dn); the shared
// parity form of sdf_pair.cuh, (vy <= py) != (wy <= py) with the sign
// of vy <= py, is the same test: up | dn is the parity, and up holds
// exactly where vy <= py does among crossing segments.
//
// Parity with the plain version (ops/sdf_torch.render_grid_flat) is
// byte equality, under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

constexpr int kMaxR = 4;  // pixels a thread of a full span

// Pixels r.base + tid + k * NT, k < R, of the glyph in row r against its
// whole soup; stores their bytes (zeros at or past live_end).
template <int R>
__device__ __forceinline__ void render_span(
    const vg::SegRecords& seg, vg::RowLists& rows, const float* __restrict__ flat,
    int n_lanes, const vg::TileRow& r, int live_end, int n_pix, float scale, float cutoff,
    uint8_t* __restrict__ dst) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  // Bitmap rows of the span's pixels [base, base + R * NT).
  const int ws = max(r.w, 1);
  const int row0 = r.base / ws;
  const int nrows = (r.base + nt * R - 1) / ws - row0 + 1;
  const bool use_rows = nrows <= vg::kRowsMax;
  vg::Pixels<R> px;
  px.init(r, r.base + tid, nt, row0);
  const int last = r.off + r.npts;  // npts and off hold nseg and seg_off
  for (int c0 = r.off; c0 < last; c0 += vg::kRecChunk) {
    const int cend = min(c0 + vg::kRecChunk, last);
    seg.stage_soup(flat, n_lanes, c0, cend);
    if (use_rows) rows.clear(nrows);
    __syncthreads();
    seg.reduce<R>(cend - c0, px, rows, use_rows, r, row0, nrows);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = r.base + tid + k * nt;
    if (p < n_pix)
      dst[p] = p < live_end ? vg::sdf_byte(px.dmin[k], px.wn[k], scale, cutoff) : 0;
  }
}

// Two blocks an SM at least: ptxas then takes 93 registers for the three
// inlined span widths; held to 64 it spills inside the loop and the
// launch is a tenth slower.
__global__ void __launch_bounds__(256, 2) sdf_grid_flat_kernel(
    const float* __restrict__ flat, int n_lanes,
    const int32_t* __restrict__ meta, int n_pix, int tp,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  __shared__ float4 smem[2 * vg::kRecChunk];
  __shared__ vg::RowLists rows;
  const vg::SegRecords seg(smem);

  const int g = blockIdx.x;
  const int nt = blockDim.x;
  const int32_t* m = meta + 8 * static_cast<size_t>(g);
  vg::TileRow r;
  r.x0 = m[0];
  r.y0 = m[1];
  r.w = m[2];
  r.h = m[3];
  r.npts = m[4];  // nseg
  r.off = m[5];   // seg_off
  r.base = blockIdx.y * nt * kMaxR;
  uint8_t* dst = out + static_cast<size_t>(g) * n_pix;

  // Pixels below live_end lie in a tile whose base is below w*h.
  const int wh = r.w * r.h;
  const int live_end = wh > 0 ? min(n_pix, (wh + tp - 1) / tp * tp) : 0;
  // Slots of NT pixels of this span that hold a live pixel: the same
  // for every thread of the block.
  const int live_here = min(live_end, n_pix) - r.base;
  const int slots = live_here > 0 ? min((live_here + nt - 1) / nt, kMaxR) : 0;
  int done = 0;
  if (slots > 2) {
    render_span<4>(seg, rows, flat, n_lanes, r, live_end, n_pix, scale, cutoff, dst);
    done = 4;
  } else if (slots == 2) {
    render_span<2>(seg, rows, flat, n_lanes, r, live_end, n_pix, scale, cutoff, dst);
    done = 2;
  } else if (slots == 1) {
    render_span<1>(seg, rows, flat, n_lanes, r, live_end, n_pix, scale, cutoff, dst);
    done = 1;
  }
  for (int k = done; k < kMaxR; ++k) {
    const int p = r.base + threadIdx.x + k * nt;
    if (p < n_pix) dst[p] = 0;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: flat [4, n_lanes]
// f32, meta [n_glyphs, 8] i32, out [n_glyphs, n_pix] u8. tp is the
// pixel tile of the function (it divides n_pix) and nt the block size
// (a multiple of 32, at most 256). The caller checks shapes and that
// every glyph's lanes lie in [0, n_lanes).
extern "C" int vg_sdf_grid_flat(
    const void* flat, int n_lanes, const void* meta, int n_glyphs, int n_pix,
    int tp, int nt, float scale, float cutoff, void* out, void* stream) {
  if (n_glyphs == 0 || n_pix == 0) return 0;
  if (nt % 32 || nt < 32 || nt > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int span = nt * kMaxR;
  const dim3 grid(n_glyphs, (n_pix + span - 1) / span);
  sdf_grid_flat_kernel<<<grid, nt, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flat), n_lanes,
      static_cast<const int32_t*>(meta), n_pix, tp, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
