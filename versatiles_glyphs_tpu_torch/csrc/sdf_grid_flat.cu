// SDF kernel over the flat segment layout on a padded [G, P] grid, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel` in
// versatiles_glyphs_tpu/ops/legacy.py (launched by
// `render_bitmaps_pallas`). The per-pixel math is kernel 6's
// (sdf_tiles_flat.cu) over the same segment soup, flat [4, N] f32 rows
// vx, vy, wx, wy; only the pixel base comes from the grid instead of a
// tile table, so every glyph pays P pixels.
//
// Work: grid (G, P / TP), one thread block per (glyph, pixel tile) and
// one thread per pixel (blockDim.x == TP). Glyph g's row of meta [G, 8]
// i32 is x0, y0, w, h, nseg, seg_off, _, _; its segments are lanes
// [seg_off, seg_off + nseg), staged through shared memory in chunks of
// TP with their divides done once (sdf_pair.cuh). A tile whose base is
// at or past w*h writes zeros. The pixels in [w*h, P) of a live tile
// are computed from their out-of-range coordinates (rows below the
// bitmap), as the TPU kernel does.
//
// The TPU kernel writes the crossing test in its up/down form
// (`up = vy <= py < wy`, `dn = wy <= py < vy`, step up - dn); the shared
// parity form of sdf_pair.cuh, (vy <= py) != (wy <= py) with the sign
// of vy <= py, is the same test: up | dn is the parity, and up holds
// exactly where vy <= py does among crossing segments.
//
// Bound: FP32 ALU, as kernel 1; the grid pays G * P pixels where a tile
// table (kernel 6) pays sum(ceil(w*h / TP)) * TP.
//
// Parity with the plain version (ops/sdf_torch.render_grid_flat) is
// byte equality, under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_grid_flat_kernel(
    const float* __restrict__ flat, int n_lanes,
    const int32_t* __restrict__ meta, int n_pix,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const vg::SegChunk seg(smem, blockDim.x);

  const int g = blockIdx.x;
  const int base = blockIdx.y * blockDim.x;
  const int32_t* m = meta + 8 * static_cast<size_t>(g);
  vg::TileRow r;
  r.x0 = m[0];
  r.y0 = m[1];
  r.w = m[2];
  r.h = m[3];
  r.npts = m[4];  // nseg
  r.off = m[5];   // seg_off
  r.base = base;
  uint8_t* dst = out + static_cast<size_t>(g) * n_pix + base + threadIdx.x;

  if (base >= r.w * r.h) {  // the same for every thread of the block
    *dst = 0;
    return;
  }

  float pxc, pyc;
  vg::pixel_center(r, base + threadIdx.x, pxc, pyc);
  int wn = 0;
  const float dmin = vg::soup_min_d2(seg, flat, n_lanes, r.off, r.npts, pxc, pyc, wn);
  *dst = vg::sdf_byte(dmin, wn, scale, cutoff);
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: flat [4, n_lanes]
// f32, meta [n_glyphs, 8] i32, out [n_glyphs, n_pix] u8. tp is the
// block size (a multiple of 32, at most 1024) and divides n_pix. The
// caller checks shapes and that every glyph's lanes lie in
// [0, n_lanes).
extern "C" int vg_sdf_grid_flat(
    const void* flat, int n_lanes, const void* meta, int n_glyphs, int n_pix,
    int tp, float scale, float cutoff, void* out, void* stream) {
  if (n_glyphs == 0 || n_pix == 0) return 0;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(tp) * sizeof(float);
  const dim3 grid(n_glyphs, n_pix / tp);
  sdf_grid_flat_kernel<<<grid, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flat), n_lanes,
      static_cast<const int32_t*>(meta), n_pix, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
