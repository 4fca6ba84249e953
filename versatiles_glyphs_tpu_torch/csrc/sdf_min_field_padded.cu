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
// Work: grid (B, ceil(P / TP)), one thread block per (glyph, pixel
// tile) and one thread per pixel. The glyph's segments and mask are
// staged through shared memory in chunks of TP, with their divides done
// once (sdf_pair.cuh). The running (dmin, amin) pair stays in registers
// and updates on a strict `<` while segments go up, so ties keep the
// smallest segment and a pixel with every segment masked keeps the
// sentinel 2^31 - 1 (kernel 2's rule; the TPU kernel merges per-chunk
// first minima to the same result). Pixels past w*h are computed like
// the others; threads past P stage and synchronize but write nothing.
//
// Bound: FP32 ALU, B * P * S pairs of ~30 flops; global traffic is 20
// bytes a segment per block and 12 bytes a pixel. Parity with the plain
// version (ops/sdf_torch.min_field_padded): d^2 bit for bit, winding and
// argmin exactly, under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_min_field_padded_kernel(
    const float* __restrict__ segs, const float* __restrict__ mask, int n_seg,
    const int32_t* __restrict__ meta, int n_pix,
    float* __restrict__ d2_out, int32_t* __restrict__ wn_out,
    int32_t* __restrict__ am_out) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  const vg::SegChunk seg(smem, tp);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = blockIdx.y * tp + tid;
  const int32_t* m = meta + 4 * static_cast<size_t>(b);
  vg::TileRow r;
  r.x0 = m[0];
  r.y0 = m[1];
  r.w = m[2];
  r.h = m[3];
  r.npts = r.off = r.base = 0;  // unused here
  float pxc, pyc;
  vg::pixel_center(r, i, pxc, pyc);

  const float* gs = segs + static_cast<size_t>(b) * n_seg * 4;
  const float* gm = mask + static_cast<size_t>(b) * n_seg;
  float dmin = vg::kBig;
  int amin = vg::kBigI;
  int wn = 0;
  for (int c0 = 0; c0 < n_seg; c0 += tp) {
    const int s = c0 + tid;
    if (s < n_seg) {
      const float* v = gs + 4 * static_cast<size_t>(s);
      seg.put(tid, v[0], v[1], v[2], v[3], gm[s] != 0.0f);
    }
    __syncthreads();
    const int n = min(tp, n_seg - c0);
    for (int j = 0; j < n; ++j) {
      if (!seg.ok[j]) continue;  // the same segment for every thread
      const float d2 = seg.d2_and_winding(j, pxc, pyc, wn);
      if (d2 < dmin) {
        dmin = d2;
        amin = c0 + j;
      }
    }
    __syncthreads();
  }

  if (i < n_pix) {
    const size_t o = static_cast<size_t>(b) * n_pix + i;
    d2_out[o] = dmin;
    wn_out[o] = wn;
    am_out[o] = amin;
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: segs [n_glyphs,
// n_seg, 4] f32, mask [n_glyphs, n_seg] f32, meta [n_glyphs, 4] i32, and
// the outputs d2 f32, wn i32, am i32, each [n_glyphs, n_pix]. tp is the
// block size (a multiple of 32, at most 1024). The caller checks shapes
// and n_pix <= 2^23.
extern "C" int vg_sdf_min_field_padded(
    const void* segs, const void* mask, int n_glyphs, int n_seg, const void* meta,
    int n_pix, int tp, void* d2, void* wn, void* am, void* stream) {
  if (n_glyphs == 0 || n_pix == 0) return 0;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(tp) * sizeof(float);
  const dim3 grid(n_glyphs, (n_pix + tp - 1) / tp);
  sdf_min_field_padded_kernel<<<grid, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segs), static_cast<const float*>(mask), n_seg,
      static_cast<const int32_t*>(meta), n_pix,
      static_cast<float*>(d2), static_cast<int32_t*>(wn), static_cast<int32_t*>(am));
  return static_cast<int>(cudaGetLastError());
}
