// Min-field kernel of the outline-fitting forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sdf_kernel_tiles_pts_min` in
// versatiles_glyphs_tpu/ops/sdf_pallas.py (launched by
// `min_field_pallas_pts`, reached from the fitting forward
// `ops/sdf_grad._signed_field_flat_tpu_fwd`). Per pixel it emits the
// min of d^2 over the glyph's live segments, the winding number and the
// global lane of the FIRST argmin segment: the facts the backward
// (sdf_min_field_bwd.cu) needs to route the gradient of the hard min.
//
// Work: as in sdf_tiles_pts.cu, one thread block per tile-table row and
// one thread per pixel; each chunk of TP segments is staged in shared
// memory with its divides done once; d^2, argmin and winding stay in
// registers. The running (dmin, amin) pair updates on a strict `<` while
// the lanes go up, so ties keep the smallest lane, and a pixel with no
// live segment keeps the sentinel 2^31 - 1. Rows whose pix_base is at or
// past w*h write zeros in all three outputs; pixels past w*h in a live
// row are computed like the others (the backward drops them).
//
// Bound: FP32 ALU, as the render kernel; the three outputs are 12 bytes
// a pixel. It keeps SegChunk's loop (one pixel a thread, a validity
// branch a staged segment, a crossing test a pair: 22 f32 operations a
// pair executed), while its bound counts the function by
// tools/work.row_shared_work; SegRecords' masked staging, MinPixels and
// row lists (sdf_min_field_padded.cu) fit it as they are. Parity with the plain version (ops/sdf_torch.min_field_pts):
// d^2 bit for bit, winding and argmin exactly, by the shared op order of
// sdf_pair.cuh under --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

__global__ void sdf_min_field_pts_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float* __restrict__ d2_out, int32_t* __restrict__ wn_out,
    int32_t* __restrict__ am_out) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  const vg::SegChunk seg(smem, tp);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const vg::TileRow r = vg::load_tile(tmeta, n_tiles, t);
  const size_t o = static_cast<size_t>(t) * tp + tid;

  if (r.base >= r.w * r.h) {  // the same for every thread of the block
    d2_out[o] = 0.0f;
    wn_out[o] = 0;
    am_out[o] = 0;
    return;
  }

  float pxc, pyc;
  vg::pixel_center(r, r.base + tid, pxc, pyc);

  float dmin = vg::kBig;
  int amin = vg::kBigI;
  int wn = 0;
  const int last = r.off + r.npts - 1;  // segments are lanes [off, last)
  for (int c0 = r.off; c0 < last; c0 += tp) {
    const int lane = c0 + tid;
    if (lane < last) seg.stage(pts, n_lanes, mask_words, lane, tid);
    __syncthreads();
    const int nseg = min(tp, last - c0);
    for (int j = 0; j < nseg; ++j) {
      if (!seg.ok[j]) continue;  // the same segment for every thread
      const float d2 = seg.d2_and_winding(j, pxc, pyc, wn);
      if (d2 < dmin) {
        dmin = d2;
        amin = c0 + j;
      }
    }
    __syncthreads();
  }

  d2_out[o] = dmin;
  wn_out[o] = wn;
  am_out[o] = amin;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, and the
// outputs d2 f32, wn i32, am i32, each [n_tiles, tp]. tp is the block
// size (a multiple of 32, at most 1024). The caller checks shapes and
// bounds.
extern "C" int vg_sdf_min_field_pts(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, void* d2, void* wn, void* am, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = vg::kSegChunkWords * static_cast<size_t>(tp) * sizeof(float);
  sdf_min_field_pts_kernel<<<n_tiles, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(mask_words),
      static_cast<const int32_t*>(tmeta), n_tiles,
      static_cast<float*>(d2), static_cast<int32_t*>(wn),
      static_cast<int32_t*>(am));
  return static_cast<int>(cudaGetLastError());
}
