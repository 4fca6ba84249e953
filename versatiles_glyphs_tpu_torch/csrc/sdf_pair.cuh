// Per-pixel SDF math shared by the port's Hopper kernels
// (sdf_tiles_pts.cu, sdf_min_field_pts.cu, sdf_min_field_bwd.cu,
// sdf_tiles_flat.cu, sdf_grid_flat.cu, sdf_min_field_padded.cu,
// sdf_min_field_padded_bwd.cu, sdf_tiles_pts_acc.cu).
//
// One definition of the tile-row read, the pixel center, the
// point-to-segment projection, the crossing test and the quantization
// keeps the kernels on one f32 op order, which is the op order of
// ops/sdf_torch.py and of the JAX package's ops/sdf_jax.py and
// ops/sdf_grad.py. The build passes --fmad=false, so no multiply and
// add here contract into an FMA.

#pragma once

#include <cstdint>

namespace vg {

constexpr float kBig = 3.0e38f;       // distance of a masked segment
constexpr int32_t kBigI = 2147483647;  // argmin of a pixel with no live segment

// One row of the tile table tmeta [8, n_tiles] i32.
struct TileRow {
  int x0, y0, w, h, npts, off, base;
};

__device__ __forceinline__ TileRow load_tile(const int32_t* __restrict__ tmeta,
                                             int n_tiles, int t) {
  TileRow r;
  r.x0 = tmeta[0 * n_tiles + t];
  r.y0 = tmeta[1 * n_tiles + t];
  r.w = tmeta[2 * n_tiles + t];
  r.h = tmeta[3 * n_tiles + t];
  r.npts = tmeta[4 * n_tiles + t];
  r.off = tmeta[5 * n_tiles + t];
  r.base = tmeta[6 * n_tiles + t];
  return r;
}

// Center of flat pixel i of the row's w x h bitmap, in PBF order (rows
// from the top, so y is flipped). Row and column come from integer
// div/mod.
__device__ __forceinline__ void pixel_center(const TileRow& r, int i, float& pxc,
                                             float& pyc) {
  const int ws = max(r.w, 1);
  const int row = i / ws;
  const int x = i - row * ws;
  const int y = r.h - 1 - row;
  pxc = static_cast<float>(r.x0) + static_cast<float>(x) + 0.5f;
  pyc = static_cast<float>(r.y0) + static_cast<float>(y) + 0.5f;
}

// 1/l2 of a segment (0 for a zero-length one): a correctly rounded
// reciprocal that multiplies, as on the TPU.
__device__ __forceinline__ float l2_inverse(float dx, float dy) {
  const float l2 = dx * dx + dy * dy;
  return l2 > 0.0f ? __fdiv_rn(1.0f, l2) : 0.0f;
}

// Projection of the pixel offset (ex, ey) = p - v onto the segment
// v + s*(dx, dy): clamped parameter tc and residual q = p - (v + tc*d).
__device__ __forceinline__ void project(float ex, float ey, float dx, float dy,
                                        float l2inv, float& tc, float& qx,
                                        float& qy) {
  const float num = ex * dx + ey * dy;
  tc = fminf(fmaxf(num * l2inv, 0.0f), 1.0f);
  qx = ex - tc * dx;
  qy = ey - tc * dy;
}

// Segment chunk staged in shared memory by a block of tp threads (tp is
// the block size, which is the tile's pixel count except in
// sdf_tiles_pts_acc.cu): the
// derived terms of segment (pts[:, lane], pts[:, lane + 1]) at index
// lane - c0, divides paid once per segment and block.
struct SegChunk {
  float *vx, *vy, *wy, *dx, *dy, *l2inv, *dyinv;
  int* ok;

  // Carves 8 arrays of tp words out of smem.
  __device__ __forceinline__ SegChunk(float* smem, int tp) {
    vx = smem;
    vy = vx + tp;
    wy = vy + tp;
    dx = wy + tp;
    dy = dx + tp;
    l2inv = dy + tp;
    dyinv = l2inv + tp;
    ok = reinterpret_cast<int*>(dyinv + tp);
  }

  // Thread tid stages segment (v, w) with its validity.
  __device__ __forceinline__ void put(int tid, float v_x, float v_y, float w_x,
                                      float w_y, bool valid) const {
    const float d_x = w_x - v_x;
    const float d_y = w_y - v_y;
    vx[tid] = v_x;
    vy[tid] = v_y;
    wy[tid] = w_y;
    dx[tid] = d_x;
    dy[tid] = d_y;
    l2inv[tid] = l2_inverse(d_x, d_y);
    dyinv[tid] = d_y != 0.0f ? __fdiv_rn(1.0f, d_y) : 0.0f;
    ok[tid] = valid;
  }

  // Point-chain layout: thread tid stages lane (caller guarantees
  // lane + 1 < n_lanes), live iff its mask bit is set.
  __device__ __forceinline__ void stage(const float* __restrict__ pts, int n_lanes,
                                        const int32_t* __restrict__ mask_words,
                                        int lane, int tid) const {
    const uint32_t word = static_cast<uint32_t>(mask_words[lane >> 5]);
    put(tid, pts[lane], pts[n_lanes + lane], pts[lane + 1], pts[n_lanes + lane + 1],
        (word >> (lane & 31)) & 1u);
  }

  // Segment-soup layout flat [4, n_lanes] (rows vx, vy, wx, wy): thread
  // tid stages the live segment at lane.
  __device__ __forceinline__ void stage_soup(const float* __restrict__ flat,
                                             int n_lanes, int lane, int tid) const {
    put(tid, flat[lane], flat[n_lanes + lane], flat[2 * n_lanes + lane],
        flat[3 * n_lanes + lane], true);
  }

  // d^2 from pixel (pxc, pyc) to staged segment j, and its step of the
  // winding count (+1 upward crossing left of the pixel, -1 downward).
  // The crossing test is the parity form: the row crosses iff
  // (vy <= py) != (wy <= py), upward iff vy <= py. That is the half-open
  // up/down form vy <= py < wy (+1), wy <= py < vy (-1) of the older TPU
  // kernels (ops/legacy.py) written with two compares fewer.
  __device__ __forceinline__ float d2_and_winding(int j, float pxc, float pyc,
                                                  int& wn) const {
    const float v_x = vx[j];
    const float v_y = vy[j];
    const float d_x = dx[j];
    const float d_y = dy[j];
    const float ex = pxc - v_x;
    const float ey = pyc - v_y;
    float tc, qx, qy;
    project(ex, ey, d_x, d_y, l2inv[j], tc, qx, qy);
    const bool c1 = v_y <= pyc;
    const bool cross = c1 != (wy[j] <= pyc);
    const float cx = v_x + (ey * dyinv[j]) * d_x;
    if (cross && cx <= pxc) wn += c1 ? 1 : -1;
    return qx * qx + qy * qy;
  }
};

constexpr int kSegChunkWords = 8;  // shared words per thread of SegChunk

// Min of d^2 and the winding count of pixel (pxc, pyc) over a glyph's
// segment soup, lanes [off, off + nseg) of flat [4, n_lanes], staged
// in chunks of tp = blockDim.x. Every thread of the block calls it with
// the same off and nseg (it synchronizes the block).
__device__ __forceinline__ float soup_min_d2(const SegChunk& seg,
                                             const float* __restrict__ flat,
                                             int n_lanes, int off, int nseg,
                                             float pxc, float pyc, int& wn) {
  const int tp = blockDim.x;
  const int tid = threadIdx.x;
  float dmin = kBig;
  for (int c0 = 0; c0 < nseg; c0 += tp) {
    if (c0 + tid < nseg) seg.stage_soup(flat, n_lanes, off + c0 + tid, tid);
    __syncthreads();
    const int n = min(tp, nseg - c0);
    for (int j = 0; j < n; ++j) dmin = fminf(dmin, seg.d2_and_winding(j, pxc, pyc, wn));
    __syncthreads();
  }
  return dmin;
}

// The SDF byte of a pixel: clamp(255 - (+-sqrt(d^2)*scale + cutoff)),
// negative inside (winding != 0), rounded by floor(x + 0.5).
__device__ __forceinline__ uint8_t sdf_byte(float dmin, int wn, float scale,
                                            float cutoff) {
  float d = __fsqrt_rn(dmin);
  if (wn != 0) d = -d;
  const float v = d * scale + cutoff;
  const float n = fminf(fmaxf(255.0f - v, 0.0f), 255.0f);
  return static_cast<uint8_t>(floorf(n + 0.5f));
}

}  // namespace vg
