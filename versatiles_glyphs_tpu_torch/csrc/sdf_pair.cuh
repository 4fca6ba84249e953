// Per-pixel SDF math shared by the port's Hopper kernels
// (sdf_tiles_pts.cu, sdf_min_field_pts.cu, sdf_min_field_bwd.cu).
//
// One definition of the tile-row read, the pixel center and the
// point-to-segment projection keeps the three kernels on one f32 op
// order, which is the op order of ops/sdf_torch.py and of the JAX
// package's ops/sdf_jax.py. The build passes --fmad=false, so no
// multiply and add here contract into an FMA.

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

// Segment chunk staged in shared memory by a block of tp threads: the
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

  // Thread tid stages lane (caller guarantees lane + 1 < n_lanes).
  __device__ __forceinline__ void stage(const float* __restrict__ pts, int n_lanes,
                                        const int32_t* __restrict__ mask_words,
                                        int lane, int tid) const {
    const float v_x = pts[lane];
    const float v_y = pts[n_lanes + lane];
    const float w_x = pts[lane + 1];
    const float w_y = pts[n_lanes + lane + 1];
    const float d_x = w_x - v_x;
    const float d_y = w_y - v_y;
    const uint32_t word = static_cast<uint32_t>(mask_words[lane >> 5]);
    vx[tid] = v_x;
    vy[tid] = v_y;
    wy[tid] = w_y;
    dx[tid] = d_x;
    dy[tid] = d_y;
    l2inv[tid] = l2_inverse(d_x, d_y);
    dyinv[tid] = d_y != 0.0f ? __fdiv_rn(1.0f, d_y) : 0.0f;
    ok[tid] = (word >> (lane & 31)) & 1u;
  }

  // d^2 from pixel (pxc, pyc) to staged segment j, and its step of the
  // winding count (+1 upward crossing left of the pixel, -1 downward).
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

}  // namespace vg
