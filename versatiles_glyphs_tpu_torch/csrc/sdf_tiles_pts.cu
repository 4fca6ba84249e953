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
// Work: one thread block per tile-table row, one thread per pixel
// (blockDim.x == TP). Each block reads its own row of the tile table
// (tmeta [8, T] i32: x0, y0, w, h, npts, off, pix_base, _) and walks
// its glyph's lane run [off, off + npts - 1) of the flat point chain
// (pts [2, N] f32; segment i = (pts[:, i], pts[:, i + 1]), live iff
// bit i of mask_words is set) in chunks of TP segments. Per chunk each
// thread stages one segment's derived terms (dx, dy, 1/l2, 1/dy) in
// shared memory, so those divides are paid once per segment and block;
// then every thread reads the chunk by broadcast and keeps the running
// min of d^2 and the winding count in registers. Rows whose pix_base is
// at or past w*h write zeros.
//
// Bound: FP32 ALU. About 30 flops per (pixel, segment) pair against a
// few bytes of global traffic per segment per block, so everything the
// inner loop touches is on-chip. wgmma, TMA and tuning are later work.
//
// Parity with the plain version (ops/sdf_torch.render_tiles_pts) is
// byte equality. The build passes --fmad=false so that no multiply and
// add contract into an FMA, and the divides and the square root are
// the correctly rounded intrinsics. 1/l2 and 1/dy are reciprocals that
// multiply, as on the TPU; they are not folded into one divide. Rows
// and columns come from integer div/mod, as in ops/sdf_jax.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;  // distance of a masked segment

__global__ void sdf_tiles_pts_kernel(
    const float* __restrict__ pts, int n_lanes,
    const int32_t* __restrict__ mask_words,
    const int32_t* __restrict__ tmeta, int n_tiles,
    float scale, float cutoff,
    uint8_t* __restrict__ out) {
  extern __shared__ float smem[];
  const int tp = blockDim.x;
  float* s_vx = smem;
  float* s_vy = s_vx + tp;
  float* s_wy = s_vy + tp;
  float* s_dx = s_wy + tp;
  float* s_dy = s_dx + tp;
  float* s_l2inv = s_dy + tp;
  float* s_dyinv = s_l2inv + tp;
  int* s_ok = reinterpret_cast<int*>(s_dyinv + tp);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int x0 = tmeta[0 * n_tiles + t];
  const int y0 = tmeta[1 * n_tiles + t];
  const int w = tmeta[2 * n_tiles + t];
  const int h = tmeta[3 * n_tiles + t];
  const int npts = tmeta[4 * n_tiles + t];
  const int off = tmeta[5 * n_tiles + t];
  const int base = tmeta[6 * n_tiles + t];
  uint8_t* dst = out + static_cast<size_t>(t) * tp + tid;

  if (base >= w * h) {  // the same for every thread of the block
    *dst = 0;
    return;
  }

  const int i = base + tid;
  const int ws = max(w, 1);
  const int row = i / ws;
  const int x = i - row * ws;
  const int y = h - 1 - row;
  const float pxc = static_cast<float>(x0) + static_cast<float>(x) + 0.5f;
  const float pyc = static_cast<float>(y0) + static_cast<float>(y) + 0.5f;

  float dmin = kBig;
  int wn = 0;
  const int last = off + npts - 1;  // segments are lanes [off, last)
  for (int c0 = off; c0 < last; c0 += tp) {
    const int lane = c0 + tid;
    if (lane < last) {
      const float vx = pts[lane];
      const float vy = pts[n_lanes + lane];
      const float wx = pts[lane + 1];
      const float wy = pts[n_lanes + lane + 1];
      const float dx = wx - vx;
      const float dy = wy - vy;
      const float l2 = dx * dx + dy * dy;
      const uint32_t word = static_cast<uint32_t>(mask_words[lane >> 5]);
      s_vx[tid] = vx;
      s_vy[tid] = vy;
      s_wy[tid] = wy;
      s_dx[tid] = dx;
      s_dy[tid] = dy;
      s_l2inv[tid] = l2 > 0.0f ? __fdiv_rn(1.0f, l2) : 0.0f;
      s_dyinv[tid] = dy != 0.0f ? __fdiv_rn(1.0f, dy) : 0.0f;
      s_ok[tid] = (word >> (lane & 31)) & 1u;
    }
    __syncthreads();
    const int nseg = min(tp, last - c0);
    for (int j = 0; j < nseg; ++j) {
      if (!s_ok[j]) continue;  // the same segment for every thread
      const float vx = s_vx[j];
      const float vy = s_vy[j];
      const float dx = s_dx[j];
      const float dy = s_dy[j];
      const float ex = pxc - vx;
      const float ey = pyc - vy;
      const float num = ex * dx + ey * dy;
      const float tc = fminf(fmaxf(num * s_l2inv[j], 0.0f), 1.0f);
      const float qx = ex - tc * dx;
      const float qy = ey - tc * dy;
      dmin = fminf(dmin, qx * qx + qy * qy);

      const bool c1 = vy <= pyc;
      const bool cross = c1 != (s_wy[j] <= pyc);
      const float cx = vx + (ey * s_dyinv[j]) * dx;
      if (cross && cx <= pxc) wn += c1 ? 1 : -1;
    }
    __syncthreads();
  }

  float d = __fsqrt_rn(dmin);
  if (wn != 0) d = -d;
  const float v = d * scale + cutoff;
  const float n = fminf(fmaxf(255.0f - v, 0.0f), 255.0f);
  *dst = static_cast<uint8_t>(floorf(n + 0.5f));
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: pts [2, n_lanes]
// f32, mask_words [n_lanes / 32] i32, tmeta [8, n_tiles] i32, out
// [n_tiles, tp] u8. tp is the block size (a multiple of 32, at most
// 1024). The caller checks shapes and bounds.
extern "C" int vg_sdf_tiles_pts(
    const void* pts, int n_lanes, const void* mask_words, const void* tmeta,
    int n_tiles, int tp, float scale, float cutoff, void* out, void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = 8 * static_cast<size_t>(tp) * sizeof(float);
  sdf_tiles_pts_kernel<<<n_tiles, tp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n_lanes,
      static_cast<const int32_t*>(mask_words),
      static_cast<const int32_t*>(tmeta), n_tiles, scale, cutoff,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
