// Chain forward of the fused flat-fit loss, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds the point chain with
// XLA ops (`models/fitting.flat_chain_points`: the translate add, a
// Bernstein matmul, a pad and a gather of 128-point blocks). In the port
// those were five PyTorch ops a step (add, einsum, pad, index_select and
// a transposed copy) and their backward; this kernel writes the chain
// straight into the plan's lane layout in one launch.
//
// Per lane n of pts [2, N]: its chunk's source block chunk_map[n / 128]
// names a glyph g and the position r of the lane in g's chain; the lane
// is live iff r < npts_g and n == lane0_g + r (a chunk of g's run, not a
// slack chunk that repeats block 0). Then c = r / K, j = r % K and, with
// q_i = curve_c's control point i + translate_g (one f32 add),
//   j = 0:      q_0,   j = K - 1:  q_3   (chain ends equal the control
//                                          points bit for bit)
//   otherwise:  ((M_j0 q_0 + M_j1 q_1) + M_j2 q_2) + M_j3 q_3
// in f32, each product and sum rounded once (no TF32, no FMA), M the
// [K, 4] Bernstein matrix at the dyadic parameters. Dead lanes are 0.
// The plain version (ops/flat_loss.chain_fwd_plain) takes this order.
//
// Bound: bytes. A thread a lane writes 8 bytes and reads a curve's 32
// bytes and the glyph's translate, which its curve's K lanes share in
// L1: about 8 bytes a lane plus 40 a curve.

#include <cstdint>

#include <cuda_runtime.h>

#include "flat_loss.cuh"

namespace {

__global__ void __launch_bounds__(vgl::kThreads) flat_chain_fwd_kernel(
    const float* __restrict__ curves, const float* __restrict__ translate,
    const float* __restrict__ bern, const int64_t* __restrict__ chunk_map,
    const int32_t* __restrict__ glyph_rows, int n_lanes, int n_curves, int k, int n_blocks,
    float* __restrict__ pts) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_lanes) return;
  float x = 0.0f, y = 0.0f;
  const long long src = chunk_map[n / vgl::kLaneChunk];
  const int g = static_cast<int>(src / n_blocks);
  const int r = static_cast<int>(src % n_blocks) * vgl::kLaneChunk + n % vgl::kLaneChunk;
  const vgl::GlyphRow G = vgl::load_glyph(glyph_rows, g);
  if (r < G.npts && n == G.lane0 + r) {
    const int c = r / k;
    const int j = r - c * k;
    const float* cv = curves + (static_cast<size_t>(g) * n_curves + c) * 8;
    const float tx = translate[2 * g];
    const float ty = translate[2 * g + 1];
    if (j == 0) {
      x = __fadd_rn(cv[0], tx);
      y = __fadd_rn(cv[1], ty);
    } else if (j == k - 1) {
      x = __fadd_rn(cv[6], tx);
      y = __fadd_rn(cv[7], ty);
    } else {
      const float* m = bern + 4 * j;
      float sx = 0.0f, sy = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float px = __fmul_rn(m[i], __fadd_rn(cv[2 * i], tx));
        const float py = __fmul_rn(m[i], __fadd_rn(cv[2 * i + 1], ty));
        sx = i ? __fadd_rn(sx, px) : px;
        sy = i ? __fadd_rn(sy, py) : py;
      }
      x = sx;
      y = sy;
    }
  }
  pts[n] = x;
  pts[n_lanes + n] = y;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Device pointers: curves [B, n_curves, 4, 2] f32,
// translate [B, 2] f32, bern [k, 4] f32, chunk_map [n_lanes / 128] i64,
// glyph_rows [B, 4] i32 (tile0, w*h, lane0, npts), and the output pts
// [2, n_lanes] f32, every lane written. n_blocks is the 128-point blocks
// of a glyph's padded chain (ceil(n_curves * k / 128)). The caller
// checks shapes and that chunk_map names blocks of the B glyphs and each
// run lies in [0, n_lanes).
extern "C" int vg_flat_chain_fwd(const void* curves, const void* translate, const void* bern,
                                 const void* chunk_map, const void* glyph_rows, int n_lanes,
                                 int n_curves, int k, int n_blocks, void* pts, void* stream) {
  if (n_lanes == 0) return 0;
  if (n_lanes < 0 || n_lanes % vgl::kLaneChunk || n_curves < 1 || k < 2 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_lanes + vgl::kThreads - 1) / vgl::kThreads;
  flat_chain_fwd_kernel<<<grid, vgl::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curves), static_cast<const float*>(translate),
      static_cast<const float*>(bern), static_cast<const int64_t*>(chunk_map),
      static_cast<const int32_t*>(glyph_rows), n_lanes, n_curves, k, n_blocks,
      static_cast<float*>(pts));
  return static_cast<int>(cudaGetLastError());
}
