// Backward of the padded-layout fitting min field, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in
// versatiles_glyphs_tpu/ops/sdf_grad.py (launched by `_run_bwd`, reached
// from the custom VJP `_min_d2_wn` of `signed_field_pallas`). Given the
// forward's argmin segment am and the cotangent g of d^2 per pixel, the
// gradient of the hard min flows to the argmin segment alone. With tc
// and q = p - (v + tc*d) recomputed in the forward's op order
// (sdf_pair.cuh, the JAX package's `_pair_terms`), segment s of glyph b
// gets, summed over the pixels p < P whose am is s,
//   dv = sum of 2g*q*(tc - 1)   and   dw = -(sum of 2g*q*tc).
// The segments of the padded layout are independent (segs [B, S, 4]),
// so unlike kernel 3 no sum carries from one segment to the next. The
// TPU kernel's [B, Sp, 128] lane padding of the segments and of the
// output is a layout artefact; this kernel reads segs [B, S, 4] and
// writes dsegs [B, S, 4] (dvx, dvy, dwx, dwy). Pixels past w*h count as
// the TPU kernel counts them (the caller's cotangent masks them); the
// sentinel 2^31 - 1, and any am outside [0, S), adds nothing.
//
// Bound: bytes (25 f32 operations a pixel, tools/work.BWD_PIXEL_F32_OPS,
// against 8 bytes read a pixel and 32 a segment). The work is P terms a
// glyph, and the kernel executes about that: it is pixel-major, and a
// pixel is routed to its segment once, with no scan of the segments.
//
// - A warp owns a glyph (or, for a glyph of many pixels, a contiguous
//   range of its pixels) and walks the pixels in order, 32 at a time,
//   am and g loaded coalesced one step ahead. A lane gathers its argmin
//   segment (one 16-byte load of segs, served by L1 after the first
//   touch) and computes its pixel's four terms as the forward computes
//   tc and q.
// - Neighbouring pixels often share their argmin segment. The warp
//   groups its 32 lanes by am (`vg::match_keys`, a warp match); the
//   lowest lane of each set takes the set's terms in lane order, which
//   is pixel order, by shuffles, and adds them one by one onto the
//   segment's four accumulators in shared memory (acc [S] float4 a
//   warp, zeroed first). One warp owns the accumulators and walks the
//   pixels in order, so no two lanes ever add to one accumulator and
//   there is no atomic: DETERMINISTIC, each segment's sum taken in pixel
//   order, which is the order of a sequential loop over the pixels
//   (ops/sdf_torch.min_field_padded_bwd_ordered gives the same bits).
// - A block holds several warps: with one warp a glyph, that many
//   glyphs, each warp on its own (only warp-level synchronization).
//   With W > 1 warps a glyph (the launcher's choice for large P, where
//   one warp's walk is long) warp k of the glyph takes the k-th range
//   of pixels with its own accumulators, and the epilogue adds the W
//   partial sums in warp order: still fixed by the inputs alone, but no
//   longer the sequential loop's bits.
// - Shared memory is 16 bytes a segment and warp, at most 48 KB a
//   block: the accumulators cover s_chunk segments at a time, and a
//   glyph of more segments is walked once a chunk, pixels reread, each
//   pass keeping the pixels whose am lies in its chunk. A segment lies
//   in one chunk, so the order of its sum does not change.
// - The epilogue writes dsegs[b, s, :] as one float4 a segment, every
//   segment of every glyph (zeros where no pixel chose it).
//
// Parity with the plain version (ops/sdf_torch.min_field_padded_bwd):
// within 1e-4 of the largest gradient, since that version's index_add_
// sums in another order; bit-identical from run to run.

#include <cstdint>

#include <cuda_runtime.h>

#include "sdf_pair.cuh"

namespace {

constexpr int kSmemMax = 48 * 1024;  // shared memory a block without opting in

// kOwnGlyph: one warp a glyph, so the warps of a block never meet.
template <bool kOwnGlyph>
__global__ void sdf_min_field_padded_bwd_kernel(
    const float4* __restrict__ segs, int n_glyphs, int n_seg,
    const int32_t* __restrict__ meta,
    const int32_t* __restrict__ am, const float* __restrict__ ct, int n_pix,
    int warps_a_glyph, int s_chunk, float4* __restrict__ dsegs) {
  extern __shared__ float4 acc_all[];  // [warps a block][s_chunk]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpg = kOwnGlyph ? 1 : warps_a_glyph;
  const int part = warp % wpg;  // this warp's range of the glyph's pixels
  const int b = blockIdx.x * ((blockDim.x >> 5) / wpg) + warp / wpg;
  const bool has = b < n_glyphs;  // the same for every lane of the warp
  float4* acc = acc_all + static_cast<size_t>(warp) * s_chunk;
  const float4* parts = acc_all + static_cast<size_t>(warp - part) * s_chunk;

  vg::TileRow r;
  r.x0 = r.y0 = r.w = r.h = 0;
  r.npts = r.off = r.base = 0;  // unused here
  if (has) {
    const int32_t* m = meta + 4 * static_cast<size_t>(b);
    r.x0 = m[0];
    r.y0 = m[1];
    r.w = m[2];
    r.h = m[3];
  }
  // Pixels [p_lo, p_hi) are this warp's: whole steps of 32 but the last.
  const int share = ((n_pix + wpg - 1) / wpg + 31) & ~31;
  const int p_lo = has ? min(part * share, n_pix) : 0;
  const int p_hi = has ? min(p_lo + share, n_pix) : 0;
  const size_t row = static_cast<size_t>(has ? b : 0) * n_pix;
  const float4* gs = segs + static_cast<size_t>(has ? b : 0) * n_seg;

  for (int c0 = 0; c0 < n_seg; c0 += s_chunk) {
    const int n = min(s_chunk, n_seg - c0);
    for (int s = lane; s < n; s += 32) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();

    int a_next = -1;
    float g_next = 0.0f;
    if (p_lo + lane < p_hi) {
      a_next = am[row + p_lo + lane];
      g_next = ct[row + p_lo + lane];
    }
    for (int p0 = p_lo; p0 < p_hi; p0 += 32) {
      const int p = p0 + lane;
      const int a = a_next;
      const float g = g_next;
      a_next = -1;
      if (p + 32 < p_hi) {
        a_next = am[row + p + 32];
        g_next = ct[row + p + 32];
      }
      // Lanes past the range carry -1; an am outside the chunk (the
      // sentinel, a value outside [0, S)) joins no set either.
      const bool in = a >= c0 && a < c0 + n;
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const float4 v = gs[a];  // vx, vy, wx, wy
        const float dx = v.z - v.x;
        const float dy = v.w - v.y;
        float pxc, pyc, tc, qx, qy;
        vg::pixel_center(r, p, pxc, pyc);
        vg::project(pxc - v.x, pyc - v.y, dx, dy, vg::l2_inverse(dx, dy), tc, qx, qy);
        const float gqx = (2.0f * qx) * g;
        const float gqy = (2.0f * qy) * g;
        t = make_float4(gqx * (tc - 1.0f), gqy * (tc - 1.0f), -(gqx * tc), -(gqy * tc));
      }
      const vg::KeySets sets = vg::match_keys(in ? a : -1);
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (sets.leader) sum = acc[a - c0];
      vg::add_in_lane_order(sets, t, sum);
      if (sets.leader) acc[a - c0] = sum;
      __syncwarp();  // the next step's leaders read these accumulators
    }

    if (!kOwnGlyph) __syncthreads();  // the glyph's other ranges are summed
    if (has) {
      for (int s = part * 32 + lane; s < n; s += wpg * 32) {
        float4 sum = parts[s];
        for (int k = 1; k < wpg; ++k) {
          const float4 more = parts[static_cast<size_t>(k) * s_chunk + s];
          sum.x += more.x;
          sum.y += more.y;
          sum.z += more.z;
          sum.w += more.w;
        }
        dsegs[static_cast<size_t>(b) * n_seg + c0 + s] = sum;
      }
    }
    // The accumulators are read before the next chunk zeroes them.
    if (kOwnGlyph) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). Pointers are device pointers: segs [n_glyphs,
// n_seg, 4] f32 (16-byte aligned), meta [n_glyphs, 4] i32, am
// [n_glyphs, n_pix] i32, ct [n_glyphs, n_pix] f32 (the cotangent of
// d^2), dsegs [n_glyphs, n_seg, 4] f32 (16-byte aligned; every element
// written). threads is the block size (a multiple of 32, at most
// 1024), warps_a_glyph divides its warps (a block holds threads / 32 /
// warps_a_glyph glyphs), and s_chunk >= 1 is the segments a warp's
// accumulators cover at a time: 16 * s_chunk * threads / 32 bytes of
// shared memory, at most 48 KB. The caller checks shapes.
extern "C" int vg_sdf_min_field_padded_bwd(
    const void* segs, int n_glyphs, int n_seg, const void* meta, const void* am,
    const void* ct, int n_pix, int threads, int warps_a_glyph, int s_chunk, void* dsegs,
    void* stream) {
  if (n_glyphs == 0 || n_seg == 0) return 0;
  const int warps = threads / 32;
  if (threads % 32 || threads < 32 || threads > 1024 || warps_a_glyph < 1 ||
      warps % warps_a_glyph || s_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float4) * static_cast<size_t>(s_chunk) * warps;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int glyphs_a_block = warps / warps_a_glyph;
  const int grid = (n_glyphs + glyphs_a_block - 1) / glyphs_a_block;
  const auto kernel = warps_a_glyph == 1 ? sdf_min_field_padded_bwd_kernel<true>
                                         : sdf_min_field_padded_bwd_kernel<false>;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(segs), n_glyphs, n_seg, static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(am), static_cast<const float*>(ct), n_pix, warps_a_glyph,
      s_chunk, static_cast<float4*>(dsegs));
  return static_cast<int>(cudaGetLastError());
}
