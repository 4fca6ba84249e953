// Synthetic FP32 ALU roof on the render tile kernel's launch shape, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_roof_kernel` of scripts/roofline.py. It
// computes what that kernel computes and nothing of its TPU layout is
// carried over (no (TP, SC) accumulator in scratch memory, no lane
// padding): one block per tile-table row and one thread per pixel
// (blockDim.x == TP), as sdf_tiles_pts.cu launches. No input is read.
// Per thread an accumulator starts at 1.0 and each of n_chunk chunks
// applies
//     a = a * 1.000001 + x;  a = min(a, 3e38)
// ten times (30 f32 operations), with x = 0.5, 1.5, 2.5, ... by chunk.
// The output [n_tiles, TP] f32 holds the accumulator after the last
// chunk, as the TPU kernel stores lane 0 of each pixel row.
//
// On the TPU all lanes of a pixel row run the same chain and only lane
// 0 is stored. Here one dependent chain a thread would measure the
// ALU's latency, not its throughput, and a compiler merges identical
// chains and deletes what is never stored. So a thread keeps kChains
// independent accumulators that start `spread` apart (a kernel
// argument the compiler cannot see through); chains 1.. are folded
// into the store under a test of their sum that is false at run time
// (every accumulator stays in [1, 3e38]), so the stored value is chain
// 0's alone and the other chains are still computed. A launch executes
// n_tiles * TP * n_chunk * kChains * 30 f32 operations (plus one add a
// chunk for x).
//
// Bound: FP32 ALU, by construction; the 4 bytes a pixel of output are
// noise. The build passes --fmad=false like every kernel of the port,
// so a * c + x is an FMUL and an FADD: this is the roof of the
// instruction mix the port's kernels are compiled to. `fused` != 0
// asks for the same recurrence with an explicit fused multiply-add
// (`__fmaf_rn`, one rounding, so other bits): 30 operations in 20
// instructions, the roof a kernel would have if it gave up the
// separately rounded multiply and add. Only the un-fused result has a
// plain version (ops/sdf_torch.alu_roof, bit-equal).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 4;   // independent accumulators a thread (ops/sdf_cuda.ALU_ROOF_CHAINS)
constexpr int kTriples = 10; // (multiply, add, min) steps a chunk

template <bool kFused>
__global__ void alu_roof_kernel(int n_chunk, float spread, float* __restrict__ out) {
  float a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = 1.0f + static_cast<float>(k) * spread;

  float x = 0.5f;
  for (int c = 0; c < n_chunk; ++c) {
#pragma unroll
    for (int i = 0; i < kTriples; ++i) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        const float s = kFused ? __fmaf_rn(a[k], 1.000001f, x)
                               : __fadd_rn(__fmul_rn(a[k], 1.000001f), x);
        a[k] = fminf(s, 3.0e38f);
      }
    }
    x += 1.0f;
  }

  float rest = 0.0f;
#pragma unroll
  for (int k = 1; k < kChains; ++k) rest += a[k];
  float r = a[0];
  if (rest < 0.0f) r += rest;  // never: every accumulator is >= 1
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x] = r;
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(). out is a device pointer to [n_tiles, tp] f32; tp
// is the block size (a multiple of 32, at most 1024). spread separates
// the extra chains' starts (any value >= 0); fused picks the
// fused-multiply-add variant.
extern "C" int vg_alu_roof(int n_tiles, int tp, int n_chunk, float spread, int fused,
                           void* out, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    alu_roof_kernel<true><<<n_tiles, tp, 0, s>>>(n_chunk, spread, static_cast<float*>(out));
  } else {
    alu_roof_kernel<false><<<n_tiles, tp, 0, s>>>(n_chunk, spread, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
