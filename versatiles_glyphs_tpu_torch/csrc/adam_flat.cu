// Adam's update of every leaf of the fit in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's update is optax's, which
// XLA compiles. It was added because `torch.optim.Adam` (foreach) runs
// seven multi-tensor launches a step (lerp, mul, addcmul, sqrt, div, add,
// addcdiv), each giving one 512-thread block to a 65,536-element chunk:
// for the fit's three leaves (curves [B, C, 4, 2], translate [B, 2],
// log_gain []) that is six blocks on 132 SMs, seven times over, about
// 0.1 ms of the card's step for ~6 MB of traffic.
//
// Per element, `torch.optim.Adam`'s single-tensor formula in f32, in its
// order, each operation rounded once (the intrinsics below, and the
// build's --fmad=false), so the result is bit-equal to the plain version
// `ops.adam.adam_update_plain`:
//   m = lerp(m, g, w)           ATen's two branches: m + w*(g - m) for
//                                |w| < 0.5, else g - (g - m)*(1 - w)
//   v = v*b2 + (c2*g)*g         (mul_, then addcmul_)
//   d = sqrt(v) / bc2s + eps
//   p = p + (ns*m) / d          (addcdiv_ with value ns = -lr/bc1)
// The host computes each leaf's scalars from its step count in doubles,
// as torch does, and passes them as f32 (w = 1 - b1, c2 = 1 - b2, bc2s =
// sqrt(1 - b2^step), ns = -lr / (1 - b1^step)).
//
// Layout: a table of up to kMaxLeaves leaves (p, g, m, v, n and the
// scalars) passed by value as a __grid_constant__ parameter. The leaves'
// elements are cut into quads of four, numbered across the leaves; a
// thread takes one quad (grid-stride past the grid's cap), finds its
// leaf by a scan of the table's starts, and loads and stores 16 bytes of
// each array where all four are 16-byte aligned and the quad is whole,
// else element by element (a leaf's ragged end, a one-element leaf).
//
// Bound: bytes. Each element reads p, g, m and v and writes p, m and v,
// 28 bytes, against 13 f32 operations: 219 k elements (the fit cell's
// leaves) are 6.1 MB, 1.8 us at 3.35 TB/s. The launch and its tail on
// the card are of the same order at that size.

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;   // elements
  long long q0;  // first quad of the leaf in the launch's numbering
  float w, omw, b2, c2, bc2s, eps, ns;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  long long n_quads;
};

__device__ __forceinline__ void update(const Leaf& L, float& p, float g, float& m, float& v) {
  const float d = __fsub_rn(g, m);
  m = fabsf(L.w) < 0.5f ? __fadd_rn(m, __fmul_rn(L.w, d)) : __fsub_rn(g, __fmul_rn(d, L.omw));
  v = __fadd_rn(__fmul_rn(v, L.b2), __fmul_rn(__fmul_rn(L.c2, g), g));
  const float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), L.bc2s), L.eps);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(L.ns, m), den));
}

__global__ void __launch_bounds__(kThreads) adam_flat_kernel(const __grid_constant__ Table t) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < t.n_quads; q += stride) {
    int i = 0;
    while (i + 1 < t.n_leaves && q >= t.leaf[i + 1].q0) ++i;
    const Leaf& L = t.leaf[i];
    const long long e = (q - L.q0) * 4;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(L.p) | reinterpret_cast<uintptr_t>(L.g) |
                           reinterpret_cast<uintptr_t>(L.m) | reinterpret_cast<uintptr_t>(L.v);
    if (e + 4 <= L.n && (bits & 15) == 0) {
      float4 p = reinterpret_cast<const float4*>(L.p)[e / 4];
      const float4 g = reinterpret_cast<const float4*>(L.g)[e / 4];
      float4 m = reinterpret_cast<const float4*>(L.m)[e / 4];
      float4 v = reinterpret_cast<const float4*>(L.v)[e / 4];
      update(L, p.x, g.x, m.x, v.x);
      update(L, p.y, g.y, m.y, v.y);
      update(L, p.z, g.z, m.z, v.z);
      update(L, p.w, g.w, m.w, v.w);
      reinterpret_cast<float4*>(L.p)[e / 4] = p;
      reinterpret_cast<float4*>(L.m)[e / 4] = m;
      reinterpret_cast<float4*>(L.v)[e / 4] = v;
    } else {
      const long long end = e + 4 < L.n ? e + 4 : L.n;
      for (long long j = e; j < end; ++j) {
        float p = L.p[j], m = L.m[j], v = L.v[j];
        update(L, p, L.g[j], m, v);
        L.p[j] = p;
        L.m[j] = m;
        L.v[j] = v;
      }
    }
  }
}

}  // namespace

// Launches one update of n_leaves (1 to 8) leaves on `stream` (a
// cudaStream_t) and returns cudaGetLastError(). Host arrays: ptrs
// [n_leaves][4] device pointers (p, g, m, v: contiguous f32, p, m and v
// written in place), counts [n_leaves] elements, scalars [n_leaves][7]
// (w, 1 - w, b2, c2, bc2s, eps, ns). The caller checks dtypes, devices
// and contiguity.
extern "C" int vg_adam_flat(int n_leaves, const void* ptrs, const void* counts,
                            const void* scalars, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ptr = static_cast<void* const*>(ptrs);
  const auto* cnt = static_cast<const int64_t*>(counts);
  const auto* sc = static_cast<const float*>(scalars);
  Table t = {};
  t.n_leaves = n_leaves;
  long long quads = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (cnt[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    Leaf& L = t.leaf[i];
    L.p = static_cast<float*>(ptr[4 * i]);
    L.g = static_cast<const float*>(ptr[4 * i + 1]);
    L.m = static_cast<float*>(ptr[4 * i + 2]);
    L.v = static_cast<float*>(ptr[4 * i + 3]);
    L.n = cnt[i];
    L.q0 = quads;
    L.w = sc[7 * i];
    L.omw = sc[7 * i + 1];
    L.b2 = sc[7 * i + 2];
    L.c2 = sc[7 * i + 3];
    L.bc2s = sc[7 * i + 4];
    L.eps = sc[7 * i + 5];
    L.ns = sc[7 * i + 6];
    quads += (cnt[i] + 3) / 4;
  }
  t.n_quads = quads;
  if (quads == 0) return 0;
  long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adam_flat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
