// Per-pixel SDF math shared by the port's Hopper kernels
// (sdf_tiles_pts.cu, sdf_min_field_pts.cu, sdf_min_field_bwd.cu,
// sdf_tiles_flat.cu, sdf_grid_flat.cu, sdf_min_field_padded.cu,
// sdf_min_field_padded_bwd.cu, sdf_tiles_pts_acc.cu).
//
// The inner routine lives here: `SegRecords` (one segment = two float4,
// live segments only, R pixels a thread, crossings listed by bitmap
// row) serves the tile kernels sdf_tiles_pts.cu, sdf_tiles_flat.cu and
// sdf_min_field_pts.cu (one tile body, `tile_body`, that differs in its
// staging, in what a pixel keeps and in what it stores),
// sdf_grid_flat.cu and sdf_min_field_padded.cu; the two min-field
// kernels find the first argmin in the index a record carries.
// sdf_tiles_pts_acc.cu, the per-pair implementation that the render
// kernels are held against, takes only the records' staging
// (`SegRecords::put`, every lane with its validity bit) and tests every
// pair's crossing itself, with the same expressions in the same order,
// so the two give the same bits. The backward kernels take `project`
// alone, and sdf_min_field_padded_bwd.cu and sdf_min_field_bwd.cu route
// a pixel's terms to its argmin segment or lane with the warp's key
// sets at the end of this file (`match_keys`, `add_in_lane_order`).
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

// ---- Packed records, R pixels a thread, crossings by row ----
// (sdf_tiles_pts.cu, sdf_tiles_flat.cu, sdf_min_field_pts.cu,
// sdf_grid_flat.cu, sdf_min_field_padded.cu)
//
// The pair math (project below, the crossing test and the running min)
// costs 22 f32 instructions, and from eight scalar shared arrays about 16
// more instruction slots around them (eight 4-byte shared loads, a
// validity test, the winding's integer select and add, the loop). The
// card starts one instruction a clock a scheduler whatever its kind, so
// those slots are lost f32 work. Here
// - a staged segment is one 32-byte record read by 16-byte broadcast
//   loads that serve R pixels of the thread;
// - only live segments are staged (no validity word, no branch) and the
//   loop is unrolled by four;
// - the crossing test of a pair depends on the pixel's row and not on
//   its column except for the last compare, so a block tests each staged
//   segment once against each row of its pixels (RowLists) and a pixel
//   then sums the few crossings of its row: the loop over the segments
//   keeps the 16 distance operations and no compare, select or integer
//   add. The expressions are those of the per-pair test on the same
//   values, so the count is the same integer;
// - a kernel that needs the first argmin (MinPixels) finds the original
//   index of a staged segment in the record's spare word, since the slot
//   of a compacted segment is not its index.

constexpr int kRecChunk = 256;  // segments a staged chunk: 8 KB of shared memory
constexpr int kRowsMax = 64;    // rows of a block's pixels that get a crossing list
constexpr int kRowCross = 16;   // crossings a row can list for one staged chunk

// Center y of bitmap row `row` (from the top): pixel_center's pyc.
__device__ __forceinline__ float row_center_y(const TileRow& r, int row) {
  return static_cast<float>(r.y0) + static_cast<float>(r.h - 1 - row) + 0.5f;
}

// Live lanes among [a, b) of the point chain's validity bits (a <= b).
__device__ __forceinline__ int live_between(const int32_t* __restrict__ mask_words,
                                            int a, int b) {
  int n = 0;
  for (int wi = a >> 5; wi * 32 < b; ++wi) {
    const int lo = max(a - wi * 32, 0);
    const int hi = min(b - wi * 32, 32);
    uint32_t m = hi >= 32 ? 0xffffffffu : (1u << hi) - 1u;
    m &= ~((1u << lo) - 1u);
    n += __popc(static_cast<uint32_t>(mask_words[wi]) & m);
  }
  return n;
}

// The R pixels of a thread: centers, running min of d^2, winding count,
// and each pixel's bitmap row less the first row of the block's pixels.
template <int R>
struct Pixels {
  static constexpr bool kArgmin = false;
  float pxc[R], pyc[R], dmin[R];
  int wn[R], lrow[R];

  // Pixels i0 + k * stride, k < R, of row r's bitmap; row0 is the row
  // of the block's first pixel.
  __device__ __forceinline__ void init(const TileRow& r, int i0, int stride, int row0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      pixel_center(r, i0 + k * stride, pxc[k], pyc[k]);
      dmin[k] = kBig;
      wn[k] = 0;
      lrow[k] = (i0 + k * stride) / max(r.w, 1) - row0;
    }
  }
};

// Pixels<R> with each pixel's first argmin: the carried index of the
// staged segment that first reached the running min (kBigI while no
// segment has).
template <int R>
struct MinPixels : Pixels<R> {
  static constexpr bool kArgmin = true;
  int amin[R];

  __device__ __forceinline__ void init(const TileRow& r, int i0, int stride, int row0) {
    Pixels<R>::init(r, i0, stride, row0);
#pragma unroll
    for (int k = 0; k < R; ++k) amin[k] = kBigI;
  }
};


// Crossings of the staged chunk with each row of the block's pixels, in
// shared memory: row q lists cx and the step (+1 up, -1 down) of every
// staged segment that crosses its center line.
struct RowLists {
  float cx[kRowsMax * kRowCross];
  int step[kRowsMax * kRowCross];
  int count[kRowsMax];
  int overflow;  // a row met more than kRowCross crossings

  // The block empties the lists of its nrows rows; it synchronizes
  // before the next list_crossings.
  __device__ __forceinline__ void clear(int nrows) {
    for (int q = threadIdx.x; q < nrows; q += blockDim.x) count[q] = 0;
    if (threadIdx.x == 0) overflow = 0;
  }
};

struct SegRecords {
  // rec[2 * j] = {vx, vy, dx, dy}, rec[2 * j + 1] = {1/l2, 1/dy, wy, idx}:
  // idx is an integer's bits (the segment's index where the kernel keeps
  // an argmin, else 0), and no arithmetic touches it.
  float4* rec;

  __device__ __forceinline__ explicit SegRecords(float4* smem) : rec(smem) {}

  // Stages segment (v, w) at slot j with its carried index (or, for
  // sdf_tiles_pts_acc.cu, its validity bit): its derived terms, divides
  // paid once a segment and block.
  __device__ __forceinline__ void put(int j, float v_x, float v_y, float w_x, float w_y,
                                      int idx = 0) const {
    const float d_x = w_x - v_x;
    const float d_y = w_y - v_y;
    rec[2 * j] = make_float4(v_x, v_y, d_x, d_y);
    rec[2 * j + 1] = make_float4(l2_inverse(d_x, d_y),
                                 d_y != 0.0f ? __fdiv_rn(1.0f, d_y) : 0.0f, w_y,
                                 __int_as_float(idx));
  }

  // Point-chain layout: the block stages the live lanes among
  // [c0, cend) (at most kRecChunk lanes, cend < n_lanes) in lane order,
  // each with its lane carried (the argmin of sdf_min_field_pts.cu is a
  // global lane), and returns their count. A lane's slot is the live count before its
  // warp's 32 lanes, from the validity words, plus the live lanes below
  // it in the warp's ballot: a glyph's run starts at any lane, so a
  // warp's lanes straddle two words. Dead lanes never reach shared
  // memory. Every thread of the block calls it.
  __device__ __forceinline__ int stage_live(const float* __restrict__ pts, int n_lanes,
                                            const int32_t* __restrict__ mask_words,
                                            int c0, int cend) const {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    for (int i0 = 0; c0 + i0 < cend; i0 += nt) {
      const int lane = c0 + i0 + tid;
      bool live = false;
      if (lane < cend)
        live = (static_cast<uint32_t>(mask_words[lane >> 5]) >> (lane & 31)) & 1u;
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int warp0 = min(c0 + i0 + (tid & ~31), cend);
        const int slot = live_between(mask_words, c0, warp0) +
                         __popc(ballot & ((1u << (tid & 31)) - 1u));
        put(slot, pts[lane], pts[n_lanes + lane], pts[lane + 1], pts[n_lanes + lane + 1], lane);
      }
    }
    return live_between(mask_words, c0, cend);
  }

  // Segment-soup layout flat [4, n_lanes]: the block stages lanes
  // [c0, cend) (at most kRecChunk), all live.
  __device__ __forceinline__ void stage_soup(const float* __restrict__ flat, int n_lanes,
                                             int c0, int cend) const {
    for (int lane = c0 + threadIdx.x; lane < cend; lane += blockDim.x)
      put(lane - c0, flat[lane], flat[n_lanes + lane], flat[2 * n_lanes + lane],
          flat[3 * n_lanes + lane]);
  }

  // Padded layout: the block stages the live segments among [c0, cend)
  // (at most kRecChunk) of one glyph's segs [S, 4] and mask [S]
  // (nonzero = live) in segment order, each with its index s carried,
  // and returns their count. The scheme of stage_live with the mask as
  // the validity: every warp walks the run 32 segments at a time and
  // counts the live ones by ballot, so it knows the slot of each without
  // a shared counter, and stages every nwarps-th of those 32s. Every
  // thread of the block calls it.
  __device__ __forceinline__ int stage_masked(const float* __restrict__ segs,
                                              const float* __restrict__ mask, int c0,
                                              int cend) const {
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int before = 0;  // live segments of [c0, s0)
    for (int s0 = c0, turn = 0; s0 < cend; s0 += 32, ++turn) {
      const int s = s0 + lane;
      const bool live = s < cend && mask[s] != 0.0f;
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (live && turn % nwarps == wid) {
        const float4 v = reinterpret_cast<const float4*>(segs)[s];
        put(before + __popc(ballot & ((1u << lane) - 1u)), v.x, v.y, v.z, v.w, s);
      }
      before += __popc(ballot);
    }
    return before;
  }

  // One staged segment against the thread's R pixels: the expressions
  // of sdf_tiles_pts_acc.cu's d2_and_winding and the caller's running
  // min (the crossing test is the parity form that function describes); without
  // kWinding the distance alone. MinPixels also keep the first argmin:
  // the update is on a strict `<`, so while segments are staged and
  // walked in index order a tie keeps the smallest index.
  template <int R, bool kWinding, class Px = Pixels<R>>
  __device__ __forceinline__ void pair(int j, Px& px) const {
    const float4 a = rec[2 * j];
    const float4 b = rec[2 * j + 1];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float ex = px.pxc[k] - a.x;
      const float ey = px.pyc[k] - a.y;
      float tc, qx, qy;
      project(ex, ey, a.z, a.w, b.x, tc, qx, qy);
      if (kWinding) {
        const bool c1 = a.y <= px.pyc[k];
        const bool cross = c1 != (b.z <= px.pyc[k]);
        const float cx = a.x + (ey * b.y) * a.z;
        if (cross && cx <= px.pxc[k]) px.wn[k] += c1 ? 1 : -1;
      }
      const float d2 = qx * qx + qy * qy;
      if constexpr (Px::kArgmin) {
        if (d2 < px.dmin[k]) {
          px.dmin[k] = d2;
          px.amin[k] = __float_as_int(b.w);
        }
      } else {
        px.dmin[k] = fminf(px.dmin[k], d2);
      }
    }
  }

  // The first n staged segments against the thread's R pixels.
  template <int R, bool kWinding, class Px = Pixels<R>>
  __device__ __forceinline__ void accumulate(int n, Px& px) const {
    int j = 0;
    for (; j + 4 <= n; j += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) pair<R, kWinding>(j + u, px);
    }
    for (; j < n; ++j) pair<R, kWinding>(j, px);
  }

  // The block lists, for each of the nrows bitmap rows from row0, the
  // crossings of the first n staged segments: the per-pair test
  // with the row's center y. The caller synchronizes the block before
  // (the records are staged, the lists cleared) and after.
  __device__ __forceinline__ void list_crossings(int n, RowLists& rows, const TileRow& r,
                                                 int row0, int nrows) const {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float4 a = rec[2 * j];
      const float4 b = rec[2 * j + 1];
      for (int q = 0; q < nrows; ++q) {
        const float pyc = row_center_y(r, row0 + q);
        const bool c1 = a.y <= pyc;
        if (c1 == (b.z <= pyc)) continue;
        const float ey = pyc - a.y;
        const int slot = atomicAdd(&rows.count[q], 1);
        if (slot < kRowCross) {
          rows.cx[q * kRowCross + slot] = a.x + (ey * b.y) * a.z;
          rows.step[q * kRowCross + slot] = c1 ? 1 : -1;
        } else {
          rows.overflow = 1;
        }
      }
    }
  }

  // The staged chunk of n segments against the thread's R pixels; every
  // thread of the block calls it between the synchronization that
  // follows staging and the one that precedes the next staging. With
  // use_rows (the block's pixels span at most kRowsMax rows; the same
  // for every thread; the lists were cleared while staging) the
  // crossings go by row lists, unless a row overflows its list: then,
  // as without use_rows, every pair tests its own crossing.
  template <int R, class Px = Pixels<R>>
  __device__ __forceinline__ void reduce(int n, Px& px, RowLists& rows, bool use_rows,
                                         const TileRow& r, int row0, int nrows) const {
    if (use_rows) {
      list_crossings(n, rows, r, row0, nrows);
      __syncthreads();
      use_rows = rows.overflow == 0;
    }
    if (!use_rows) {
      accumulate<R, true>(n, px);
      return;
    }
    accumulate<R, false>(n, px);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int q = px.lrow[k];
      const int cnt = rows.count[q];
      for (int c = 0; c < cnt; ++c)
        if (rows.cx[q * kRowCross + c] <= px.pxc[k]) px.wn[k] += rows.step[q * kRowCross + c];
    }
  }
};

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

// ---- The tile body (sdf_tiles_pts.cu, sdf_tiles_flat.cu,
// sdf_min_field_pts.cu) ----
//
// The tile kernels differ in how a glyph's segments reach the records
// and in where the glyph's run of lanes ends (a staging says both), in
// what a pixel keeps (Pixels or MinPixels) and in what it stores (a
// store). stage() is called by every thread of the block for lanes
// [c0, cend) of the run, at most kRecChunk, and returns the number of
// segments it staged in slots 0 .. n - 1, the same for every thread.

// The point chain pts [2, n_lanes] with its validity bits: a row's
// segments are the live lanes among [off, off + npts - 1).
struct ChainStaging {
  const float* pts;
  int n_lanes;
  const int32_t* mask_words;

  __device__ __forceinline__ int last(const TileRow& r) const { return r.off + r.npts - 1; }
  __device__ __forceinline__ int stage(const SegRecords& seg, int c0, int cend) const {
    return seg.stage_live(pts, n_lanes, mask_words, c0, cend);
  }
};

// The segment soup flat [4, n_lanes]: a row's segments are the lanes
// [seg_off, seg_off + nseg), all live (TileRow's off and npts).
struct SoupStaging {
  const float* flat;
  int n_lanes;

  __device__ __forceinline__ int last(const TileRow& r) const { return r.off + r.npts; }
  __device__ __forceinline__ int stage(const SegRecords& seg, int c0, int cend) const {
    seg.stage_soup(flat, n_lanes, c0, cend);
    return cend - c0;
  }
};

// What the render kernels store of a pixel: its SDF byte in out
// [n_tiles, TP].
struct ByteStore {
  float scale, cutoff;
  uint8_t* out;

  __device__ __forceinline__ void zero(size_t o) const { out[o] = 0; }
  template <class Px>
  __device__ __forceinline__ void put(size_t o, const Px& px, int k) const {
    out[o] = sdf_byte(px.dmin[k], px.wn[k], scale, cutoff);
  }
};

// What the min-field kernel stores of a pixel: the min of d^2, the
// winding number and the first argmin, each [n_tiles, TP].
struct MinFieldStore {
  float* d2;
  int32_t* wn;
  int32_t* am;

  __device__ __forceinline__ void zero(size_t o) const {
    d2[o] = 0.0f;
    wn[o] = 0;
    am[o] = 0;
  }
  template <class Px>
  __device__ __forceinline__ void put(size_t o, const Px& px, int k) const {
    d2[o] = px.dmin[k];
    wn[o] = px.wn[k];
    am[o] = px.amin[k];
  }
};

// Tile-table row blockIdx.x of tmeta [8, n_tiles] by a block of TP / R
// threads: thread tid takes pixels tid + k * TP / R, k < R, of the tile
// against the glyph's staged segments and stores what `store` keeps of
// them at [n_tiles, TP] (a warp's stores are contiguous). A row whose
// pix_base is at or past w*h is zeros.
template <int R, class Px, class Staging, class Store>
__device__ __forceinline__ void tile_body(const Staging& staging,
                                          const int32_t* __restrict__ tmeta, int n_tiles,
                                          const Store& store) {
  __shared__ float4 smem[2 * kRecChunk];
  __shared__ RowLists rows;
  const SegRecords seg(smem);

  const int nt = blockDim.x;  // TP / R
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const TileRow r = load_tile(tmeta, n_tiles, t);
  const size_t o = static_cast<size_t>(t) * nt * R + tid;

  if (r.base >= r.w * r.h) {  // the same for every thread of the block
#pragma unroll
    for (int k = 0; k < R; ++k) store.zero(o + k * nt);
    return;
  }

  // Bitmap rows of the tile's pixels [base, base + TP).
  const int ws = max(r.w, 1);
  const int row0 = r.base / ws;
  const int nrows = (r.base + nt * R - 1) / ws - row0 + 1;
  const bool use_rows = nrows <= kRowsMax;
  Px px;
  px.init(r, r.base + tid, nt, row0);

  const int last = staging.last(r);
  for (int c0 = r.off; c0 < last; c0 += kRecChunk) {
    const int cend = min(c0 + kRecChunk, last);
    const int n = staging.stage(seg, c0, cend);
    if (n == 0) continue;  // the same for every thread of the block
    if (use_rows) rows.clear(nrows);
    __syncthreads();
    seg.reduce<R>(n, px, rows, use_rows, r, row0, nrows);
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < R; ++k) store.put(o + k * nt, px, k);
}

// The render kernels' tile: `tile_body` keeping the min of d^2 and the
// winding of a pixel and storing its byte in out [n_tiles, TP].
template <int R, class Staging>
__device__ __forceinline__ void render_tile(const Staging& staging,
                                            const int32_t* __restrict__ tmeta, int n_tiles,
                                            float scale, float cutoff,
                                            uint8_t* __restrict__ out) {
  tile_body<R, Pixels<R>>(staging, tmeta, n_tiles, ByteStore{scale, cutoff, out});
}

// ---- A warp's lanes grouped by key (sdf_min_field_padded_bwd.cu,
// sdf_min_field_bwd.cu) ----
//
// A backward kernel adds each pixel's terms to the accumulators of the
// pixel's argmin segment. A warp that walks pixels 32 at a time groups
// its lanes by that key: the lanes with one key are a set, the lowest
// of them its leader, and the leader alone adds the set's terms, in
// lane order, which is pixel order. No two lanes then add to one
// accumulator, so the sum needs no atomics and its order is fixed by
// the inputs.

struct KeySets {
  unsigned peers;  // the lanes of this lane's set (itself included)
  bool leader;     // this lane is the lowest of a set with a key >= 0
  int most;        // lanes in the warp's largest such set
};

// Groups the warp's lanes by `key`; lanes with a negative key join no
// set (they have no leader). Every lane of the warp calls it.
__device__ __forceinline__ KeySets match_keys(int key) {
  KeySets s;
  s.peers = __match_any_sync(0xffffffffu, key);
  s.leader = key >= 0 && (threadIdx.x & 31) == __ffs(s.peers) - 1;
  s.most = static_cast<int>(__reduce_max_sync(0xffffffffu, s.leader ? __popc(s.peers) : 0u));
  return s;
}

// On a set's leader, adds the terms t of the set's lanes onto `sum`,
// one lane after the other from the lowest, component by component
// (sum = ((sum + t0) + t1) + ...). Other lanes' `sum` is untouched.
// Every lane of the warp calls it.
__device__ __forceinline__ void add_in_lane_order(const KeySets& s, const float4& t,
                                                  float4& sum) {
  unsigned rest = s.peers;
  for (int k = 0; k < s.most; ++k) {
    const bool more = rest != 0u;
    const int src = __ffs(rest) - 1;  // -1 once the set is spent: any lane will do
    rest &= rest - 1u;
    const float x = __shfl_sync(0xffffffffu, t.x, src);
    const float y = __shfl_sync(0xffffffffu, t.y, src);
    const float z = __shfl_sync(0xffffffffu, t.z, src);
    const float w = __shfl_sync(0xffffffffu, t.w, src);
    if (s.leader && more) {
      sum.x += x;
      sum.y += y;
      sum.z += z;
      sum.w += w;
    }
  }
}

}  // namespace vg
