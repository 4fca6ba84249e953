// Native host runtime for versatiles_glyphs_tpu.
//
// The reference implements its entire host pipeline in Rust; the TPU
// build keeps the device path in Pallas/XLA and implements the
// performance-relevant host stages natively here, exposed through a
// plain C ABI consumed via ctypes (proto/native.py):
//
//  - vg_encode_glyph_block: mapbox glyphs.proto wire encoding of a
//    whole block from raw arrays (the host packing hot loop; wire
//    layout mirrors reference/src/protobuf/*.rs via prost
//    semantics: fields in tag order, sint32 zigzag for left/top).
//  - vg_tar_header: POSIX ustar 512-byte header with the reference's
//    exact octal/checksum layout (reference/src/writer/tar.rs).
//  - vg_render_sdf_batch: multithreaded float64 brute-force SDF
//    renderer — bit-identical to ops/sdf_ref.py (same IEEE operations
//    in the same per-pixel order), used as the CPU fallback and as the
//    reference-equivalent baseline bench.py compares the TPU against.
//
// Build: csrc/Makefile (g++ -O3 -shared); loaded lazily, with the
// pure-Python implementations as always-available fallbacks.
//
// This is the PyTorch port's own copy of the JAX package's
// csrc/vg_native.cpp, and the two diverge by design: the port reads
// every font without fontTools, so its copy adds what the JAX package
// takes from fontTools 4.61.1 — cmap formats 2 and 13 (and the refusal
// of a unicode subtable of a format fontTools cannot decode, 8 and 10
// among them), CFF2, seac, cubic glyf contours, composites past the
// native walk's depth, and fontTools' drawing wherever the native walks
// give up — and walks each glyph as the JAX package does: its native
// walk first where that package has one, fontTools' semantics after.
// The root copy stays as the JAX package's.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline long put_varint(uint64_t v, uint8_t* out) {
  long n = 0;
  while (v > 0x7f) {
    out[n++] = static_cast<uint8_t>(v & 0x7f) | 0x80;
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

inline long varint_len(uint64_t v) {
  long n = 1;
  while (v > 0x7f) {
    ++n;
    v >>= 7;
  }
  return n;
}

inline uint32_t zigzag32(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

// Encoded size of one glyph message body (without the outer key/len).
long glyph_body_len(uint32_t id, uint8_t has_bitmap, uint64_t bm_len,
                    uint32_t w, uint32_t h, int32_t left, int32_t top,
                    uint32_t adv) {
  long n = 1 + varint_len(id);
  if (has_bitmap) n += 1 + varint_len(bm_len) + static_cast<long>(bm_len);
  n += 1 + varint_len(w);
  n += 1 + varint_len(h);
  n += 1 + varint_len(zigzag32(left));
  n += 1 + varint_len(zigzag32(top));
  n += 1 + varint_len(adv);
  return n;
}

long encode_glyph(uint32_t id, uint8_t has_bitmap, const uint8_t* bm,
                  uint64_t bm_len, uint32_t w, uint32_t h, int32_t left,
                  int32_t top, uint32_t adv, uint8_t* out) {
  long n = 0;
  out[n++] = (1 << 3) | 0;
  n += put_varint(id, out + n);
  if (has_bitmap) {
    out[n++] = (2 << 3) | 2;
    n += put_varint(bm_len, out + n);
    std::memcpy(out + n, bm, bm_len);
    n += static_cast<long>(bm_len);
  }
  out[n++] = (3 << 3) | 0;
  n += put_varint(w, out + n);
  out[n++] = (4 << 3) | 0;
  n += put_varint(h, out + n);
  out[n++] = (5 << 3) | 0;
  n += put_varint(zigzag32(left), out + n);
  out[n++] = (6 << 3) | 0;
  n += put_varint(zigzag32(top), out + n);
  out[n++] = (7 << 3) | 0;
  n += put_varint(adv, out + n);
  return n;
}

}  // namespace

extern "C" {

// Returns bytes written, or -(needed) when out_cap is too small.
long vg_encode_glyph_block(const char* name, long name_len, const char* range,
                           long range_len, long n_glyphs, const uint32_t* ids,
                           const uint32_t* widths, const uint32_t* heights,
                           const int32_t* lefts, const int32_t* tops,
                           const uint32_t* advances, const uint8_t* bitmaps,
                           const int64_t* bitmap_offs,
                           const uint8_t* has_bitmap, uint8_t* out,
                           long out_cap) {
  // Stack (fontstack) body: name(1) + range(2) + repeated glyphs(3).
  long stack_len = 1 + varint_len(name_len) + name_len + 1 +
                   varint_len(range_len) + range_len;
  std::vector<long> glyph_lens(n_glyphs);
  for (long i = 0; i < n_glyphs; ++i) {
    uint64_t bl = bitmap_offs[i + 1] - bitmap_offs[i];
    glyph_lens[i] = glyph_body_len(ids[i], has_bitmap[i], bl, widths[i],
                                   heights[i], lefts[i], tops[i], advances[i]);
    stack_len += 1 + varint_len(glyph_lens[i]) + glyph_lens[i];
  }
  long total = 1 + varint_len(stack_len) + stack_len;
  if (total > out_cap) return -total;

  long n = 0;
  out[n++] = (1 << 3) | 2;  // stacks
  n += put_varint(stack_len, out + n);
  out[n++] = (1 << 3) | 2;  // name
  n += put_varint(name_len, out + n);
  std::memcpy(out + n, name, name_len);
  n += name_len;
  out[n++] = (2 << 3) | 2;  // range
  n += put_varint(range_len, out + n);
  std::memcpy(out + n, range, range_len);
  n += range_len;
  for (long i = 0; i < n_glyphs; ++i) {
    out[n++] = (3 << 3) | 2;
    n += put_varint(glyph_lens[i], out + n);
    uint64_t bl = bitmap_offs[i + 1] - bitmap_offs[i];
    n += encode_glyph(ids[i], has_bitmap[i], bitmaps + bitmap_offs[i], bl,
                      widths[i], heights[i], lefts[i], tops[i], advances[i],
                      out + n);
  }
  return n;
}

// 512-byte ustar header; layout identical to the reference's
// hand-rolled writer (zero-filled right-aligned octal, trailing space,
// checksum over space-filled field). Returns 0, or -1 if the name is
// longer than 100 bytes (truncation would corrupt the entry identity).
long vg_tar_header(const char* name, long name_len, uint64_t size,
                   uint64_t mode, uint8_t typeflag, uint64_t mtime,
                   uint8_t* out) {
  if (name_len > 100) return -1;
  std::memset(out, 0, 512);
  std::memcpy(out, name, name_len);
  auto write_octal = [&](long start, long len, uint64_t val) {
    long idx = start + len - 1;
    out[idx] = ' ';
    while (idx > start) {
      --idx;
      out[idx] = '0' + static_cast<uint8_t>(val & 7);
      val >>= 3;
    }
  };
  write_octal(100, 8, mode);
  write_octal(108, 8, 0);
  write_octal(116, 8, 0);
  write_octal(124, 12, size);
  write_octal(136, 12, mtime);
  out[156] = typeflag;
  std::memcpy(out + 257, "ustar\0" "00", 8);
  std::memset(out + 148, ' ', 8);
  uint32_t csum = 0;
  for (int i = 0; i < 512; ++i) csum += out[i];
  write_octal(148, 8, csum);
  return 0;
}

// Exact float64 SDF render of a glyph batch (see ops/sdf_ref.py for
// the semantics proof vs the reference's R-tree + scanline sweep).
// segs: [total_S][4] rows (vx, vy, wx, wy); per-glyph runs given by
// seg_offs[n+1]. meta: [n][4] = x0, y0, w, h. out: concatenated
// bitmaps at out_offs[n+1] (each w*h bytes, Y-flipped row-major).
long vg_render_sdf_batch(const double* segs, const int64_t* seg_offs,
                         const int32_t* meta, long n_glyphs, uint8_t* out,
                         const int64_t* out_offs, int n_threads) {
  std::atomic<long> next{0};
  auto worker = [&]() {
    for (;;) {
      long g = next.fetch_add(1);
      if (g >= n_glyphs) return;
      const double* s = segs + 4 * seg_offs[g];
      long ns = seg_offs[g + 1] - seg_offs[g];
      int32_t x0 = meta[4 * g + 0], y0 = meta[4 * g + 1];
      int32_t w = meta[4 * g + 2], h = meta[4 * g + 3];
      uint8_t* bm = out + out_offs[g];
      const double x0f = x0 + 0.5, y0f = y0 + 0.5;
      for (int32_t y = 0; y < h; ++y) {
        const double py = y + y0f;
        for (int32_t x = 0; x < w; ++x) {
          const double px = x + x0f;
          double best = HUGE_VAL;
          int wn = 0;
          for (long k = 0; k < ns; ++k) {
            const double vx = s[4 * k + 0], vy = s[4 * k + 1];
            const double wx = s[4 * k + 2], wy = s[4 * k + 3];
            const double dx = wx - vx, dy = wy - vy;
            // Distance: exact formula of segment.rs:54-96.
            const double l2 = dx * dx + dy * dy;
            double qx, qy;
            if (l2 == 0.0) {
              qx = vx;
              qy = vy;
            } else {
              const double t = ((px - vx) * dx + (py - vy) * dy) / l2;
              if (t < 0.0) {
                qx = vx;
                qy = vy;
              } else if (t > 1.0) {
                qx = wx;
                qy = wy;
              } else {
                qx = vx + t * dx;
                qy = vy + t * dy;
              }
            }
            const double ddx = px - qx, ddy = py - qy;
            const double d2 = ddx * ddx + ddy * ddy;
            if (d2 < best) best = d2;
            // Winding: half-open crossings, cx <= px convention
            // (renderer_precise.rs:40-67 re-expressed as a masked sum).
            if (vy <= py) {
              if (wy > py) {
                const double t = (py - vy) / (wy - vy);
                const double cx = vx + t * (wx - vx);
                if (cx <= px) wn += 1;
              }
            } else if (wy <= py) {
              const double t = (py - vy) / (wy - vy);
              const double cx = vx + t * (wx - vx);
              if (cx <= px) wn -= 1;
            }
          }
          double d = std::sqrt(best);
          if (wn != 0) d = -d;
          d = d * (256.0 / 8.0) + 64.0;
          double v = 255.0 - d;
          if (v < 0.0) v = 0.0;
          if (v > 255.0) v = 255.0;
          // Rust f64::round — half away from zero; v >= 0 here.
          bm[(h - 1 - y) * static_cast<long>(w) + x] =
              static_cast<uint8_t>(std::floor(v + 0.5));
        }
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native TrueType glyf outline extraction + flattening.
//
// Replaces the per-glyph fontTools pen walk (the host ingest hot loop)
// with a direct parse of the binary glyf table, reproducing exactly the
// fontTools/ttf-parser outline semantics our goldens were validated
// against (and the reference validates via ttf_parser::Face::
// outline_glyph, reference/src/render/renderer.rs:109-111):
//
//  - TrueType quadratic contours with implied on-curve midpoints
//    between consecutive off-curve points;
//  - contour start rules: first point on-curve -> start there; else
//    last point on-curve -> start there (rotated); else start at the
//    midpoint of first and last (computed on RAW coordinates, then
//    transformed - matching glyf.draw + TransformPen order);
//  - composite glyphs: 2x2 F2Dot14 transforms + raw (unscaled) int
//    offsets, applied innermost-first per point exactly like nested
//    fontTools TransformPens (bit-identical f64);
//  - De Casteljau flattening with the reference's flatness predicate
//    (s + e - 2c)^2 <= tol^2, right half pushed first
//    (reference/src/geometry/ring.rs:119-144), and the ring
//    close/drop rules of src/render/ring_builder.rs:33-54.
// ---------------------------------------------------------------------------

namespace {

inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}
inline int16_t rd_i16(const uint8_t* p) {
  return static_cast<int16_t>((p[0] << 8) | p[1]);
}
inline uint32_t rd_u32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

constexpr double kF64Eps = 2.220446049250313e-16;

// Affine (a b c d e f): x' = a*x + c*y + e ; y' = b*x + d*y + f
// (fontTools Transform convention).
struct Affine {
  double a, b, c, d, e, f;
};

struct RingSink {
  double tol_sq;
  // Flattened output
  std::vector<double> pts;        // x,y interleaved, all rings
  std::vector<int32_t> ring_lens; // points per kept ring
  // Current ring under construction
  std::vector<double> cur;
  // A drawing op arrived with no open ring (curve/line before any
  // moveto): the native walk gives up on the glyph, and the caller walks
  // it as fontTools does (which moves to the current point first).
  bool bad = false;

  void move_to(double x, double y) {
    save_ring();
    cur.push_back(x);
    cur.push_back(y);
  }
  void line_to(double x, double y) {
    if (cur.empty()) {
      bad = true;
      return;
    }
    cur.push_back(x);
    cur.push_back(y);
  }
  void quad_to(double cx, double cy, double ex, double ey) {
    if (cur.empty()) {
      bad = true;
      return;
    }
    double sx = cur[cur.size() - 2], sy = cur[cur.size() - 1];
    // Explicit stack, right half pushed first (start->end order).
    struct Q { double sx, sy, cx, cy, ex, ey; };
    Q stack[64];
    int top = 0;
    stack[top++] = {sx, sy, cx, cy, ex, ey};
    while (top) {
      Q q = stack[--top];
      double dx = q.sx + q.ex - q.cx * 2.0;
      double dy = q.sy + q.ey - q.cy * 2.0;
      if (dx * dx + dy * dy <= tol_sq || top >= 62) {
        cur.push_back(q.ex);
        cur.push_back(q.ey);
        continue;
      }
      double m1x = (q.sx + q.cx) / 2.0, m1y = (q.sy + q.cy) / 2.0;
      double m2x = (q.cx + q.ex) / 2.0, m2y = (q.cy + q.ey) / 2.0;
      double mx = (m1x + m2x) / 2.0, my = (m1y + m2y) / 2.0;
      stack[top++] = {mx, my, m2x, m2y, q.ex, q.ey};
      stack[top++] = {q.sx, q.sy, m1x, m1y, mx, my};
    }
  }
  void close_path() { save_ring(); }

  void save_ring() {
    size_t n = cur.size() / 2;
    if (n < 3) {
      cur.clear();
      return;
    }
    double fx = cur[0], fy = cur[1];
    double lx = cur[cur.size() - 2], ly = cur[cur.size() - 1];
    if (std::fabs(fx - lx) > kF64Eps || std::fabs(fy - ly) > kF64Eps) {
      cur.push_back(fx);
      cur.push_back(fy);
      ++n;
    }
    if (n < 4) {
      cur.clear();
      return;
    }
    pts.insert(pts.end(), cur.begin(), cur.end());
    ring_lens.push_back(static_cast<int32_t>(n));
    cur.clear();
  }
};

struct CubicSink : RingSink {
  void cubic_to(double c1x, double c1y, double c2x, double c2y, double ex,
                double ey) {
    if (cur.empty()) {
      bad = true;
      return;
    }
    double sx = cur[cur.size() - 2], sy = cur[cur.size() - 1];
    // Flatness ((c2+c1)-(s+e))^2 <= tol^2, right half pushed first
    // (reference/src/geometry/ring.rs:159-187).
    struct C { double sx, sy, c1x, c1y, c2x, c2y, ex, ey; };
    C stack[64];
    int top = 0;
    stack[top++] = {sx, sy, c1x, c1y, c2x, c2y, ex, ey};
    while (top) {
      C q = stack[--top];
      double dx = (q.c2x + q.c1x) - (q.sx + q.ex);
      double dy = (q.c2y + q.c1y) - (q.sy + q.ey);
      if (dx * dx + dy * dy <= tol_sq || top >= 60) {
        cur.push_back(q.ex);
        cur.push_back(q.ey);
        continue;
      }
      double p01x = (q.sx + q.c1x) / 2.0, p01y = (q.sy + q.c1y) / 2.0;
      double p12x = (q.c1x + q.c2x) / 2.0, p12y = (q.c1y + q.c2y) / 2.0;
      double p23x = (q.c2x + q.ex) / 2.0, p23y = (q.c2y + q.ey) / 2.0;
      double p012x = (p01x + p12x) / 2.0, p012y = (p01y + p12y) / 2.0;
      double p123x = (p12x + p23x) / 2.0, p123y = (p12y + p23y) / 2.0;
      double mx = (p012x + p123x) / 2.0, my = (p012y + p123y) / 2.0;
      stack[top++] = {mx, my, p123x, p123y, p23x, p23y, q.ex, q.ey};
      stack[top++] = {q.sx, q.sy, p01x, p01y, p012x, p012y, mx, my};
    }
  }
};

struct GlyfCtx {
  const uint8_t* glyf;
  long glyf_len;
  const uint32_t* loca;
  long n_glyphs;  // loca has n_glyphs + 1 entries
};

// Parse one glyph (recursing through composites). `stack`/`depth` hold
// the enclosing component transforms, outermost first. Returns false on
// malformed/unsupported data (the caller then walks it as fontTools
// draws it, `ft_glyf`).
// `Sink` is RingSink (flattened rings) or SegSink (the segments).
template <class Sink>
bool parse_glyph(const GlyfCtx& ctx, uint32_t gid, Sink& sink,
                 const Affine* stack, int depth) {
  if (gid >= static_cast<uint32_t>(ctx.n_glyphs) || depth > 8) return false;
  uint32_t off = ctx.loca[gid], end = ctx.loca[gid + 1];
  if (off == end) return true;  // empty glyph
  if (end > static_cast<uint32_t>(ctx.glyf_len) || end - off < 10) return false;
  const uint8_t* p = ctx.glyf + off;
  const uint8_t* pe = ctx.glyf + end;
  int16_t nc = rd_i16(p);
  p += 10;  // skip bbox

  if (nc < 0) {
    // Composite glyph.
    for (;;) {
      if (p + 4 > pe) return false;
      uint16_t flags = rd_u16(p);
      uint16_t cgid = rd_u16(p + 2);
      p += 4;
      double dx, dy;
      if (flags & 0x0001) {  // ARG_1_AND_2_ARE_WORDS
        if (p + 4 > pe) return false;
        if (!(flags & 0x0002)) return false;  // point-matching args: bail
        dx = rd_i16(p);
        dy = rd_i16(p + 2);
        p += 4;
      } else {
        if (p + 2 > pe) return false;
        if (!(flags & 0x0002)) return false;
        dx = static_cast<int8_t>(p[0]);
        dy = static_cast<int8_t>(p[1]);
        p += 2;
      }
      Affine t{1.0, 0.0, 0.0, 1.0, dx, dy};
      if (flags & 0x0008) {  // WE_HAVE_A_SCALE
        if (p + 2 > pe) return false;
        t.a = t.d = rd_i16(p) / 16384.0;
        p += 2;
      } else if (flags & 0x0040) {  // X_AND_Y_SCALE
        if (p + 4 > pe) return false;
        t.a = rd_i16(p) / 16384.0;
        t.d = rd_i16(p + 2) / 16384.0;
        p += 4;
      } else if (flags & 0x0080) {  // TWO_BY_TWO
        if (p + 8 > pe) return false;
        t.a = rd_i16(p) / 16384.0;
        t.b = rd_i16(p + 2) / 16384.0;
        t.c = rd_i16(p + 4) / 16384.0;
        t.d = rd_i16(p + 6) / 16384.0;
        p += 8;
      }
      Affine child_stack[10];
      for (int i = 0; i < depth; ++i) child_stack[i] = stack[i];
      child_stack[depth] = t;
      if (!parse_glyph(ctx, cgid, sink, child_stack, depth + 1)) return false;
      if (!(flags & 0x0020)) break;  // MORE_COMPONENTS
    }
    return true;
  }

  // Simple glyph.
  int n_contours = nc;
  if (p + 2 * n_contours + 2 > pe) return false;
  std::vector<uint16_t> ends(n_contours);
  for (int i = 0; i < n_contours; ++i) ends[i] = rd_u16(p + 2 * i);
  p += 2 * n_contours;
  uint16_t ilen = rd_u16(p);
  p += 2 + ilen;
  if (p > pe) return false;
  int npts = n_contours ? ends[n_contours - 1] + 1 : 0;
  if (npts == 0) return true;

  std::vector<uint8_t> flags(npts);
  for (int i = 0; i < npts;) {
    if (p >= pe) return false;
    uint8_t f = *p++;
    flags[i++] = f;
    if (f & 0x08) {  // REPEAT
      if (p >= pe) return false;
      int rep = *p++;
      while (rep-- && i < npts) flags[i++] = f;
    }
  }
  std::vector<double> xs(npts), ys(npts);
  {
    long v = 0;
    for (int i = 0; i < npts; ++i) {
      uint8_t f = flags[i];
      if (f & 0x02) {  // x short
        if (p >= pe) return false;
        v += (f & 0x10) ? *p : -static_cast<int>(*p);
        ++p;
      } else if (!(f & 0x10)) {
        if (p + 2 > pe) return false;
        v += rd_i16(p);
        p += 2;
      }
      xs[i] = static_cast<double>(v);
    }
    v = 0;
    for (int i = 0; i < npts; ++i) {
      uint8_t f = flags[i];
      if (f & 0x04) {  // y short
        if (p >= pe) return false;
        v += (f & 0x20) ? *p : -static_cast<int>(*p);
        ++p;
      } else if (!(f & 0x20)) {
        if (p + 2 > pe) return false;
        v += rd_i16(p);
        p += 2;
      }
      ys[i] = static_cast<double>(v);
    }
  }

  // Transform chain: innermost (deepest) component transform first —
  // exactly the order nested fontTools TransformPens apply.
  auto xf = [&](double x, double y, double* ox, double* oy) {
    for (int i = depth - 1; i >= 0; --i) {
      const Affine& t = stack[i];
      double nx = t.a * x + t.c * y + t.e;
      double ny = t.b * x + t.d * y + t.f;
      x = nx;
      y = ny;
    }
    *ox = x;
    *oy = y;
  };

  int start = 0;
  for (int ci = 0; ci < n_contours; ++ci) {
    int cend = ends[ci];  // inclusive
    if (cend >= npts) return false;  // an end past the points: fontTools' walk decides
    int k = cend - start + 1;
    if (k <= 0) {
      start = cend + 1;
      continue;
    }
    const double* cxs = xs.data() + start;
    const double* cys = ys.data() + start;
    const uint8_t* cfl = flags.data() + start;

    // Cubic glyf off-curves (flag 0x80, variable-font extension): not
    // in scope for this parser — the caller takes `ft_glyf`.
    for (int i = 0; i < k; ++i) {
      if (cfl[i] & 0x80) return false;
    }

    // Start point + iteration order (glyf.draw semantics,
    // fontTools _g_l_y_f.py:1488-1569): the contour is rotated to END
    // at its FIRST on-curve point, which becomes the moveTo; with no
    // on-curve point at all, the start is the implied midpoint of the
    // last and first off-curve points.
    int f = -1;
    for (int i = 0; i < k; ++i) {
      if (cfl[i] & 1) {
        f = i;
        break;
      }
    }
    double sx, sy;
    if (f < 0) {
      // All-off-curve: BasePen computes the implied start from the
      // TRANSFORMED first/last points (basePen.py qCurveTo None case).
      double ax, ay, bx, by;
      xf(cxs[0], cys[0], &ax, &ay);
      xf(cxs[k - 1], cys[k - 1], &bx, &by);
      sx = 0.5 * (bx + ax);
      sy = 0.5 * (by + ay);
    } else {
      xf(cxs[f], cys[f], &sx, &sy);
    }
    sink.move_to(sx, sy);

    bool have_pend = false;
    double pcx = 0.0, pcy = 0.0;
    // Iterate the k-1 points after the start (wrapping) for the
    // on-curve case, or all k points for the all-off-curve case.
    int count = (f < 0) ? k : k - 1;
    for (int j = 0; j < count; ++j) {
      int i = (f < 0) ? j : (f + 1 + j) % k;
      double px, py;
      xf(cxs[i], cys[i], &px, &py);
      if (cfl[i] & 1) {
        if (have_pend) {
          sink.quad_to(pcx, pcy, px, py);
          have_pend = false;
        } else {
          sink.line_to(px, py);
        }
      } else {
        if (have_pend) {
          sink.quad_to(pcx, pcy, 0.5 * (pcx + px), 0.5 * (pcy + py));
        }
        pcx = px;
        pcy = py;
        have_pend = true;
      }
    }
    if (have_pend) {
      sink.quad_to(pcx, pcy, sx, sy);
    }
    sink.close_path();
    start = cend + 1;
  }
  return true;
}

// ---------------------------------------------------------------------------
// A glyf glyph as fontTools 4.61.1 draws it (`_TTGlyphGlyf.draw`,
// `Glyph.draw` under a BasePen), for the glyphs `parse_glyph` gives up
// on and for the segments of every glyph (the JAX package draws the fit
// path's curves through fontTools' pen). Where it differs from the
// native walk: a top-level simple glyph is moved by hmtx's lsb - xMin; a
// component's transform is composed onto the one in force
// (`TransformPen.addComponent`: one transform, not one a level) and
// points pass through it once; contours of cubic off-curve points (flag
// 0x80) are drawn, their implied on-curve points taken between the raw
// points before the transform; nesting goes 64 deep. Point-matched
// components raise in fontTools (`getComponentInfo` reads an `x` they do
// not have), and so do a mixed quadratic/cubic segment, an odd run of
// cubic off-curve points and a component glyph id past the glyph order:
// false, the glyph's -1.
// ---------------------------------------------------------------------------

constexpr int kFtGlyfDepth = 64;

// fontTools' Transform.transform: `t` (in force) composed with `c`.
inline Affine compose(const Affine& t, const Affine& c) {
  return {c.a * t.a + c.b * t.c, c.a * t.b + c.b * t.d,
          c.c * t.a + c.d * t.c, c.c * t.b + c.d * t.d,
          t.a * c.e + t.c * c.f + t.e, t.b * c.e + t.d * c.f + t.f};
}

inline bool is_identity(const Affine& t) {
  return t.a == 1.0 && t.b == 0.0 && t.c == 0.0 && t.d == 1.0 && t.e == 0.0 &&
         t.f == 0.0;
}

template <class Sink>
bool ft_glyf(const GlyfCtx& ctx, uint32_t gid, Sink& sink, const Affine& t,
             bool xf, int depth, const int16_t* lsb, long n_lsb) {
  if (gid >= static_cast<uint32_t>(ctx.n_glyphs) || depth > kFtGlyfDepth)
    return false;
  uint32_t off = ctx.loca[gid], end = ctx.loca[gid + 1];
  if (off == end) return true;
  if (end > static_cast<uint32_t>(ctx.glyf_len) || end < off || end - off < 10)
    return false;
  const uint8_t* p = ctx.glyf + off;
  const uint8_t* pe = ctx.glyf + end;
  const int16_t nc = rd_i16(p);
  const int16_t x_min = rd_i16(p + 2);
  p += 10;
  // fontTools takes -1 alone for a composite; another negative count
  // fails its decompile of the points.
  if (nc < -1) return false;
  if (nc < 0) {
    for (;;) {
      if (p + 4 > pe) return false;
      const uint16_t flags = rd_u16(p);
      const uint16_t cgid = rd_u16(p + 2);
      p += 4;
      if (!(flags & 0x0002)) return false;  // point-matched
      Affine c{1.0, 0.0, 0.0, 1.0, 0.0, 0.0};
      if (flags & 0x0001) {
        if (p + 4 > pe) return false;
        c.e = rd_i16(p);
        c.f = rd_i16(p + 2);
        p += 4;
      } else {
        if (p + 2 > pe) return false;
        c.e = static_cast<int8_t>(p[0]);
        c.f = static_cast<int8_t>(p[1]);
        p += 2;
      }
      if (flags & 0x0008) {
        if (p + 2 > pe) return false;
        c.a = c.d = rd_i16(p) / 16384.0;
        p += 2;
      } else if (flags & 0x0040) {
        if (p + 4 > pe) return false;
        c.a = rd_i16(p) / 16384.0;
        c.d = rd_i16(p + 2) / 16384.0;
        p += 4;
      } else if (flags & 0x0080) {
        if (p + 8 > pe) return false;
        c.a = rd_i16(p) / 16384.0;
        c.b = rd_i16(p + 2) / 16384.0;
        c.c = rd_i16(p + 4) / 16384.0;
        c.d = rd_i16(p + 6) / 16384.0;
        p += 8;
      }
      const Affine m = xf ? compose(t, c) : c;
      if (!ft_glyf(ctx, cgid, sink, m, !is_identity(m), depth + 1, lsb, n_lsb))
        return false;
      if (!(flags & 0x0020)) break;
    }
    return true;
  }
  const int n_contours = nc;
  if (p + 2 * n_contours + 2 > pe) return false;
  std::vector<uint16_t> ends(n_contours);
  for (int i = 0; i < n_contours; ++i) ends[i] = rd_u16(p + 2 * i);
  p += 2 * n_contours;
  // fontTools reads the instruction length signed; a negative one moves
  // its read position back, which is not reproduced (-1 here).
  const int16_t ilen = rd_i16(p);
  if (ilen < 0) return false;
  p += 2 + ilen;
  if (p > pe) return false;
  const int npts = n_contours ? ends[n_contours - 1] + 1 : 0;
  if (npts == 0) return true;
  std::vector<uint8_t> flags(npts);
  for (int i = 0; i < npts;) {
    if (p >= pe) return false;
    uint8_t f = *p++;
    flags[i++] = f;
    if (f & 0x08) {
      if (p >= pe) return false;
      int rep = *p++;
      if (i + rep > npts) return false;  // fontTools: an IndexError past the points
      while (rep--) flags[i++] = f;
    }
  }
  std::vector<double> xs(npts), ys(npts);
  for (int axis = 0; axis < 2; ++axis) {
    const uint8_t short_bit = axis ? 0x04 : 0x02, same_bit = axis ? 0x20 : 0x10;
    long v = 0;
    for (int i = 0; i < npts; ++i) {
      const uint8_t f = flags[i];
      if (f & short_bit) {
        if (p >= pe) return false;
        v += (f & same_bit) ? *p : -static_cast<int>(*p);
        ++p;
      } else if (!(f & same_bit)) {
        if (p + 2 > pe) return false;
        v += rd_i16(p);
        p += 2;
      }
      (axis ? ys : xs)[i] = static_cast<double>(v);
    }
  }
  if (depth == 0) {  // the top-level glyph is moved by lsb - xMin
    if (lsb == nullptr || gid >= static_cast<uint32_t>(n_lsb)) return false;
    const double shift = static_cast<double>(lsb[gid] - x_min);
    if (shift != 0.0)
      for (double& x : xs) x = x + shift;
  }
  auto pt = [&](double x, double y, double* ox, double* oy) {
    if (xf) {
      *ox = t.a * x + t.c * y + t.e;
      *oy = t.b * x + t.d * y + t.f;
    } else {
      *ox = x;
      *oy = y;
    }
  };
  auto cubic = [&](double ax, double ay, double bx, double by, double cx, double cy) {
    double q[6];
    pt(ax, ay, &q[0], &q[1]);
    pt(bx, by, &q[2], &q[3]);
    pt(cx, cy, &q[4], &q[5]);
    sink.cubic_to(q[0], q[1], q[2], q[3], q[4], q[5]);
  };
  int start = 0;
  for (int ci = 0; ci < n_contours; ++ci) {
    // The contour is coordinates[start:end + 1] as a Python slice (cut at
    // the points there are); an empty one raises in fontTools
    // (qCurveTo(None) finds no point).
    const int k = std::min<int>(ends[ci] + 1, npts) - start;
    if (k <= 0) return false;
    const double* cx = xs.data() + start;
    const double* cy = ys.data() + start;
    const uint8_t* cf = flags.data() + start;
    start = ends[ci] + 1;
    int f = -1;
    for (int i = 0; i < k; ++i)
      if (cf[i] & 1) {
        f = i;
        break;
      }
    if (f < 0) {
      int n_cubic = 0;
      for (int i = 0; i < k; ++i) n_cubic += (cf[i] & 0x80) != 0;
      if (n_cubic != 0 && n_cubic != k) return false;
      if (n_cubic == k) {
        if (k % 2) return false;
        double sx, sy;
        pt((cx[k - 1] + cx[0]) * 0.5, (cy[k - 1] + cy[0]) * 0.5, &sx, &sy);
        sink.move_to(sx, sy);
        for (int i = 0; i < k; i += 2) {
          const int j = i + 2 < k ? i + 2 : 0;
          cubic(cx[i], cy[i], cx[i + 1], cy[i + 1], (cx[i + 1] + cx[j]) * 0.5,
                (cy[i + 1] + cy[j]) * 0.5);
        }
        sink.close_path();
        continue;
      }
      // All quadratic off-curve points: the implied start between the
      // transformed last and first points (BasePen.qCurveTo's None end).
      double ax, ay, bx, by;
      pt(cx[0], cy[0], &ax, &ay);
      pt(cx[k - 1], cy[k - 1], &bx, &by);
      const double sx = 0.5 * (bx + ax), sy = 0.5 * (by + ay);
      sink.move_to(sx, sy);
      double pcx = 0.0, pcy = 0.0;
      bool pend = false;
      for (int i = 0; i < k; ++i) {
        double px, py;
        pt(cx[i], cy[i], &px, &py);
        if (pend) sink.quad_to(pcx, pcy, 0.5 * (pcx + px), 0.5 * (pcy + py));
        pcx = px;
        pcy = py;
        pend = true;
      }
      sink.quad_to(pcx, pcy, sx, sy);
      sink.close_path();
      continue;
    }
    // Rotated to end at the first on-curve point (the moveTo); then each
    // run of off-curve points up to the next on-curve one is a quadratic
    // or a cubic segment, a lone on-curve point a line (the last one,
    // back to the start, is closePath's).
    std::vector<int> order(k);
    for (int i = 0; i < k; ++i) order[i] = (f + 1 + i) % k;
    double sx, sy;
    pt(cx[f], cy[f], &sx, &sy);
    sink.move_to(sx, sy);
    int i = 0;
    while (i < k) {
      int nx = i;
      while (!(cf[order[nx]] & 1)) ++nx;  // the contour ends on-curve
      const int n_off = nx - i;
      if (n_off == 0) {
        if (k - i > 1) {
          double px, py;
          pt(cx[order[i]], cy[order[i]], &px, &py);
          sink.line_to(px, py);
        }
      } else {
        int n_cubic = 0;
        for (int j = i; j < nx; ++j) n_cubic += (cf[order[j]] & 0x80) != 0;
        if (n_cubic != 0 && n_cubic != n_off) return false;
        if (n_cubic) {
          const int count = n_off + 1;
          if (count < 3 || (count - 1) % 2) return false;
          for (int j = 0; j < count - 3; j += 2) {
            const int a = order[i + j], b = order[i + j + 1], c = order[i + j + 2];
            cubic(cx[a], cy[a], cx[b], cy[b], (cx[b] + cx[c]) * 0.5,
                  (cy[b] + cy[c]) * 0.5);
          }
          const int a = order[i + count - 3], b = order[i + count - 2], c = order[nx];
          cubic(cx[a], cy[a], cx[b], cy[b], cx[c], cy[c]);
        } else {
          double pcx, pcy;
          pt(cx[order[i]], cy[order[i]], &pcx, &pcy);
          for (int j = i + 1; j <= nx; ++j) {
            double px, py;
            pt(cx[order[j]], cy[order[j]], &px, &py);
            if (j < nx) {
              sink.quad_to(pcx, pcy, 0.5 * (pcx + px), 0.5 * (pcy + py));
              pcx = px;
              pcy = py;
            } else {
              sink.quad_to(pcx, pcy, px, py);
            }
          }
        }
      }
      i = nx + 1;
    }
    sink.close_path();
  }
  return true;
}

}  // namespace

extern "C" {

// Flattened rings for a batch of glyph ids, straight from the raw glyf
// table, in fontTools' drawing (`ft_glyf`, moving a top-level simple
// glyph by lsb - xMin) where the native walk gives up, unless `ft` is 0
// (no glyph set in fontTools: no readable hmtx). Outputs: pts (x,y
// interleaved f64), ring_lens (points per ring), glyph_nrings[n_gids]
// (rings per glyph; -1 where fontTools fails to draw the glyph too).
// out_counts[2] = total points, total rings actually needed. Returns 0 on success, 1 when a
// capacity was exceeded (re-call with out_counts-sized buffers).
long vg_glyf_rings(const uint8_t* glyf, long glyf_len, const uint32_t* loca,
                   long n_glyphs, long ft, const int16_t* lsb, long n_lsb,
                   const uint32_t* gids, long n_gids,
                   double tol_sq, double* pts, long pts_cap,
                   int32_t* ring_lens, long rings_cap, int32_t* glyph_nrings,
                   int64_t* out_counts) {
  GlyfCtx ctx{glyf, glyf_len, loca, n_glyphs};

  // Phase 1 (parallel): parse+flatten each glyph into its own buffers
  // — glyphs are independent and the table bytes are read-only. The
  // pool size follows the batch (one font is ~2.7k glyphs; spawning
  // more threads than work would cost more than it saves).
  struct GlyphOut {
    std::vector<double> pts;
    std::vector<int32_t> ring_lens;
    bool ok = false;
  };
  std::vector<GlyphOut> outs(n_gids);
  std::atomic<long> next{0};
  auto worker = [&]() {
    CubicSink sink;
    sink.tol_sq = tol_sq;
    const Affine id{1.0, 0.0, 0.0, 1.0, 0.0, 0.0};
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_gids) return;
      sink.pts.clear();
      sink.ring_lens.clear();
      sink.cur.clear();
      bool ok = parse_glyph(ctx, gids[i], sink, nullptr, 0);
      if (!ok && ft) {  // fontTools' drawing, as the JAX package's pen route
        sink.pts.clear();
        sink.ring_lens.clear();
        sink.cur.clear();
        ok = ft_glyf(ctx, gids[i], sink, id, false, 0, lsb, n_lsb);
      }
      if (!ok) continue;
      sink.save_ring();
      outs[i].pts = std::move(sink.pts);
      outs[i].ring_lens = std::move(sink.ring_lens);
      outs[i].ok = true;
    }
  };
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads > 8) n_threads = 8;
  if (n_gids < 256 || n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  // Phase 2 (serial): concatenate in glyph order.
  long npts = 0, nrings = 0;
  bool overflow = false;
  for (long i = 0; i < n_gids; ++i) {
    if (!outs[i].ok) {
      glyph_nrings[i] = -1;
      continue;
    }
    long gp = static_cast<long>(outs[i].pts.size() / 2);
    long gr = static_cast<long>(outs[i].ring_lens.size());
    if (!overflow && npts + gp <= pts_cap && nrings + gr <= rings_cap) {
      std::memcpy(pts + 2 * npts, outs[i].pts.data(),
                  outs[i].pts.size() * sizeof(double));
      std::memcpy(ring_lens + nrings, outs[i].ring_lens.data(),
                  gr * sizeof(int32_t));
    } else {
      overflow = true;
    }
    glyph_nrings[i] = static_cast<int32_t>(gr);
    npts += gp;
    nrings += gr;
  }
  out_counts[0] = npts;
  out_counts[1] = nrings;
  return overflow ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native CFF (Type 2 charstrings) outline extraction + flattening.
//
// The CFF twin of vg_glyf_rings: parses the raw 'CFF ' table (header,
// INDEX structures, Top/Private DICTs, charsets-free gid addressing,
// CID FDArray/FDSelect) and interprets each glyph's Type 2 charstring
// into the same RingSink, so OTF fonts get the vectorized host prep
// path (render/metrics.build_cores) that TrueType fonts already have.
// Reference capability: ttf_parser::Face::outline_glyph handles CFF
// the same way (reference/src/render/renderer.rs:109-111).
//
// Where this native walk (`run_t2`, the JAX package's own) gives up on
// a glyph, the glyph is walked again as fontTools draws it (`ft_loop`
// below), since the JAX package draws that glyph with fontTools' pen;
// a CFF2 glyph, and the segments of every glyph, take that walk alone.
// The cases, each as fontTools 4.61.1 decides it:
//  - seac (endchar with 4 operands): drawn — the base, then the accent
//    moved by (adx, ady), glyphs named by StandardEncoding and found by
//    SID in the charset (a name the font lacks: the component skipped;
//    a code that is not an integer or lies past 255: -1);
//  - a drawing operator before any moveto: a moveto to the current
//    point first; operators after endchar and return: run;
//  - operand counts: the ones fontTools unpacks (a short or odd run of
//    curve or line operands, flex ops with other counts: -1), and the
//    width taken by popallWidth (a CFF2 charstring with one: -1);
//  - stack depth: unbounded (the native walk's 48 is the spec's);
//  - subr nesting: 256 levels (fontTools: Python's recursion limit);
//    a subr index wraps as a Python list index; none: -1;
//  - hintmask: the first one counts the hints, later ones read its byte
//    count and leave the stack;
//  - operators: div computed as Python divides; the other arithmetic
//    and storage operators (and, or, not, abs, add, sub, neg, eq, drop,
//    put, get, ifelse, random, mul, sqrt, dup, exch, index, roll,
//    store, load) raise NotImplementedError: -1; dotsection: nothing;
//    an operator fontTools does not know (a reserved one) ends the
//    charstring; blend and vsindex in a CFF charstring (no
//    VariationStore): -1.
// Not reproduced: a subr holding hintmask reached under different hint
// counts (fontTools keeps the first decompiled program), a charset SID
// whose custom string equals a standard name (found by name in
// fontTools), the Expert charsets, a seac in CFF2 (-1 here), nesting
// between 256 levels and Python's recursion limit, a glyph running more
// than 2^24 tokens or holding more than 2^20 operands (-1 here; fontTools
// runs on), a CFF table the native parser rejects as a whole (every
// glyph -1; fontTools reads an INDEX's items one at a time), a glyf
// instruction length above 0x7FFF (fontTools reads it signed; -1 here),
// and a second draw of a glyph whose first failed (fontTools keeps the
// glyph half-read and may then draw it; the port gives the first
// draw's result every time).
// ---------------------------------------------------------------------------

namespace {

struct CffSlice {
  const uint8_t* p = nullptr;
  long len = 0;
};

struct CffIndexView {
  long count = 0;
  int off_size = 0;
  const uint8_t* offsets = nullptr;  // (count+1) offsets, 1-based
  const uint8_t* data = nullptr;
  long endoff = 0;  // validated off_at(count): bounds every slice

  long off_at(long i) const {
    uint64_t v = 0;
    const uint8_t* q = offsets + i * off_size;
    for (int k = 0; k < off_size; ++k) v = (v << 8) | q[k];
    return static_cast<long>(v);
  }
  CffSlice get(long i) const {
    if (i < 0 || i >= count) return {};
    // Intermediate offsets are attacker-controlled bytes: only the
    // final offset was range-checked at parse time, so clamp each
    // slice to [1, endoff] (out-of-range -> empty slice -> the caller
    // gives up, as for other malformed constructs).
    long a = off_at(i), b = off_at(i + 1);
    if (a < 1 || b < a || b > endoff) return {};
    return {data + (a - 1), b - a};
  }
};

// Parses an INDEX at p (a CFF2 INDEX has a 32-bit count); sets *next to
// the first byte after it.
bool parse_cff_index(const uint8_t* p, const uint8_t* pe, CffIndexView* idx,
                     const uint8_t** next, bool cff2 = false) {
  const int cw = cff2 ? 4 : 2;
  if (pe - p < cw) return false;
  long count = cff2 ? static_cast<long>(rd_u32(p)) : rd_u16(p);
  if (count == 0) {
    idx->count = 0;
    *next = p + cw;
    return true;
  }
  if (pe - p < cw + 1) return false;
  int osz = p[cw];
  if (osz < 1 || osz > 4) return false;
  const uint8_t* offs = p + cw + 1;
  if ((pe - offs) / osz < count + 1) return false;
  const uint8_t* data = offs + (count + 1) * osz;  // offset 1 = first byte
  idx->count = count;
  idx->off_size = osz;
  idx->offsets = offs;
  idx->data = data;
  long endoff = idx->off_at(count);
  if (endoff < 1 || endoff - 1 > pe - data) return false;
  idx->endoff = endoff;
  *next = data + (endoff - 1);
  return true;
}

// Minimal DICT scan for the integer operands we need. A CFF2 DICT also
// has the operators vsindex (22), blend (23), vstore (24) and maxstack
// (25); a blend's operands are dropped (no operand read here is blended).
struct DictInts {
  long charstrings = -1;
  long private_off = -1, private_size = -1;
  long subrs = -1;   // from a Private DICT (relative offset)
  long fdarray = -1, fdselect = -1;
  long charset = 0;  // 0 = ISOAdobe (the default)
  long vsindex = -1; // from a CFF2 Private DICT; -1 = absent
  long vstore = -1;  // CFF2 Top DICT
  bool is_cid = false;
};

bool parse_cff_dict(const uint8_t* p, const uint8_t* pe, DictInts* out,
                    bool cff2 = false) {
  double stack[48];
  int sp = 0;
  while (p < pe) {
    uint8_t b0 = *p;
    if (b0 <= 21 || (cff2 && b0 >= 22 && b0 <= 25)) {
      int op = b0;
      ++p;
      if (b0 == 12) {
        if (p >= pe) return false;
        op = 1200 + *p++;
      }
      switch (op) {
        case 15: if (sp >= 1) out->charset = (long)stack[0]; break;
        case 17: if (sp >= 1) out->charstrings = (long)stack[0]; break;
        case 18:
          if (sp >= 2) {
            out->private_size = (long)stack[0];
            out->private_off = (long)stack[1];
          }
          break;
        case 19: if (sp >= 1) out->subrs = (long)stack[0]; break;
        case 22: if (sp >= 1) out->vsindex = (long)stack[0]; break;
        case 24: if (sp >= 1) out->vstore = (long)stack[0]; break;
        case 1230: out->is_cid = true; break;  // ROS
        case 1236: if (sp >= 1) out->fdarray = (long)stack[0]; break;
        case 1237: if (sp >= 1) out->fdselect = (long)stack[0]; break;
        default: break;
      }
      sp = 0;
    } else if (b0 == 28) {
      if (p + 3 > pe) return false;
      if (sp < 48) stack[sp++] = rd_i16(p + 1);
      p += 3;
    } else if (b0 == 29) {
      if (p + 5 > pe) return false;
      int32_t v = (p[1] << 24) | (p[2] << 16) | (p[3] << 8) | p[4];
      if (sp < 48) stack[sp++] = v;
      p += 5;
    } else if (b0 == 30) {  // real: skip BCD nibbles
      ++p;
      bool done = false;
      while (p < pe && !done) {
        uint8_t b = *p++;
        if ((b & 0xf0) == 0xf0 || (b & 0x0f) == 0x0f) done = true;
      }
      if (sp < 48) stack[sp++] = 0.0;  // value unused
    } else if (b0 >= 32 && b0 <= 246) {
      if (sp < 48) stack[sp++] = (int)b0 - 139;
      ++p;
    } else if (b0 >= 247 && b0 <= 250) {
      if (p + 2 > pe) return false;
      if (sp < 48) stack[sp++] = (b0 - 247) * 256 + p[1] + 108;
      p += 2;
    } else if (b0 >= 251 && b0 <= 254) {
      if (p + 2 > pe) return false;
      if (sp < 48) stack[sp++] = -((int)(b0 - 251) * 256) - p[1] - 108;
      p += 2;
    } else {
      return false;  // CFF: 22-27, 31 and 255 reserved; CFF2: 26, 27, 31, 255
    }
  }
  return true;
}

inline long subr_bias(long count) {
  return count < 1240 ? 107 : (count < 33900 ? 1131 : 32768);
}

template <class Sink>
struct T2Ctx {
  const CffIndexView* gsubrs;
  const CffIndexView* lsubrs;
  Sink* sink;
  double x = 0.0, y = 0.0;
  double stack[48];
  int sp = 0;
  int n_stems = 0;
  bool width_done = false;
  bool open = false;

  void moveto(double nx, double ny) {
    sink->move_to(nx, ny);
    open = true;
  }
};

// Interpret one Type 2 charstring (recursively through subrs). Returns
// false on malformed/unsupported content. Sets *ended on endchar.
template <class Sink>
bool run_t2(T2Ctx<Sink>& c, const uint8_t* p, const uint8_t* pe, int depth,
            bool* ended) {
  if (depth > 10) return false;
  while (p < pe) {
    uint8_t b0 = *p;
    if (b0 >= 32 || b0 == 28) {
      double v;
      if (b0 == 28) {
        if (p + 3 > pe) return false;
        v = rd_i16(p + 1);
        p += 3;
      } else if (b0 <= 246) {
        v = (int)b0 - 139;
        ++p;
      } else if (b0 <= 250) {
        if (p + 2 > pe) return false;
        v = (b0 - 247) * 256 + p[1] + 108;
        p += 2;
      } else if (b0 <= 254) {
        if (p + 2 > pe) return false;
        v = -((int)(b0 - 251) * 256) - p[1] - 108;
        p += 2;
      } else {  // 255: 16.16 fixed
        if (p + 5 > pe) return false;
        int32_t iv = (p[1] << 24) | (p[2] << 16) | (p[3] << 8) | p[4];
        v = iv / 65536.0;
        p += 5;
      }
      if (c.sp >= 48) return false;
      c.stack[c.sp++] = v;
      continue;
    }
    ++p;
    double* s = c.stack;
    switch (b0) {
      case 1: case 3: case 18: case 23: {  // h/v stem (hm)
        if (!c.width_done && (c.sp & 1)) {
          for (int i = 1; i < c.sp; ++i) s[i - 1] = s[i];
          --c.sp;
        }
        c.width_done = true;
        c.n_stems += c.sp / 2;
        c.sp = 0;
        break;
      }
      case 19: case 20: {  // hintmask / cntrmask
        if (!c.width_done && (c.sp & 1)) --c.sp;  // drop width (any slot ok: stack clears)
        c.width_done = true;
        c.n_stems += c.sp / 2;
        c.sp = 0;
        // Mask bytes = ceil(numHints/8) — fontTools semantics (zero
        // stems -> zero bytes), the pen path our goldens came from.
        long nb = (c.n_stems + 7) / 8;
        if (p + nb > pe) return false;
        p += nb;
        break;
      }
      case 21: {  // rmoveto
        int i = 0;
        if (!c.width_done && c.sp > 2) i = c.sp - 2;
        c.width_done = true;
        if (c.sp - i < 2) return false;
        c.x += s[i];
        c.y += s[i + 1];
        c.moveto(c.x, c.y);
        c.sp = 0;
        break;
      }
      case 22: {  // hmoveto
        int i = 0;
        if (!c.width_done && c.sp > 1) i = c.sp - 1;
        c.width_done = true;
        if (c.sp - i < 1) return false;
        c.x += s[i];
        c.moveto(c.x, c.y);
        c.sp = 0;
        break;
      }
      case 4: {  // vmoveto
        int i = 0;
        if (!c.width_done && c.sp > 1) i = c.sp - 1;
        c.width_done = true;
        if (c.sp - i < 1) return false;
        c.y += s[i];
        c.moveto(c.x, c.y);
        c.sp = 0;
        break;
      }
      case 5: {  // rlineto
        for (int i = 0; i + 2 <= c.sp; i += 2) {
          c.x += s[i];
          c.y += s[i + 1];
          c.sink->line_to(c.x, c.y);
        }
        c.sp = 0;
        break;
      }
      case 6: case 7: {  // hlineto / vlineto
        bool horiz = (b0 == 6);
        for (int i = 0; i < c.sp; ++i) {
          if (horiz) c.x += s[i]; else c.y += s[i];
          c.sink->line_to(c.x, c.y);
          horiz = !horiz;
        }
        c.sp = 0;
        break;
      }
      case 8: {  // rrcurveto
        for (int i = 0; i + 6 <= c.sp; i += 6) {
          double c1x = c.x + s[i], c1y = c.y + s[i + 1];
          double c2x = c1x + s[i + 2], c2y = c1y + s[i + 3];
          c.x = c2x + s[i + 4];
          c.y = c2y + s[i + 5];
          c.sink->cubic_to(c1x, c1y, c2x, c2y, c.x, c.y);
        }
        c.sp = 0;
        break;
      }
      case 24: {  // rcurveline
        int i = 0;
        for (; i + 6 <= c.sp - 2; i += 6) {
          double c1x = c.x + s[i], c1y = c.y + s[i + 1];
          double c2x = c1x + s[i + 2], c2y = c1y + s[i + 3];
          c.x = c2x + s[i + 4];
          c.y = c2y + s[i + 5];
          c.sink->cubic_to(c1x, c1y, c2x, c2y, c.x, c.y);
        }
        if (i + 2 > c.sp) return false;
        c.x += s[i];
        c.y += s[i + 1];
        c.sink->line_to(c.x, c.y);
        c.sp = 0;
        break;
      }
      case 25: {  // rlinecurve
        int i = 0;
        for (; i + 2 <= c.sp - 6; i += 2) {
          c.x += s[i];
          c.y += s[i + 1];
          c.sink->line_to(c.x, c.y);
        }
        if (i + 6 > c.sp) return false;
        double c1x = c.x + s[i], c1y = c.y + s[i + 1];
        double c2x = c1x + s[i + 2], c2y = c1y + s[i + 3];
        c.x = c2x + s[i + 4];
        c.y = c2y + s[i + 5];
        c.sink->cubic_to(c1x, c1y, c2x, c2y, c.x, c.y);
        c.sp = 0;
        break;
      }
      case 26: case 27: {  // vvcurveto / hhcurveto
        bool vv = (b0 == 26);
        int i = 0;
        double d1 = 0.0;
        if (c.sp & 1) {
          d1 = s[0];
          i = 1;
        }
        for (; i + 4 <= c.sp; i += 4) {
          double c1x, c1y;
          if (vv) {
            c1x = c.x + d1;
            c1y = c.y + s[i];
          } else {
            c1x = c.x + s[i];
            c1y = c.y + d1;
          }
          double c2x = c1x + s[i + 1], c2y = c1y + s[i + 2];
          if (vv) {
            c.x = c2x;
            c.y = c2y + s[i + 3];
          } else {
            c.x = c2x + s[i + 3];
            c.y = c2y;
          }
          c.sink->cubic_to(c1x, c1y, c2x, c2y, c.x, c.y);
          d1 = 0.0;
        }
        c.sp = 0;
        break;
      }
      case 30: case 31: {  // vhcurveto / hvcurveto
        bool horiz = (b0 == 31);
        int i = 0;
        while (c.sp - i >= 4) {
          bool last = (c.sp - i == 5);
          double c1x, c1y, c2x, c2y;
          if (horiz) {
            c1x = c.x + s[i];
            c1y = c.y;
            c2x = c1x + s[i + 1];
            c2y = c1y + s[i + 2];
            c.y = c2y + s[i + 3];
            c.x = c2x + (last ? s[i + 4] : 0.0);
          } else {
            c1x = c.x;
            c1y = c.y + s[i];
            c2x = c1x + s[i + 1];
            c2y = c1y + s[i + 2];
            c.x = c2x + s[i + 3];
            c.y = c2y + (last ? s[i + 4] : 0.0);
          }
          c.sink->cubic_to(c1x, c1y, c2x, c2y, c.x, c.y);
          horiz = !horiz;
          i += last ? 5 : 4;
        }
        c.sp = 0;
        break;
      }
      case 10: case 29: {  // callsubr / callgsubr
        const CffIndexView* idx = (b0 == 10) ? c.lsubrs : c.gsubrs;
        if (c.sp < 1 || idx == nullptr) return false;
        long n = (long)c.stack[--c.sp] + subr_bias(idx->count);
        CffSlice sub = idx->get(n);
        if (sub.p == nullptr) return false;
        if (!run_t2(c, sub.p, sub.p + sub.len, depth + 1, ended)) return false;
        if (*ended) return true;
        break;
      }
      case 11:  // return
        return true;
      case 14: {  // endchar
        if (!c.width_done && (c.sp == 1 || c.sp == 5)) {
          for (int i = 1; i < c.sp; ++i) s[i - 1] = s[i];
          --c.sp;
        }
        c.width_done = true;
        if (c.sp >= 4) return false;  // seac accent: fontTools' walk
        *ended = true;
        return true;
      }
      case 12: {  // escape
        if (p >= pe) return false;
        uint8_t b1 = *p++;
        switch (b1) {
          case 35: {  // flex
            if (c.sp < 13) return false;
            double c1x = c.x + s[0], c1y = c.y + s[1];
            double c2x = c1x + s[2], c2y = c1y + s[3];
            double jx = c2x + s[4], jy = c2y + s[5];
            c.sink->cubic_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = jx + s[6], c3y = jy + s[7];
            double c4x = c3x + s[8], c4y = c3y + s[9];
            c.x = c4x + s[10];
            c.y = c4y + s[11];
            c.sink->cubic_to(c3x, c3y, c4x, c4y, c.x, c.y);
            c.sp = 0;
            break;
          }
          case 34: {  // hflex
            if (c.sp < 7) return false;
            double y0 = c.y;
            double c1x = c.x + s[0], c1y = c.y;
            double c2x = c1x + s[1], c2y = c1y + s[2];
            double jx = c2x + s[3], jy = c2y;
            c.sink->cubic_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = jx + s[4], c3y = jy;
            double c4x = c3x + s[5], c4y = y0;
            c.x = c4x + s[6];
            c.y = y0;
            c.sink->cubic_to(c3x, c3y, c4x, c4y, c.x, c.y);
            c.sp = 0;
            break;
          }
          case 36: {  // hflex1
            if (c.sp < 9) return false;
            double y0 = c.y;
            double c1x = c.x + s[0], c1y = c.y + s[1];
            double c2x = c1x + s[2], c2y = c1y + s[3];
            double jx = c2x + s[4], jy = c2y;
            c.sink->cubic_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = jx + s[5], c3y = jy;
            double c4x = c3x + s[6], c4y = c3y + s[7];
            c.x = c4x + s[8];
            c.y = y0;
            c.sink->cubic_to(c3x, c3y, c4x, c4y, c.x, c.y);
            c.sp = 0;
            break;
          }
          case 37: {  // flex1
            if (c.sp < 11) return false;
            double x0 = c.x, y0 = c.y;
            double dx = s[0] + s[2] + s[4] + s[6] + s[8];
            double dy = s[1] + s[3] + s[5] + s[7] + s[9];
            double c1x = c.x + s[0], c1y = c.y + s[1];
            double c2x = c1x + s[2], c2y = c1y + s[3];
            double jx = c2x + s[4], jy = c2y + s[5];
            c.sink->cubic_to(c1x, c1y, c2x, c2y, jx, jy);
            double c3x = jx + s[6], c3y = jy + s[7];
            double c4x = c3x + s[8], c4y = c3y + s[9];
            if (std::fabs(dx) > std::fabs(dy)) {
              c.x = c4x + s[10];
              c.y = y0;
            } else {
              c.x = x0;
              c.y = c4y + s[10];
            }
            c.sink->cubic_to(c3x, c3y, c4x, c4y, c.x, c.y);
            c.sp = 0;
            break;
          }
          default:
            return false;  // arithmetic/storage ops: fontTools' walk
        }
        break;
      }
      default:
        return false;  // reserved
    }
  }
  return true;
}

// The private of one FD (CID-keyed CFF, CFF2) or of the font (name-keyed
// CFF) as fontTools reads it for its T2OutlineExtractor: the local subrs
// (``getattr(private, "Subrs", [])``) and the vsindex of `blend`.
struct CffPrivate {
  CffIndexView subrs;
  bool has_subrs = false;
  bool ok = true;  // false: fontTools raises reading it
  long vsindex = 0;
};

struct CffFont {
  const uint8_t* base;
  long len;
  bool cff2 = false;
  CffIndexView charstrings;
  CffIndexView gsubrs;
  // The native walk's view (CFF only).
  CffIndexView lsubrs;           // non-CID local subrs
  bool has_lsubrs = false;
  bool is_cid = false;
  std::vector<CffIndexView> fd_lsubrs;  // CID: per-FD local subrs
  std::vector<uint8_t> fd_has;
  const uint8_t* fdselect = nullptr;    // raw FDSelect data
  // fontTools' view (both walks in fontTools mode; CFF2).
  std::vector<CffPrivate> privs;  // one a FD; the Top DICT's alone for a name-keyed CFF
  bool has_fdarray = false, has_fdselect = false;
  bool fd_ok = true;              // the FDSelect reads
  std::vector<int32_t> fd_gid;    // FD a glyph id, -1 where fontTools has None
  bool has_vstore = false;
  std::vector<long> region_counts;  // ItemVariationData region counts
  int charset_kind = 2;           // 0: SIDs in `charset`, 1: CID-keyed, 2: not read
  std::vector<uint16_t> charset;  // glyph id -> SID

  int fd_of(long gid) const {
    if (fdselect == nullptr) return -1;
    const uint8_t* p = fdselect;
    const uint8_t* pe = base + len;
    if (p >= pe) return -1;
    uint8_t fmt = p[0];
    if (fmt == 0) {
      if (p + 1 + gid >= pe) return -1;
      return p[1 + gid];
    }
    if (fmt == 3) {
      if (p + 5 > pe) return -1;
      long nr = rd_u16(p + 1);
      const uint8_t* r = p + 3;
      if (r + nr * 3 + 2 > pe) return -1;
      long sentinel = rd_u16(r + nr * 3);
      for (long i = 0; i < nr; ++i) {
        long first = rd_u16(r + i * 3);
        long next = (i + 1 < nr) ? rd_u16(r + (i + 1) * 3) : sentinel;
        if (gid >= first && gid < next) return r[i * 3 + 2];
      }
    }
    return -1;
  }

  // The private fontTools gives a glyph's charstring; -1 where it raises.
  int ft_fd(long gid) const {
    int fd = 0;
    if (has_fdarray && has_fdselect) {
      if (!fd_ok || gid < 0 || gid >= static_cast<long>(fd_gid.size())) return -1;
      fd = fd_gid[gid];
    }
    if (fd < 0 || fd >= static_cast<int>(privs.size()) || !privs[fd].ok) return -1;
    return fd;
  }
};

bool parse_private_subrs(const uint8_t* base, long len, long poff, long psize,
                         CffIndexView* subrs, bool* has) {
  *has = false;
  if (poff < 0 || psize <= 0) return true;  // absent/empty: no subrs
  if (poff + psize > len) return false;
  DictInts pd;
  if (!parse_cff_dict(base + poff, base + poff + psize, &pd)) return false;
  if (pd.subrs >= 0) {
    long so = poff + pd.subrs;
    if (so < 0 || so >= len) return false;
    const uint8_t* next;
    if (!parse_cff_index(base + so, base + len, subrs, &next)) return false;
    *has = true;
  }
  return true;
}

// A Private DICT's operands as fontTools' DictDecompiler consumes them:
// a "number" operator pops the last operand (or, after a blend, every
// operand, keeping the last blended one), a "delta" operator pops them
// all, blend (23) pops its count and n * (regions + 1) operands (exactly
// those left) and pushes n blended values, an operator it does not know
// pops nothing, and operands left at the end fail the DICT ("non-empty
// stack"). Reads Subrs (19; a blended or real offset fails) and vsindex
// (22). `regions`: the VariationStore's region counts (nullptr: none).
bool parse_private_ft(const uint8_t* p, const uint8_t* pe, bool cff2,
                      const std::vector<long>* regions, long* subrs,
                      long* vsindex) {
  struct V { double v; bool is_int, blended; };
  std::vector<V> st;
  *subrs = -1;
  *vsindex = -1;
  auto number = [&](V* out) {
    if (st.empty()) return false;
    if (st.front().blended) {  // arg_blend_number: the last, then popall
      *out = st.back();
      st.clear();
      return true;
    }
    *out = st.back();
    st.pop_back();
    return true;
  };
  while (p < pe) {
    const uint8_t b0 = *p++;
    if (b0 == 28 || b0 == 29) {
      const int w = b0 == 28 ? 2 : 4;
      if (pe - p < w) return false;
      st.push_back({static_cast<double>(w == 2 ? rd_i16(p) : static_cast<int32_t>(rd_u32(p))),
                    true, false});
      p += w;
    } else if (b0 == 30) {  // real: its nibbles, 0xD is no digit of fontTools'
      bool done = false;
      while (!done) {
        if (p >= pe) return false;
        const uint8_t b = *p++;
        for (int nib : {b >> 4, b & 0xF}) {
          if (nib == 0xF) { done = true; break; }
          if (nib == 0xD) return false;
        }
      }
      st.push_back({0.0, false, false});
    } else if (b0 >= 32 && b0 <= 254) {
      double v;
      if (b0 <= 246) {
        v = static_cast<int>(b0) - 139;
      } else {
        if (p >= pe) return false;
        v = b0 <= 250 ? (b0 - 247) * 256 + *p + 108 : -(static_cast<int>(b0) - 251) * 256 - *p - 108;
        ++p;
      }
      st.push_back({v, true, false});
    } else if (b0 == 255) {
      return false;  // reserved
    } else {
      int op = b0;
      if (b0 == 12) {
        if (p >= pe) return false;
        op = 1200 + *p++;
      }
      V v;
      switch (op) {
        case 6: case 7: case 8: case 9: case 1212: case 1213:  // delta
          st.clear();
          break;
        case 10: case 11: case 1209: case 1210: case 1211: case 1217: case 1218:
          if (!number(&v)) return false;
          break;
        case 1214: case 1215: case 1216: case 1219: case 20: case 21:
          if (cff2) break;  // not a CFF2 Private operator: pops nothing
          if (!number(&v)) return false;
          break;
        case 19:
          if (!number(&v)) return false;
          if (v.blended || !v.is_int) return false;
          *subrs = static_cast<long>(v.v);
          break;
        case 22:
          if (!number(&v)) return false;
          if (v.blended || !v.is_int) return false;
          *vsindex = static_cast<long>(v.v);
          break;
        case 23: {  // blend
          long vi = *vsindex < 0 ? 0 : *vsindex;
          if (regions == nullptr) return false;
          const long nr = static_cast<long>(regions->size());
          if (vi < 0) vi += nr;
          if (vi < 0 || vi >= nr || st.empty() || !st.back().is_int) return false;
          const long nb = static_cast<long>(st.back().v);
          st.pop_back();
          if (nb < 0 || static_cast<long>(st.size()) != nb * ((*regions)[vi] + 1)) return false;
          std::vector<V> out(st.begin(), st.begin() + nb);
          for (V& x : out) x.blended = true;
          st = std::move(out);
          break;
        }
        default:
          break;  // an operator fontTools does not know
      }
    }
  }
  return st.empty();
}

// A Private DICT as fontTools reads it (`PrivateDictConverter`): absent
// (no Private operator) or cut short raises; so do operands it cannot
// consume (`parse_private_ft`) and a Subrs INDEX that does not parse.
CffPrivate read_private(const uint8_t* base, long len, long poff, long psize,
                        bool cff2, const std::vector<long>* regions) {
  CffPrivate pr;
  long subrs = -1, vsindex = -1;
  if (poff < 0 || psize < 0 || poff > len || psize > len - poff ||
      !parse_private_ft(base + poff, base + poff + psize, cff2, regions, &subrs, &vsindex)) {
    pr.ok = false;
    return pr;
  }
  if (vsindex >= 0) pr.vsindex = vsindex;
  if (subrs >= 0) {
    const uint8_t* next;
    long so = poff + subrs;
    if (so < 0 || so >= len ||
        !parse_cff_index(base + so, base + len, &pr.subrs, &next, cff2)) {
      pr.ok = false;
      return pr;
    }
    pr.has_subrs = true;
  }
  return pr;
}

// FDSelect formats 0, 3 and 4 as fontTools' `FDSelect` reads them into a
// glyph-id array of `n` entries: format 0 reads what bytes there are;
// formats 3 and 4 fill [first, next first) with each range's FD, leave
// the glyphs before the first range None (-1), and raise where a range
// reaches past `n` or the data ends.
bool read_fdselect(const uint8_t* base, long len, long off, long n,
                   std::vector<int32_t>* out) {
  if (off < 0 || off >= len) return false;
  const uint8_t* p = base + off;
  const uint8_t* pe = base + len;
  const int fmt = *p++;
  if (fmt == 0) {
    const long avail = std::min<long>(n, pe - p);
    out->assign(p, p + avail);
    return true;
  }
  if (fmt != 3 && fmt != 4) return false;
  const bool f4 = fmt == 4;
  const long w = f4 ? 4 : 2, fw = f4 ? 2 : 1;
  out->assign(n, -1);
  if (pe - p < w) return false;
  const long nr = f4 ? static_cast<long>(rd_u32(p)) : rd_u16(p);
  p += w;
  long prev = -1;
  int32_t fd = -1;
  for (long i = 0; i <= nr; ++i) {
    if (i == nr && prev < 0) break;  // no ranges: no sentinel read
    if (pe - p < w) return false;
    const long first = f4 ? static_cast<long>(rd_u32(p)) : rd_u16(p);
    p += w;
    if (prev >= 0) {
      for (long g = prev; g < first; ++g) {
        if (g >= n) return false;
        (*out)[g] = fd;
      }
    }
    if (i == nr) break;
    prev = first;
    if (pe - p < fw) return false;
    fd = f4 ? rd_u16(p) : *p;
    p += fw;
  }
  return true;
}

// A CFF2 ItemVariationStore (behind its u16 length): the region count of
// each ItemVariationData, which `blend` and `vsindex` read.
bool read_vstore(const uint8_t* base, long len, long off,
                 std::vector<long>* counts) {
  if (off < 0 || off > len - 10) return false;
  const uint8_t* s = base + off + 2;
  const long slen = len - off - 2;
  if (rd_u16(s) != 1) return false;
  const long n = rd_u16(s + 6);
  if (8 + 4 * n > slen) return false;
  for (long i = 0; i < n; ++i) {
    const long vo = rd_u32(s + 8 + 4 * i);
    if (vo > slen - 6) return false;
    counts->push_back(rd_u16(s + vo + 4));
  }
  return true;
}

// The charset of a name-keyed CFF (glyph id -> SID): ISOAdobe (offset 0,
// SID = glyph id), or formats 0, 1 and 2; the Expert charsets (offsets 1
// and 2) and a charset cut short are left unread.
void read_charset(const uint8_t* base, long len, long off, long n,
                  CffFont* f) {
  f->charset_kind = 2;
  if (off == 1 || off == 2 || n < 1) return;
  std::vector<uint16_t> cs(1, 0);
  if (off == 0) {
    for (long g = 1; g < n && g < 229; ++g) cs.push_back(static_cast<uint16_t>(g));
  } else {
    if (off < 0 || off >= len) return;
    const uint8_t* p = base + off;
    const uint8_t* pe = base + len;
    const int fmt = *p++;
    if (fmt == 0) {
      if ((pe - p) / 2 < n - 1) return;
      for (long g = 1; g < n; ++g, p += 2) cs.push_back(rd_u16(p));
    } else if (fmt == 1 || fmt == 2) {
      while (static_cast<long>(cs.size()) < n) {
        if (pe - p < (fmt == 1 ? 3 : 4)) return;
        const long first = rd_u16(p);
        const long left = fmt == 1 ? p[2] : rd_u16(p + 2);
        p += fmt == 1 ? 3 : 4;
        for (long k = 0; k <= left && static_cast<long>(cs.size()) < n; ++k)
          cs.push_back(static_cast<uint16_t>(first + k));
      }
    } else {
      return;
    }
  }
  f->charset = std::move(cs);
  f->charset_kind = 0;
}

bool parse_cff_font(const uint8_t* cff, long len, CffFont* out) {
  out->base = cff;
  out->len = len;
  if (len < 4) return false;
  int hdr = cff[2];
  if (cff[0] != 1) return false;
  const uint8_t* p = cff + hdr;
  const uint8_t* pe = cff + len;
  CffIndexView names, topdicts, strings;
  if (!parse_cff_index(p, pe, &names, &p)) return false;
  if (!parse_cff_index(p, pe, &topdicts, &p)) return false;
  if (!parse_cff_index(p, pe, &strings, &p)) return false;
  if (!parse_cff_index(p, pe, &out->gsubrs, &p)) return false;
  CffSlice td = topdicts.get(0);
  if (td.p == nullptr) return false;
  DictInts top;
  if (!parse_cff_dict(td.p, td.p + td.len, &top)) return false;
  if (top.charstrings < 0 || top.charstrings >= len) return false;
  const uint8_t* next;
  if (!parse_cff_index(cff + top.charstrings, pe, &out->charstrings, &next))
    return false;
  const long n = out->charstrings.count;
  out->is_cid = top.is_cid;
  if (top.is_cid) {
    if (top.fdarray < 0 || top.fdselect < 0) return false;
    CffIndexView fda;
    if (!parse_cff_index(cff + top.fdarray, pe, &fda, &next)) return false;
    out->fd_lsubrs.resize(fda.count);
    out->fd_has.resize(fda.count, 0);
    for (long i = 0; i < fda.count; ++i) {
      CffSlice fd = fda.get(i);
      if (fd.p == nullptr) return false;
      DictInts fdd;
      if (!parse_cff_dict(fd.p, fd.p + fd.len, &fdd)) return false;
      bool has = false;
      if (!parse_private_subrs(cff, len, fdd.private_off, fdd.private_size,
                               &out->fd_lsubrs[i], &has))
        return false;
      out->fd_has[i] = has;
      out->privs.push_back(
          read_private(cff, len, fdd.private_off, fdd.private_size, false, nullptr));
    }
    out->fdselect = cff + top.fdselect;
    out->has_fdarray = out->has_fdselect = true;
    out->fd_ok = read_fdselect(cff, len, top.fdselect, n, &out->fd_gid);
    out->charset_kind = 1;
  } else {
    if (!parse_private_subrs(cff, len, top.private_off, top.private_size,
                             &out->lsubrs, &out->has_lsubrs))
      return false;
    out->privs.push_back(
        read_private(cff, len, top.private_off, top.private_size, false, nullptr));
    read_charset(cff, len, top.charset, n, out);
  }
  return true;
}

// A CFF2 table: the 5-byte header with the Top DICT's length, the Top
// DICT itself (no Name and no String INDEX), INDEXes of 32-bit counts,
// the mandatory FDArray, the optional FDSelect (all glyphs FD 0 without
// one) and the VariationStore whose region counts `blend` reads.
bool parse_cff2_font(const uint8_t* cff, long len, CffFont* out) {
  out->base = cff;
  out->len = len;
  out->cff2 = true;
  if (len < 5 || cff[0] != 2) return false;
  const long hdr = cff[2], tdl = rd_u16(cff + 3);
  if (hdr < 5 || hdr + tdl > len) return false;
  DictInts top;
  if (!parse_cff_dict(cff + hdr, cff + hdr + tdl, &top, true)) return false;
  const uint8_t* pe = cff + len;
  const uint8_t* next;
  if (!parse_cff_index(cff + hdr + tdl, pe, &out->gsubrs, &next, true)) return false;
  if (top.charstrings < 0 || top.charstrings >= len || top.fdarray < 0 ||
      top.fdarray >= len)
    return false;
  if (!parse_cff_index(cff + top.charstrings, pe, &out->charstrings, &next, true))
    return false;
  if (top.vstore >= 0) {
    if (!read_vstore(cff, len, top.vstore, &out->region_counts)) return false;
    out->has_vstore = true;
  }
  CffIndexView fda;
  if (!parse_cff_index(cff + top.fdarray, pe, &fda, &next, true)) return false;
  for (long i = 0; i < fda.count; ++i) {
    CffSlice fd = fda.get(i);
    if (fd.p == nullptr) return false;
    DictInts fdd;
    if (!parse_cff_dict(fd.p, fd.p + fd.len, &fdd, true)) return false;
    out->privs.push_back(read_private(cff, len, fdd.private_off, fdd.private_size, true,
                                      out->has_vstore ? &out->region_counts : nullptr));
  }
  out->has_fdarray = true;
  if (top.fdselect >= 0) {
    out->has_fdselect = true;
    out->fd_ok = read_fdselect(cff, len, top.fdselect,
                               out->charstrings.count, &out->fd_gid);
  }
  return true;
}

// The CFF spec's StandardEncoding (Appendix B) as SIDs: the names
// fontTools' `op_endchar` looks up for a seac's base and accent.
constexpr uint16_t kStdEncSid[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80,
    81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110,
    0, 111, 112, 113, 114, 0, 115, 116, 117, 118, 119, 120, 121, 122, 0, 123,
    0, 124, 125, 126, 127, 128, 129, 130, 131, 0, 132, 133, 0, 134, 135, 136,
    137, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 138, 0, 139, 0, 0, 0, 0, 140, 141, 142, 143, 0, 0, 0, 0,
    0, 144, 0, 0, 0, 145, 0, 0, 146, 147, 148, 149, 0, 0, 0, 0,
};

// The glyph a seac component names (StandardEncoding[code]): SID 0 is
// .notdef, glyph 0; otherwise the first glyph of that SID in the charset.
// -1 where the font has no such glyph: fontTools skips the component.
long seac_gid(const CffFont& f, long code) {
  const long sid = kStdEncSid[code];
  if (sid == 0) return 0;
  if (f.charset_kind != 0) return -1;
  for (size_t g = 1; g < f.charset.size(); ++g)
    if (f.charset[g] == sid) return static_cast<long>(g);
  return -1;
}

// ---------------------------------------------------------------------------
// A Type 2 / CFF2 charstring as fontTools 4.61.1 draws it
// (`psCharStrings.T2OutlineExtractor` under a BasePen, no location), for
// every glyph the native walk (`run_t2`) gives up on, for every CFF2
// glyph, and for the segments of every CFF glyph (`vg_cff_curves`, which
// the JAX package draws through fontTools' pen). Python's semantics to
// the letter: the operand stack is unbounded and tracks which operands
// are integers; the width is taken by `popallWidth` (a CFF2 charstring
// has none: an odd count raises); a drawing operator before any moveto
// moves to the current point first; `endchar` and `return` do not stop
// the program, which runs to the end of its bytes; an operator fontTools
// does not know ends the charstring (its tokenizer returns None); the
// second and later hintmasks read the first one's byte count and leave
// the stack alone; `blend` keeps the n defaults and deletes the last
// n*k operands as a Python slice does; `vsindex` and `blend` read the
// VariationStore (raising without one); `div` divides as Python does;
// flex ops and curves take exactly the operand counts fontTools unpacks;
// a subr index wraps as a Python list index; seac draws StandardEncoding's
// base glyph and then the accent through fontTools' TransformPen
// composition. Every place where fontTools raises returns false (the
// glyph's -1).
// ---------------------------------------------------------------------------

constexpr int kFtMaxDepth = 256;  // nested executions; fontTools: Python's recursion limit
// Tokens a glyph may execute (subrs included) and operands it may hold
// before it fails: bounds on a program that loops through subrs, where
// fontTools would run for minutes or exhaust memory.
constexpr long kFtMaxTokens = 1L << 24;
constexpr size_t kFtMaxStack = 1u << 20;

template <class Sink>
struct FtGlyph {
  const CffFont* font;
  const CffPrivate* priv;
  Sink* sink;
  bool xf;          // a seac component's transform is in force
  double dx, dy;    // its translation (fontTools' composed Transform)
  int* depth;
  std::vector<double> st;
  std::vector<uint8_t> si;  // operand is a Python int
  double x = 0.0, y = 0.0;
  bool saw_move = false, got_width = false;
  long hint_count = 0, mask_bytes = 0, num_regions = 0;
  int level = 0;

  long budget = kFtMaxTokens;  // tokens left for the glyph and its subrs

  void push(double v, bool is_int) {
    st.push_back(v);
    si.push_back(is_int);
  }
  void pop_all(std::vector<double>* a, std::vector<uint8_t>* ai) {
    a->swap(st);
    ai->swap(si);
    st.clear();
    si.clear();
  }
  // T2WidthExtractor.popallWidth.
  bool pop_all_width(int even_odd, std::vector<double>* a,
                     std::vector<uint8_t>* ai) {
    pop_all(a, ai);
    if (!got_width) {
      if (even_odd ^ static_cast<int>(a->size() % 2)) {
        // CFF2's defaultWidthX is None (an assert fails); no operand to take
        // is an IndexError.
        if (font->cff2 || a->empty()) return false;
        a->erase(a->begin());
        ai->erase(ai->begin());
      }
      got_width = true;
    }
    return true;
  }
  void out(double px, double py, double* ox, double* oy) const {
    if (xf) {
      *ox = 1.0 * px + 0.0 * py + dx;
      *oy = 0.0 * px + 1.0 * py + dy;
    } else {
      *ox = px;
      *oy = py;
    }
  }
  void r_move_to(double ddx, double ddy) {
    x = x + ddx;
    y = y + ddy;
    double ox, oy;
    out(x, y, &ox, &oy);
    sink->move_to(ox, oy);
    saw_move = true;
  }
  void r_line_to(double ddx, double ddy) {
    if (!saw_move) r_move_to(0.0, 0.0);
    x = x + ddx;
    y = y + ddy;
    double ox, oy;
    out(x, y, &ox, &oy);
    sink->line_to(ox, oy);
  }
  void r_curve_to(double ax, double ay, double bx, double by, double cx,
                  double cy) {
    if (!saw_move) r_move_to(0.0, 0.0);
    double p[6];
    x = x + ax;
    y = y + ay;
    out(x, y, &p[0], &p[1]);
    x = x + bx;
    y = y + by;
    out(x, y, &p[2], &p[3]);
    x = x + cx;
    y = y + cy;
    out(x, y, &p[4], &p[5]);
    sink->cubic_to(p[0], p[1], p[2], p[3], p[4], p[5]);
  }
  void end_path() {
    if (saw_move) sink->close_path();
    saw_move = false;
  }
  // private.getNumRegions(vi): VarData[vi] of the VariationStore.
  bool regions(long vi, long* out_n) const {
    if (!font->has_vstore) return false;
    const long n = static_cast<long>(font->region_counts.size());
    if (vi < 0) vi += n;
    if (vi < 0 || vi >= n) return false;
    *out_n = font->region_counts[vi];
    return true;
  }
};

template <class Sink>
bool ft_draw_glyph(const CffFont& f, long gid, Sink& sink, bool xf, double dx,
                   double dy, int* depth);

// Python's float floor division (float_floor_div).
inline double py_floordiv(double vx, double wx) {
  double mod = std::fmod(vx, wx);
  double div = (vx - mod) / wx;
  if (mod != 0.0) {
    if ((wx < 0) != (mod < 0)) div -= 1.0;
  }
  double fl;
  if (div != 0.0) {
    fl = std::floor(div);
    if (div - fl > 0.5) fl += 1.0;
  } else {
    fl = std::copysign(0.0, vx / wx);
  }
  return fl;
}

template <class Sink>
bool ft_exec(FtGlyph<Sink>& g, const uint8_t* p, const uint8_t* pe);

template <class Sink>
bool ft_loop(FtGlyph<Sink>& g, const uint8_t* p, const uint8_t* pe) {
  std::vector<double> a;
  std::vector<uint8_t> ai;
  while (p < pe) {
    if (--g.budget < 0 || g.st.size() > kFtMaxStack) return false;
    const uint8_t b0 = *p++;
    if (b0 == 28) {
      if (pe - p < 2) return false;
      g.push(rd_i16(p), true);
      p += 2;
      continue;
    }
    if (b0 >= 32) {
      if (b0 <= 246) {
        g.push(static_cast<int>(b0) - 139, true);
      } else if (b0 <= 250) {
        if (p >= pe) return false;
        g.push((b0 - 247) * 256 + *p++ + 108, true);
      } else if (b0 <= 254) {
        if (p >= pe) return false;
        g.push(-(static_cast<int>(b0) - 251) * 256 - *p++ - 108, true);
      } else {
        if (pe - p < 4) return false;
        const int32_t iv = static_cast<int32_t>(rd_u32(p));
        g.push(iv / 65536.0, false);
        p += 4;
      }
      continue;
    }
    int op = b0;
    if (b0 == 12) {
      if (p >= pe) return false;
      op = 1200 + *p++;
    }
    switch (op) {
      case 1: case 3: case 18: case 23:  // stems: countHints
        if (!g.pop_all_width(0, &a, &ai)) return false;
        g.hint_count += static_cast<long>(a.size()) / 2;
        break;
      case 19: case 20: {  // hintmask / cntrmask
        if (g.mask_bytes == 0) {
          if (!g.pop_all_width(0, &a, &ai)) return false;
          g.hint_count += static_cast<long>(a.size()) / 2;
          g.mask_bytes = (g.hint_count + 7) / 8;
        }
        if (pe - p < g.mask_bytes) return false;
        p += g.mask_bytes;
        break;
      }
      case 21:  // rmoveto
        g.end_path();
        if (!g.pop_all_width(0, &a, &ai) || a.size() < 2) return false;
        g.r_move_to(a[0], a[1]);
        break;
      case 22: case 4:  // hmoveto / vmoveto
        g.end_path();
        if (!g.pop_all_width(1, &a, &ai) || a.empty()) return false;
        if (op == 22) g.r_move_to(a[0], 0.0); else g.r_move_to(0.0, a[0]);
        break;
      case 14: {  // endchar (seac with four operands); the program goes on
        g.end_path();
        if (!g.pop_all_width(0, &a, &ai)) return false;
        if (a.empty()) break;
        if (a.size() != 4 || g.font->cff2 || !ai[2] || !ai[3]) return false;
        long codes[2] = {static_cast<long>(a[2]), static_cast<long>(a[3])};
        for (long& c : codes) {
          if (c < 0) c += 256;  // StandardEncoding[c]: a Python list index
          if (c < 0 || c > 255) return false;
        }
        // The base at the transform in force, then the accent moved by
        // (adx, ady) composed onto it (TransformPen.addComponent).
        const long base = seac_gid(*g.font, codes[0]);
        if (base >= 0 &&
            !ft_draw_glyph(*g.font, base, *g.sink, g.xf, g.dx, g.dy, g.depth))
          return false;
        double ndx = a[0], ndy = a[1];
        if (g.xf) {
          ndx = 1.0 * a[0] + 0.0 * a[1] + g.dx;
          ndy = 0.0 * a[0] + 1.0 * a[1] + g.dy;
        }
        const long accent = seac_gid(*g.font, codes[1]);
        if (accent >= 0 &&
            !ft_draw_glyph(*g.font, accent, *g.sink, !(ndx == 0.0 && ndy == 0.0),
                           ndx, ndy, g.depth))
          return false;
        break;
      }
      case 5: {  // rlineto
        g.pop_all(&a, &ai);
        for (size_t i = 0; i < a.size(); i += 2) {
          if (i + 2 > a.size()) return false;
          g.r_line_to(a[i], a[i + 1]);
        }
        break;
      }
      case 6: case 7: {  // hlineto / vlineto
        g.pop_all(&a, &ai);
        bool horiz = op == 6;
        for (double v : a) {
          if (horiz) g.r_line_to(v, 0.0); else g.r_line_to(0.0, v);
          horiz = !horiz;
        }
        break;
      }
      case 8: {  // rrcurveto
        g.pop_all(&a, &ai);
        for (size_t i = 0; i < a.size(); i += 6) {
          if (i + 6 > a.size()) return false;
          g.r_curve_to(a[i], a[i + 1], a[i + 2], a[i + 3], a[i + 4], a[i + 5]);
        }
        break;
      }
      case 24: {  // rcurveline
        g.pop_all(&a, &ai);
        const long n = static_cast<long>(a.size());
        for (long i = 0; i < n - 2; i += 6) {
          if (i + 6 > n) return false;
          g.r_curve_to(a[i], a[i + 1], a[i + 2], a[i + 3], a[i + 4], a[i + 5]);
        }
        if (n < 2) return false;
        g.r_line_to(a[n - 2], a[n - 1]);
        break;
      }
      case 25: {  // rlinecurve
        g.pop_all(&a, &ai);
        const long n = static_cast<long>(a.size());
        const long nl = n > 6 ? n - 6 : 0;
        for (long i = 0; i < nl; i += 2) {
          if (i + 2 > nl) return false;
          g.r_line_to(a[i], a[i + 1]);
        }
        if (n < 6) return false;
        g.r_curve_to(a[n - 6], a[n - 5], a[n - 4], a[n - 3], a[n - 2], a[n - 1]);
        break;
      }
      case 26: case 27: {  // vvcurveto / hhcurveto
        g.pop_all(&a, &ai);
        size_t i = 0;
        double d1 = 0.0;
        if (a.size() % 2) {
          d1 = a[0];
          i = 1;
        }
        for (; i < a.size(); i += 4) {
          if (i + 4 > a.size()) return false;
          if (op == 26)
            g.r_curve_to(d1, a[i], a[i + 1], a[i + 2], 0.0, a[i + 3]);
          else
            g.r_curve_to(a[i], d1, a[i + 1], a[i + 2], a[i + 3], 0.0);
          d1 = 0.0;
        }
        break;
      }
      case 30: case 31: {  // vhcurveto / hvcurveto
        g.pop_all(&a, &ai);
        bool horiz = op == 31;
        size_t i = 0;
        while (i < a.size()) {
          if (a.size() - i < 4) return false;
          const bool last = a.size() - i == 5;
          const double e = last ? a[i + 4] : 0.0;
          if (horiz)
            g.r_curve_to(a[i], 0.0, a[i + 1], a[i + 2], e, a[i + 3]);
          else
            g.r_curve_to(0.0, a[i], a[i + 1], a[i + 2], a[i + 3], e);
          i += last ? 5 : 4;
          horiz = !horiz;
        }
        break;
      }
      case 10: case 29: {  // callsubr / callgsubr
        if (g.st.empty() || !g.si.back()) return false;
        const long v = static_cast<long>(g.st.back());
        g.st.pop_back();
        g.si.pop_back();
        const CffIndexView* idx = op == 29 ? &g.font->gsubrs
                                           : (g.priv->has_subrs ? &g.priv->subrs : nullptr);
        const long count = idx ? idx->count : 0;
        long i = v + subr_bias(count);
        if (i < 0) i += count;
        if (i < 0 || i >= count) return false;
        CffSlice sub = idx->get(i);
        if (sub.p == nullptr) return false;
        if (!ft_exec(g, sub.p, sub.p + sub.len)) return false;
        break;
      }
      case 11: case 1200:  // return; dotsection (ignore): nothing
        break;
      case 15: {  // vsindex
        if (g.st.empty() || !g.si.back()) return false;
        const long vi = static_cast<long>(g.st.back());
        g.st.pop_back();
        g.si.pop_back();
        if (!g.regions(vi, &g.num_regions)) return false;
        break;
      }
      case 16: {  // blend, at the default instance
        if (g.num_regions == 0 && !g.regions(g.priv->vsindex, &g.num_regions))
          return false;
        if (g.st.empty() || !g.si.back()) return false;
        const long nb = static_cast<long>(g.st.back());
        g.st.pop_back();
        g.si.pop_back();
        // del stack[-(nb * k):] with Python's slice bounds.
        const long L = static_cast<long>(g.st.size());
        long s = -(nb * g.num_regions);
        if (s < 0) {
          s += L;
          if (s < 0) s = 0;
        } else if (s > L) {
          s = L;
        }
        g.st.resize(s);
        g.si.resize(s);
        break;
      }
      case 1212: {  // div
        if (g.st.size() < 2) return false;
        const double n2 = g.st.back(), n1 = g.st[g.st.size() - 2];
        const bool ints = g.si.back() && g.si[g.si.size() - 2];
        g.st.resize(g.st.size() - 2);
        g.si.resize(g.si.size() - 2);
        if (n2 == 0.0) return false;  // ZeroDivisionError
        const double d2 = n1 / n2;
        double d1;
        if (ints) {
          const long long q = static_cast<long long>(n1), r = static_cast<long long>(n2);
          long long fl = q / r;
          if ((q % r != 0) && ((q < 0) != (r < 0))) --fl;
          d1 = static_cast<double>(fl);
        } else {
          d1 = py_floordiv(n1, n2);
        }
        if (d1 == d2) g.push(d1, ints); else g.push(d2, false);
        break;
      }
      case 1234: {  // hflex
        g.pop_all(&a, &ai);
        if (a.size() != 7) return false;
        g.r_curve_to(a[0], 0.0, a[1], a[2], a[3], 0.0);
        g.r_curve_to(a[4], 0.0, a[5], -a[2], a[6], 0.0);
        break;
      }
      case 1235: {  // flex
        g.pop_all(&a, &ai);
        if (a.size() != 13) return false;
        g.r_curve_to(a[0], a[1], a[2], a[3], a[4], a[5]);
        g.r_curve_to(a[6], a[7], a[8], a[9], a[10], a[11]);
        break;
      }
      case 1236: {  // hflex1
        g.pop_all(&a, &ai);
        if (a.size() != 9) return false;
        const double dy6 = -((((a[1] + a[3]) + 0.0) + 0.0) + a[7]);
        g.r_curve_to(a[0], a[1], a[2], a[3], a[4], 0.0);
        g.r_curve_to(a[5], 0.0, a[6], a[7], a[8], dy6);
        break;
      }
      case 1237: {  // flex1
        g.pop_all(&a, &ai);
        if (a.size() != 11) return false;
        const double sx = (((a[0] + a[2]) + a[4]) + a[6]) + a[8];
        const double sy = (((a[1] + a[3]) + a[5]) + a[7]) + a[9];
        double dx6, dy6;
        if (std::fabs(sx) > std::fabs(sy)) {
          dx6 = a[10];
          dy6 = -sy;
        } else {
          dx6 = -sx;
          dy6 = a[10];
        }
        g.r_curve_to(a[0], a[1], a[2], a[3], a[4], a[5]);
        g.r_curve_to(a[6], a[7], a[8], a[9], dx6, dy6);
        break;
      }
      case 1203: case 1204: case 1205: case 1208: case 1209: case 1210:
      case 1211: case 1213: case 1214: case 1215: case 1218: case 1220:
      case 1221: case 1222: case 1223: case 1224: case 1226: case 1227:
      case 1228: case 1229: case 1230:
        return false;  // arithmetic and storage: NotImplementedError
      default:
        return true;  // an operator fontTools does not know ends the charstring
    }
  }
  return true;
}

// T2OutlineExtractor.execute: one more level; the path ends at level 0.
template <class Sink>
bool ft_exec(FtGlyph<Sink>& g, const uint8_t* p, const uint8_t* pe) {
  if (*g.depth >= kFtMaxDepth) return false;
  ++*g.depth;
  ++g.level;
  const bool ok = ft_loop(g, p, pe);
  --g.level;
  --*g.depth;
  if (!ok) return false;
  if (g.level == 0) g.end_path();
  return true;
}

template <class Sink>
bool ft_draw_glyph(const CffFont& f, long gid, Sink& sink, bool xf, double dx,
                   double dy, int* depth) {
  CffSlice cs = f.charstrings.get(gid);
  if (cs.p == nullptr) return false;
  const int fd = f.ft_fd(gid);
  if (fd < 0) return false;
  FtGlyph<Sink> g;
  g.font = &f;
  g.priv = &f.privs[fd];
  g.sink = &sink;
  g.xf = xf;
  g.dx = dx;
  g.dy = dy;
  g.depth = depth;
  return ft_exec(g, cs.p, cs.p + cs.len);
}

// The native walk of one CFF glyph (the JAX package's own walker: false
// where it gives up).
template <class Sink>
bool native_cff_glyph(const CffFont& font, long gid, Sink& sink) {
  CffSlice cs = font.charstrings.get(gid);
  if (cs.p == nullptr) return false;
  T2Ctx<Sink> ctx;
  ctx.gsubrs = &font.gsubrs;
  if (font.is_cid) {
    int fd = font.fd_of(gid);
    if (fd < 0 || fd >= (int)font.fd_lsubrs.size()) return false;
    ctx.lsubrs = font.fd_has[fd] ? &font.fd_lsubrs[fd] : nullptr;
  } else {
    ctx.lsubrs = font.has_lsubrs ? &font.lsubrs : nullptr;
  }
  ctx.sink = &sink;
  bool ended = false;
  return run_t2(ctx, cs.p, cs.p + cs.len, 0, &ended) && !sink.bad;
}

bool parse_any_cff(const uint8_t* cff, long len, CffFont* font) {
  return len >= 1 && cff[0] == 2 ? parse_cff2_font(cff, len, font)
                                 : parse_cff_font(cff, len, font);
}

}  // namespace

extern "C" {

// CFF twin of vg_glyf_rings: same output contract (glyph_nrings[i] = -1
// where fontTools raises too), input = the raw 'CFF ' or 'CFF2' table
// bytes. A CFF glyph takes the native walk, and the fontTools-mode walk
// where that gives up; a CFF2 glyph takes the fontTools-mode walk (the
// JAX package draws every CFF2 glyph through fontTools). `ft` = 0: the
// font has no glyph set in fontTools (no readable hmtx), where every
// glyph of the fontTools-mode walk fails.
long vg_cff_rings(const uint8_t* cff, long cff_len, long ft,
                  const uint32_t* gids, long n_gids, double tol_sq, double* pts, long pts_cap,
                  int32_t* ring_lens, long rings_cap, int32_t* glyph_nrings,
                  int64_t* out_counts) {
  CffFont font;
  bool font_ok = parse_any_cff(cff, cff_len, &font);

  // Two-phase like vg_glyf_rings: parallel interpret (the parsed
  // CffFont is read-only in workers), then an ordered concatenation.
  struct GlyphOut {
    std::vector<double> pts;
    std::vector<int32_t> ring_lens;
    bool ok = false;
  };
  std::vector<GlyphOut> outs(n_gids);
  std::atomic<long> next{0};
  auto worker = [&]() {
    CubicSink sink;
    sink.tol_sq = tol_sq;
    auto reset = [&]() {
      sink.pts.clear();
      sink.ring_lens.clear();
      sink.cur.clear();
      sink.bad = false;
    };
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_gids) return;
      if (!font_ok) continue;
      reset();
      bool ok = !font.cff2 && native_cff_glyph(font, gids[i], sink);
      if (!ok && ft) {
        reset();
        int depth = 0;
        ok = ft_draw_glyph(font, gids[i], sink, false, 0.0, 0.0, &depth);
      }
      if (!ok) continue;
      sink.save_ring();
      outs[i].pts = std::move(sink.pts);
      outs[i].ring_lens = std::move(sink.ring_lens);
      outs[i].ok = true;
    }
  };
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads > 8) n_threads = 8;
  if (n_gids < 256 || n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  long npts = 0, nrings = 0;
  bool overflow = false;
  for (long i = 0; i < n_gids; ++i) {
    if (!outs[i].ok) {
      glyph_nrings[i] = -1;
      continue;
    }
    long gp = static_cast<long>(outs[i].pts.size() / 2);
    long gr = static_cast<long>(outs[i].ring_lens.size());
    if (!overflow && npts + gp <= pts_cap && nrings + gr <= rings_cap) {
      std::memcpy(pts + 2 * npts, outs[i].pts.data(),
                  outs[i].pts.size() * sizeof(double));
      std::memcpy(ring_lens + nrings, outs[i].ring_lens.data(),
                  gr * sizeof(int32_t));
    } else {
      overflow = true;
    }
    glyph_nrings[i] = static_cast<int32_t>(gr);
    npts += gp;
    nrings += gr;
  }
  out_counts[0] = npts;
  out_counts[1] = nrings;
  return overflow ? 1 : 0;
}

// The number of charstrings of a 'CFF ' or 'CFF2' table (its glyph
// count), -1 where the table does not parse.
long vg_cff_glyph_count(const uint8_t* cff, long cff_len) {
  CffFont font;
  if (!parse_any_cff(cff, cff_len, &font)) return -1;
  return font.charstrings.count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// vg_prep_cores: the whole-font glyph-prep numeric pass.
//
// One sweep over the flat ring arrays (the vg_glyf_rings/vg_cff_rings
// output) computing everything render/metrics.build_cores needs:
// per-glyph metrics (advance, dx, bbox, empty — exact f64, same op
// order as renderer.rs:103-149 / the numpy path), the transformed
// pixel-space points, and the device transport caches (q16 chain,
// lane-validity bits, i8-delta runs + anchor tables). Replaces ~10
// allocating numpy passes (~38 ms/font on a busy host) with one
// memory-speed pass; the Python side keeps only the per-name core
// objects. Semantics notes:
//  - chain16 uses nearbyint (round-half-even) to match np.rint;
//  - every glyph's lane 0 ships delta 0 and is NOT in the anchor
//    table (pack anchors it with the group-dependent jump);
//  - anchor capacity N+1 can never overflow (≤1 anchor per lane).
// ---------------------------------------------------------------------------

extern "C" {

long vg_prep_cores(
    const double* pts, long N,            // [N,2] font-unit points
    const int32_t* ring_lens, long R,     // points per ring
    const int32_t* glyph_nrings, long n,  // rings per glyph; -1 unsupported
    const double* advances, double upem,  // [n]
    int64_t* adv, double* dxs, uint8_t* empty_out,
    int32_t* bbox,                        // [n,4] x0,y0,x1,y1
    int64_t* npts_out, int64_t* postarts, // [n], [n]
    double* xy,                           // [N,2] pixel-space points
    int16_t* chain16,                     // [2,N] rows x,y
    uint8_t* valid8,                      // [N]
    int8_t* d8,                           // [2,N]
    int32_t* anc_local,                   // [N+1]
    int32_t* anc_jumps,                   // [2, N+1]
    int64_t* anc_starts                   // [n+1]
) {
  const double scale = 24.0 / upem;
  long ring_i = 0;
  long pos = 0;
  long n_anc = 0;
  anc_starts[0] = 0;
  for (long g = 0; g < n; ++g) {
    const int32_t nr = glyph_nrings[g];
    const double af = advances[g] * scale * 0.95;
    const double a =
        af >= 0.0 ? std::floor(af + 0.5) : std::ceil(af - 0.5);
    adv[g] = static_cast<int64_t>(a);
    const double dx = (a - af) / 2.0;
    dxs[g] = dx;
    postarts[g] = pos;
    long k = 0;
    if (nr > 0) {
      for (long r = ring_i; r < ring_i + nr && r < R; ++r) k += ring_lens[r];
    }
    npts_out[g] = k;
    if (pos + k > N) return -1;  // inconsistent ring/glyph tables
    if (nr <= 0 || k == 0) {
      empty_out[g] = 1;
      // Same values as the numpy fallback's zero-default min/max path
      // (render/metrics.py build_cores: floor(0)-BUFFER .. ceil(0)+
      // BUFFER) so the two build_cores paths are bit-identical even
      // for empty glyphs, whose consumers zero the metrics anyway.
      bbox[4 * g + 0] = bbox[4 * g + 1] = -3;
      bbox[4 * g + 2] = bbox[4 * g + 3] = 3;
      anc_starts[g + 1] = n_anc;
      if (nr > 0) ring_i += nr;
      continue;
    }
    double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
    int32_t prev_qx = 0, prev_qy = 0;
    for (long i = 0; i < k; ++i) {
      const double x = pts[2 * (pos + i)] * scale + dx;
      const double y = pts[2 * (pos + i) + 1] * scale;
      xy[2 * (pos + i)] = x;
      xy[2 * (pos + i) + 1] = y;
      if (x < minx) minx = x;
      if (x > maxx) maxx = x;
      if (y < miny) miny = y;
      if (y > maxy) maxy = y;
      const int32_t qx = static_cast<int32_t>(std::nearbyint(x * 256.0));
      const int32_t qy = static_cast<int32_t>(std::nearbyint(y * 256.0));
      chain16[pos + i] = static_cast<int16_t>(qx);
      chain16[N + pos + i] = static_cast<int16_t>(qy);
      valid8[pos + i] = 1;
      if (i == 0) {
        d8[pos + i] = 0;
        d8[N + pos + i] = 0;
      } else {
        const int32_t ddx = qx - prev_qx;
        const int32_t ddy = qy - prev_qy;
        if (ddx > 127 || ddx < -127 || ddy > 127 || ddy < -127) {
          d8[pos + i] = 0;
          d8[N + pos + i] = 0;
          anc_local[n_anc] = static_cast<int32_t>(i);
          anc_jumps[n_anc] = ddx;
          anc_jumps[(N + 1) + n_anc] = ddy;
          ++n_anc;
        } else {
          d8[pos + i] = static_cast<int8_t>(ddx);
          d8[N + pos + i] = static_cast<int8_t>(ddy);
        }
      }
      prev_qx = qx;
      prev_qy = qy;
    }
    // Ring-end lanes: validity bit cleared (no segment starts there).
    long o = 0;
    for (long r = ring_i; r < ring_i + nr && r < R; ++r) {
      o += ring_lens[r];
      valid8[pos + o - 1] = 0;
    }
    const bool degenerate = (maxx <= minx) && (maxy <= miny);
    empty_out[g] = degenerate ? 1 : 0;
    bbox[4 * g + 0] = static_cast<int32_t>(std::floor(minx)) - 3;
    bbox[4 * g + 1] = static_cast<int32_t>(std::floor(miny)) - 3;
    bbox[4 * g + 2] = static_cast<int32_t>(std::ceil(maxx)) + 3;
    bbox[4 * g + 3] = static_cast<int32_t>(std::ceil(maxy)) + 3;
    anc_starts[g + 1] = n_anc;
    ring_i += nr;
    pos += k;
  }
  return n_anc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native font index: cmap union + hmtx advances.
//
// Replaces the fontTools cmap/post decompile on the ingest hot path
// (the reference delegates this to the ttf-parser crate,
// reference/src/font/metadata.rs:103-116): the union over all
// unicode cmap subtables in encoding-record order, FIRST subtable to
// map a codepoint wins — the same scan fontTools' isUnicode()/union
// logic performs (asserted bit-equal in tests/test_native.py).
// ---------------------------------------------------------------------------

namespace {

// Insert cp->gid if not already mapped (first subtable wins). gid 0
// (missing glyph) is not a mapping — fontTools format-4/12 decompile
// skips it and ttf-parser's glyph_index returns None for it.
struct CmapUnion {
  std::vector<int32_t> map;  // cp -> gid, -1 = unmapped
  std::vector<uint32_t> order;  // insertion order for sorting later

  CmapUnion() : map(0x110000, -1) { order.reserve(4096); }

  inline void put(uint32_t cp, uint32_t gid) {
    if (cp >= 0x110000 || gid == 0) return;
    if (map[cp] < 0) {
      map[cp] = static_cast<int32_t>(gid);
      order.push_back(cp);
    }
  }
};

// A subtable's assignments as fontTools makes them into its dict: the
// last one of a code wins, then a gid of 0 is no mapping (format 2's
// decompile sets its dict before `_make_map` drops the 0s, so there a 0
// overrides; format 13 skips them as it goes).
// Codes past U+10FFFF are dropped, as `CmapUnion::put` drops them.
struct SubtableMap {
  std::vector<int64_t> last;  // code -> gid, -1 = unset
  std::vector<uint32_t> codes;  // the codes set, in first-set order

  SubtableMap() : last(0x110000, -1) {}
  void set(uint32_t cp, uint32_t gid) {
    if (cp >= 0x110000) return;
    if (last[cp] < 0) codes.push_back(cp);
    last[cp] = gid;
  }
  void put_into(CmapUnion* u) const {
    for (uint32_t cp : codes) u->put(cp, static_cast<uint32_t>(last[cp]));
  }
};

// Format 2 (high-byte mapping through subHeaders) as fontTools 4.61.1's
// `cmap_format_2.decompile` reads it: the declared length bounds the
// data, the 256 subHeader keys select a subHeader for each high byte; key
// 0 maps single-byte codes through subHeader 0, any other key two-byte
// codes (high byte, firstCode + i); a glyph index of 0 maps nothing, any
// other has idDelta added modulo 65536. A code set twice keeps the last
// value, and one whose value is 0 after the delta is unmapped (the
// subtable is a dict). Every read fontTools would fail on fails here.
bool parse_cmap_format2(const uint8_t* p, long declared, CmapUnion* u) {
  if (declared < 6 + 512) return false;
  const uint8_t* keys = p + 6;
  const uint8_t* sh = keys + 512;
  const long shlen = declared - 6 - 512;
  long max_key = 0;
  for (int b = 0; b < 256; ++b) max_key = std::max<long>(max_key, rd_u16(keys + 2 * b) / 8);
  struct Sub { long first, count, delta; const uint8_t* gi; long n_gi; };
  std::vector<Sub> subs(max_key + 1);
  for (long i = 0; i <= max_key; ++i) {
    if (8 * i + 8 > shlen) return false;
    const uint8_t* h = sh + 8 * i;
    Sub& s = subs[i];
    s.first = rd_u16(h);
    s.count = rd_u16(h + 2);
    s.delta = rd_i16(h + 4);
    const long pos = 8 * (i + 1) + rd_u16(h + 6) - 2;
    const long avail = pos < shlen ? std::min(2 * s.count, shlen - pos) : 0;
    if (avail % 2) return false;  // array.frombytes of an odd length
    s.gi = sh + pos;
    s.n_gi = avail / 2;
  }
  SubtableMap got;
  for (int b = 0; b < 256; ++b) {
    const long k = rd_u16(keys + 2 * b) / 8;
    const Sub& s = subs[k];
    if (k == 0) {
      if (b < s.first || b >= s.first + s.count) continue;
      const long i = b - s.first;
      if (i >= s.n_gi) return false;
      const long gi = rd_u16(s.gi + 2 * i);
      if (gi == 0) continue;
      got.set(b, static_cast<uint32_t>((gi + s.delta) & 0xFFFF));
    } else {
      for (long i = 0; i < s.count; ++i) {
        if (i >= s.n_gi) return false;
        const long gi = rd_u16(s.gi + 2 * i);
        if (gi == 0) continue;
        got.set(static_cast<uint32_t>(b * 256 + s.first + i),
                static_cast<uint32_t>((gi + s.delta) & 0xFFFF));
      }
    }
  }
  got.put_into(u);
  return true;
}

// Parse one cmap subtable at `p` (`len` bytes to the end of the table).
// Returns 0, -2 on a subtable fontTools fails to read (or, for formats 4
// and 12, that the native reader rejects), or -3 - format for a format
// fontTools 4.61.1 has no decoder for (`cmap_format_unknown`, which
// raises AttributeError when its mapping is read: formats 8 and 10 among
// them). fontTools skips a subtable whose declared length is 0; formats 2
// and 13 follow fontTools (the declared length bounds the data; format
// 13's must equal 16 + 12 * nGroups); formats 0, 4, 6 and 12 keep the
// native reader's rules (the declared length unread, U+FFFF skipped in
// format 4), as the JAX package's native reader does.
int parse_cmap_subtable(const uint8_t* p, long len, CmapUnion* u) {
  if (len < 4) return -2;
  const uint16_t format = rd_u16(p);
  const bool long_len = format == 8 || format == 10 || format == 12 || format == 13;
  if (long_len && len < 8) return -2;
  const long declared = long_len ? static_cast<long>(rd_u32(p + 4))
                                 : (format == 14 ? (len < 6 ? -1 : static_cast<long>(rd_u32(p + 2)))
                                                 : static_cast<long>(rd_u16(p + 2)));
  if (declared < 0) return -2;
  if (format == 0) {
    if (len < 262) return -2;
    for (uint32_t cp = 0; cp < 256; ++cp) u->put(cp, p[6 + cp]);
    return 0;
  }
  if (format == 4) {
    if (len < 14) return -2;
    const uint16_t segX2 = rd_u16(p + 6);
    const long need = 16 + 4L * segX2;
    if (segX2 < 2 || len < need) return -2;
    const uint8_t* ends = p + 14;
    const uint8_t* starts = p + 16 + segX2;
    const uint8_t* deltas = p + 16 + 2 * segX2;
    const uint8_t* ranges = p + 16 + 3 * segX2;
    for (int s = 0; s < segX2 / 2; ++s) {
      const uint32_t end = rd_u16(ends + 2 * s);
      const uint32_t start = rd_u16(starts + 2 * s);
      if (start > end) continue;
      const int16_t delta = rd_i16(deltas + 2 * s);
      const uint16_t ro = rd_u16(ranges + 2 * s);
      for (uint32_t cp = start; cp <= end; ++cp) {
        uint32_t gid;
        if (ro == 0) {
          gid = static_cast<uint16_t>(cp + delta);
        } else {
          // Spec: address into glyphIdArray relative to &ranges[2s].
          // Bounds check in long offsets (never form an OOB pointer).
          const long qoff =
              16L + 3L * segX2 + 2L * s + ro + 2L * (cp - start);
          if (qoff + 2 > len) continue;
          const uint8_t* q = p + qoff;
          const uint16_t raw = rd_u16(q);
          if (raw == 0) continue;
          gid = static_cast<uint16_t>(raw + delta);
        }
        if (cp != 0xFFFF) u->put(cp, gid);
      }
    }
    return 0;
  }
  if (format == 6) {
    if (len < 10) return -2;
    const uint32_t first = rd_u16(p + 6);
    const uint32_t count = rd_u16(p + 8);
    if (len < 10 + 2L * count) return -2;
    for (uint32_t i = 0; i < count; ++i)
      u->put(first + i, rd_u16(p + 10 + 2 * i));
    return 0;
  }
  if (format == 12) {
    if (len < 16) return -2;
    const uint32_t ngroups = rd_u32(p + 12);
    if (len < 16 + 12L * ngroups) return -2;
    for (uint32_t g = 0; g < ngroups; ++g) {
      const uint8_t* q = p + 16 + 12 * g;
      const uint32_t start = rd_u32(q);
      const uint32_t end = rd_u32(q + 4);
      const uint32_t sgid = rd_u32(q + 8);
      if (end < start || end - start > 0x110000) continue;
      for (uint32_t cp = start; cp <= end; ++cp) {
        u->put(cp, sgid + (cp - start));
        if (cp == end) break;  // end == 0xFFFFFFFF would wrap cp forever
      }
    }
    return 0;
  }
  // Format 14 (variation sequences) maps no codepoint: fontTools keeps
  // an empty cmap for it, ttf-parser's glyph_index never reads it.
  if (format == 14) return 0;
  if (declared == 0) return 0;  // fontTools skips a zero-length subtable
  if (declared > len) return -2;  // its header assert: a short slice
  if (format == 2) return parse_cmap_format2(p, declared, u) ? 0 : -2;
  if (format == 13) {
    // Many-to-one ranges: each code of [start, end] maps to the group's
    // one glyph; a later group overrides an earlier one's codes.
    if (declared < 16) return -2;
    const long ngroups = rd_u32(p + 12);
    if (declared != 16 + 12 * ngroups) return -2;
    // A later group overrides an earlier one's codes, unless its glyph is
    // 0 (fontTools' `_make_map` skips those entries). Groups that would
    // set more than 16 × 0x110000 codes in all are refused (fontTools
    // would spend minutes or gigabytes on them).
    SubtableMap got;
    long budget = 16L * 0x110000;
    for (long g = 0; g < ngroups; ++g) {
      const uint8_t* q = p + 16 + 12 * g;
      const uint32_t start = rd_u32(q), end = rd_u32(q + 4), gid = rd_u32(q + 8);
      if (start > end || start >= 0x110000) continue;
      const uint32_t stop = std::min<uint32_t>(end, 0x10FFFF);
      budget -= static_cast<long>(stop - start) + 1;
      if (budget < 0) return -2;
      if (gid == 0) continue;  // `_make_map` skips it: no override
      for (uint32_t cp = start; cp <= stop; ++cp) got.set(cp, gid);
    }
    got.put_into(u);
    return 0;
  }
  return -3 - static_cast<int>(format);
}

}  // namespace

extern "C" {

// cmap union over unicode subtables (record order, first-wins).
// Outputs cp/gid pairs sorted by cp. Returns the count, -1 when `cap`
// is too small (re-call with a bigger buffer), -2 on a malformed table,
// -3 - format for a unicode subtable of a format fontTools cannot read.
long vg_cmap_union(const uint8_t* cmap, long cmap_len, uint32_t* out_cps,
                   uint32_t* out_gids, long cap) {
  if (cmap_len < 4) return -2;
  const uint16_t n_tables = rd_u16(cmap + 2);
  if (cmap_len < 4 + 8L * n_tables) return -2;
  CmapUnion u;
  for (int t = 0; t < n_tables; ++t) {
    const uint8_t* rec = cmap + 4 + 8 * t;
    const uint16_t plat = rd_u16(rec);
    const uint16_t enc = rd_u16(rec + 2);
    const uint32_t off = rd_u32(rec + 4);
    // fontTools CmapSubtable.isUnicode(): platform 0 (any encoding) or
    // platform 3 with encoding 0, 1 or 10.
    const bool is_unicode =
        plat == 0 || (plat == 3 && (enc == 0 || enc == 1 || enc == 10));
    if (!is_unicode) continue;
    // 64-bit compare: a garbage offset near UINT32_MAX must not wrap.
    if (static_cast<long>(off) + 4 > cmap_len) return -2;
    const int rc = parse_cmap_subtable(cmap + off, cmap_len - off, &u);
    if (rc != 0) return rc;
  }
  const long n = static_cast<long>(u.order.size());
  if (n > cap) return -1;
  std::sort(u.order.begin(), u.order.end());
  for (long i = 0; i < n; ++i) {
    out_cps[i] = u.order[i];
    out_gids[i] = static_cast<uint32_t>(u.map[u.order[i]]);
  }
  return n;
}

// hmtx advances for every glyph id: gid < num_hmetrics reads its own
// longHorMetric, the rest repeat the last advance (OpenType spec).
// Returns 0, or -2 when the table is too short.
long vg_hmtx_advances(const uint8_t* hmtx, long hmtx_len, long num_hmetrics,
                      long num_glyphs, uint16_t* out_adv) {
  if (num_hmetrics < 1 || hmtx_len < 4 * num_hmetrics) return -2;
  uint16_t last = 0;
  for (long g = 0; g < num_glyphs; ++g) {
    if (g < num_hmetrics) last = rd_u16(hmtx + 4 * g);
    out_adv[g] = last;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Outline segments for the fit path: vg_glyf_curves / vg_cff_curves.
//
// The same glyf and Type 2 walks as the ring parsers (parse_glyph,
// run_t2), into a sink that records each segment instead of flattening
// it, in the order and with the f64 points (component transforms
// applied, implied on-curve points computed after them) that a
// fontTools pen receives: one record a moveTo, lineTo, quadratic,
// cubic and closePath. A record holds its kind and 8 doubles: the
// current point before it, then the segment's points (a line and a
// move repeat their end point; a quadratic its control point), and
// for a close the contour's start as its end. The caller builds the
// cubic soup from them (font/entry.py, the rules of fontTools-based
// CurvePen). A CFF glyph is closed at endchar only, as fontTools'
// T2OutlineExtractor closes it.
// ---------------------------------------------------------------------------

namespace {

enum SegKind : int8_t { kMove = 0, kLine = 1, kQuad = 2, kCubic = 3, kClose = 4 };

struct SegSink {
  std::vector<int8_t> kinds;
  std::vector<double> pts;  // 8 a record
  double sx = 0.0, sy = 0.0, cx = 0.0, cy = 0.0;
  bool open = false;
  bool bad = false;  // a drawing op with no open contour

  void rec(int8_t k, double ax, double ay, double bx, double by, double ex,
           double ey) {
    kinds.push_back(k);
    const double r[8] = {cx, cy, ax, ay, bx, by, ex, ey};
    pts.insert(pts.end(), r, r + 8);
    cx = ex;
    cy = ey;
  }
  void move_to(double x, double y) {
    close_path();
    sx = cx = x;
    sy = cy = y;
    rec(kMove, x, y, x, y, x, y);
    open = true;
  }
  void line_to(double x, double y) {
    if (!open) {
      bad = true;
      return;
    }
    rec(kLine, x, y, x, y, x, y);
  }
  void quad_to(double qx, double qy, double x, double y) {
    if (!open) {
      bad = true;
      return;
    }
    rec(kQuad, qx, qy, qx, qy, x, y);
  }
  void cubic_to(double c1x, double c1y, double c2x, double c2y, double x,
                double y) {
    if (!open) {
      bad = true;
      return;
    }
    rec(kCubic, c1x, c1y, c2x, c2y, x, y);
  }
  void close_path() {
    if (!open) return;
    rec(kClose, sx, sy, sx, sy, sx, sy);
    open = false;
  }
};

// Concatenates per-glyph records in glyph order into the caller's
// buffers; glyph_nrecs[i] = records of glyph i, -1 where it failed.
// Returns 0, or 1 when a capacity was exceeded (out_count holds the
// total needed).
long gather_segs(const std::vector<SegSink>& outs,
                 const std::vector<uint8_t>& ok, int8_t* kinds, double* pts,
                 long cap, int32_t* glyph_nrecs, int64_t* out_count) {
  long n = 0;
  bool overflow = false;
  for (size_t i = 0; i < outs.size(); ++i) {
    if (!ok[i]) {
      glyph_nrecs[i] = -1;
      continue;
    }
    long m = static_cast<long>(outs[i].kinds.size());
    if (!overflow && n + m <= cap) {
      std::memcpy(kinds + n, outs[i].kinds.data(), m);
      std::memcpy(pts + 8 * n, outs[i].pts.data(), 8 * m * sizeof(double));
    } else {
      overflow = true;
    }
    glyph_nrecs[i] = static_cast<int32_t>(m);
    n += m;
  }
  *out_count = n;
  return overflow ? 1 : 0;
}

}  // namespace

extern "C" {

long vg_glyf_curves(const uint8_t* glyf, long glyf_len, const uint32_t* loca,
                    long n_glyphs, const int16_t* lsb, long n_lsb,
                    const uint32_t* gids, long n_gids,
                    int8_t* kinds, double* pts, long cap,
                    int32_t* glyph_nrecs, int64_t* out_count) {
  // Every glyph as fontTools draws it (the JAX package's curves).
  GlyfCtx ctx{glyf, glyf_len, loca, n_glyphs};
  const Affine id{1.0, 0.0, 0.0, 1.0, 0.0, 0.0};
  std::vector<SegSink> outs(n_gids);
  std::vector<uint8_t> ok(n_gids, 0);
  for (long i = 0; i < n_gids; ++i) {
    SegSink& sink = outs[i];
    if (!ft_glyf(ctx, gids[i], sink, id, false, 0, lsb, n_lsb)) continue;
    ok[i] = 1;
  }
  return gather_segs(outs, ok, kinds, pts, cap, glyph_nrecs, out_count);
}

long vg_cff_curves(const uint8_t* cff, long cff_len, const uint32_t* gids,
                   long n_gids, int8_t* kinds, double* pts, long cap,
                   int32_t* glyph_nrecs, int64_t* out_count) {
  // Every glyph in fontTools mode: the JAX package draws the fit path's
  // curves through fontTools' pen, the native-walked glyphs too.
  CffFont font;
  bool font_ok = parse_any_cff(cff, cff_len, &font);
  std::vector<SegSink> outs(n_gids);
  std::vector<uint8_t> ok(n_gids, 0);
  for (long i = 0; i < n_gids && font_ok; ++i) {
    int depth = 0;
    if (!ft_draw_glyph(font, gids[i], outs[i], false, 0.0, 0.0, &depth)) continue;
    ok[i] = 1;
  }
  return gather_segs(outs, ok, kinds, pts, cap, glyph_nrecs, out_count);
}

}  // extern "C"
