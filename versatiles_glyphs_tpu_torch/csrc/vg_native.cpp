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
  // moveto): malformed input. Flagged instead of silently dropping
  // geometry so the caller can take the pen fallback like every other
  // malformed construct (the fontTools pen errors on this).
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

struct GlyfCtx {
  const uint8_t* glyf;
  long glyf_len;
  const uint32_t* loca;
  long n_glyphs;  // loca has n_glyphs + 1 entries
};

// Parse one glyph (recursing through composites). `stack`/`depth` hold
// the enclosing component transforms, outermost first. Returns false on
// malformed/unsupported data (caller falls back to the Python pen).
bool parse_glyph(const GlyfCtx& ctx, uint32_t gid, RingSink& sink,
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
    int k = cend - start + 1;
    if (k <= 0) {
      start = cend + 1;
      continue;
    }
    const double* cxs = xs.data() + start;
    const double* cys = ys.data() + start;
    const uint8_t* cfl = flags.data() + start;

    // Cubic glyf off-curves (flag 0x80, variable-font extension): not
    // in scope for this parser — caller falls back to the Python pen.
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

}  // namespace

extern "C" {

// Flattened rings for a batch of glyph ids, straight from the raw glyf
// table. Outputs: pts (x,y interleaved f64), ring_lens (points per
// ring), glyph_nrings[n_gids] (rings per glyph; -1 = unsupported glyph,
// caller falls back to the Python pen for it). out_counts[2] = total
// points, total rings actually needed. Returns 0 on success, 1 when a
// capacity was exceeded (re-call with out_counts-sized buffers).
long vg_glyf_rings(const uint8_t* glyf, long glyf_len, const uint32_t* loca,
                   long n_glyphs, const uint32_t* gids, long n_gids,
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
    RingSink sink;
    sink.tol_sq = tol_sq;
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_gids) return;
      sink.pts.clear();
      sink.ring_lens.clear();
      sink.cur.clear();
      bool ok = parse_glyph(ctx, gids[i], sink, nullptr, 0);
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
// Unsupported constructs (seac accents, CFF2, arithmetic/storage
// operators) mark the glyph -1 and the caller falls back to the
// fontTools pen — identical outlines, slower.
// ---------------------------------------------------------------------------

namespace {

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
    // falls back to the pen, as for other malformed constructs).
    long a = off_at(i), b = off_at(i + 1);
    if (a < 1 || b < a || b > endoff) return {};
    return {data + (a - 1), b - a};
  }
};

// Parses an INDEX at p; sets *next to the first byte after it.
bool parse_cff_index(const uint8_t* p, const uint8_t* pe, CffIndexView* idx,
                     const uint8_t** next) {
  if (p + 2 > pe) return false;
  long count = rd_u16(p);
  if (count == 0) {
    idx->count = 0;
    *next = p + 2;
    return true;
  }
  if (p + 3 > pe) return false;
  int osz = p[2];
  if (osz < 1 || osz > 4) return false;
  const uint8_t* offs = p + 3;
  const uint8_t* data = offs + (count + 1) * osz;  // offset 1 = first byte
  if (data > pe) return false;
  idx->count = count;
  idx->off_size = osz;
  idx->offsets = offs;
  idx->data = data;
  long endoff = idx->off_at(count);
  if (endoff < 1 || data + (endoff - 1) > pe) return false;
  idx->endoff = endoff;
  *next = data + (endoff - 1);
  return true;
}

// Minimal DICT scan for the integer operands we need.
struct DictInts {
  long charstrings = -1;
  long private_off = -1, private_size = -1;
  long subrs = -1;   // from a Private DICT (relative offset)
  long fdarray = -1, fdselect = -1;
  bool is_cid = false;
};

bool parse_cff_dict(const uint8_t* p, const uint8_t* pe, DictInts* out) {
  double stack[48];
  int sp = 0;
  while (p < pe) {
    uint8_t b0 = *p;
    if (b0 <= 21) {
      int op = b0;
      ++p;
      if (b0 == 12) {
        if (p >= pe) return false;
        op = 1200 + *p++;
      }
      switch (op) {
        case 17: if (sp >= 1) out->charstrings = (long)stack[0]; break;
        case 18:
          if (sp >= 2) {
            out->private_size = (long)stack[0];
            out->private_off = (long)stack[1];
          }
          break;
        case 19: if (sp >= 1) out->subrs = (long)stack[0]; break;
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
      return false;  // 22-27, 31: reserved
    }
  }
  return true;
}

inline long subr_bias(long count) {
  return count < 1240 ? 107 : (count < 33900 ? 1131 : 32768);
}

struct T2Ctx {
  const CffIndexView* gsubrs;
  const CffIndexView* lsubrs;
  CubicSink* sink;
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
bool run_t2(T2Ctx& c, const uint8_t* p, const uint8_t* pe, int depth,
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
        if (c.sp >= 4) return false;  // seac accent: pen fallback
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
            return false;  // arithmetic/storage ops: pen fallback
        }
        break;
      }
      default:
        return false;  // reserved
    }
  }
  return true;
}

struct CffFont {
  const uint8_t* base;
  long len;
  CffIndexView charstrings;
  CffIndexView gsubrs;
  CffIndexView lsubrs;           // non-CID local subrs
  bool has_lsubrs = false;
  bool is_cid = false;
  std::vector<CffIndexView> fd_lsubrs;  // CID: per-FD local subrs
  std::vector<uint8_t> fd_has;
  const uint8_t* fdselect = nullptr;    // raw FDSelect data

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

bool parse_cff_font(const uint8_t* cff, long len, CffFont* out) {
  out->base = cff;
  out->len = len;
  if (len < 4) return false;
  int hdr = cff[2];
  if (cff[0] != 1) return false;  // CFF major version 1 only (no CFF2)
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
    }
    out->fdselect = cff + top.fdselect;
  } else {
    if (!parse_private_subrs(cff, len, top.private_off, top.private_size,
                             &out->lsubrs, &out->has_lsubrs))
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

// CFF twin of vg_glyf_rings: same output contract (glyph_nrings[i] = -1
// marks pen fallback), input = the raw 'CFF ' table bytes.
long vg_cff_rings(const uint8_t* cff, long cff_len, const uint32_t* gids,
                  long n_gids, double tol_sq, double* pts, long pts_cap,
                  int32_t* ring_lens, long rings_cap, int32_t* glyph_nrings,
                  int64_t* out_counts) {
  CffFont font;
  bool font_ok = parse_cff_font(cff, cff_len, &font);

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
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n_gids) return;
      if (!font_ok) continue;
      CffSlice cs = font.charstrings.get(gids[i]);
      if (cs.p == nullptr) continue;
      sink.pts.clear();
      sink.ring_lens.clear();
      sink.cur.clear();
      sink.bad = false;
      T2Ctx ctx;
      ctx.gsubrs = &font.gsubrs;
      if (font.is_cid) {
        int fd = font.fd_of(gids[i]);
        if (fd < 0 || fd >= (int)font.fd_lsubrs.size()) continue;
        ctx.lsubrs = font.fd_has[fd] ? &font.fd_lsubrs[fd] : nullptr;
      } else {
        ctx.lsubrs = font.has_lsubrs ? &font.lsubrs : nullptr;
      }
      ctx.sink = &sink;
      bool ended = false;
      if (!run_t2(ctx, cs.p, cs.p + cs.len, 0, &ended)) continue;
      if (sink.bad) continue;  // draw op with no open ring: pen fallback
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

inline uint32_t rd_u32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

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

// Parse one cmap subtable at `p` (length `len`). Returns false on an
// unsupported format (caller falls back to fontTools wholesale).
bool parse_cmap_subtable(const uint8_t* p, long len, CmapUnion* u) {
  if (len < 4) return false;
  const uint16_t format = rd_u16(p);
  if (format == 0) {
    if (len < 262) return false;
    for (uint32_t cp = 0; cp < 256; ++cp) u->put(cp, p[6 + cp]);
    return true;
  }
  if (format == 4) {
    if (len < 14) return false;
    const uint16_t segX2 = rd_u16(p + 6);
    const long need = 16 + 4L * segX2;
    if (segX2 < 2 || len < need) return false;
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
    return true;
  }
  if (format == 6) {
    if (len < 10) return false;
    const uint32_t first = rd_u16(p + 6);
    const uint32_t count = rd_u16(p + 8);
    if (len < 10 + 2L * count) return false;
    for (uint32_t i = 0; i < count; ++i)
      u->put(first + i, rd_u16(p + 10 + 2 * i));
    return true;
  }
  if (format == 12) {
    if (len < 16) return false;
    const uint32_t ngroups = rd_u32(p + 12);
    if (len < 16 + 12L * ngroups) return false;
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
    return true;
  }
  return false;  // formats 2/8/10/13/14: fontTools fallback
}

}  // namespace

extern "C" {

// cmap union over unicode subtables (record order, first-wins).
// Outputs cp/gid pairs sorted by cp. Returns the count, -1 when `cap`
// is too small (re-call with a bigger buffer), -2 on an unsupported
// subtable format or malformed table (caller uses fontTools).
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
    if (!parse_cmap_subtable(cmap + off, cmap_len - off, &u)) return -2;
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
