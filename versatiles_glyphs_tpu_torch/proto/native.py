"""ctypes bindings to the native host runtime (csrc/vg_native.cpp).

Provides drop-in fast paths for the pure-Python implementations:

- `encode_glyph_block` ↔ `proto.pbf.encode_glyphs` (byte-identical)
- `tar_header`         ↔ `writer.tar.build_header` (byte-identical)
- `render_sdf_batch`   ↔ `ops.sdf_ref.render_sdf_exact` (bit-identical
  f64, multithreaded — the reference-equivalent CPU renderer)

The shared object is built on demand with g++ from this package's own
``csrc/vg_native.cpp`` into ``build/native/vg_native-<hash>.so`` at the
root of the checkout; the hash covers the source and the flags, so a
stale library is never loaded. A failed build or load degrades silently
to the Python paths (`available()` reports the state); `require()`
raises with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
# Why the last build or load failed; `require()` reports it.
_ERROR = ""

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "vg_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
_GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update("\0".join(_GXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"vg_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    global _ERROR
    # Compile to a private temp path, then atomically replace: a
    # concurrent process must never dlopen a half-written .so.
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = ["g++", *_GXX_FLAGS, "-o", tmp, _SRC]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        _ERROR = f"{' '.join(cmd)}\n{e!r}"
        return False
    if proc.returncode != 0:
        _ERROR = (
            f"g++ failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _LIB, _TRIED, _ERROR
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
    except OSError as e:
        _ERROR = f"cannot read {_SRC}: {e!r}"
        return None
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        _ERROR = f"cannot load {so}: {e!r}"
        return None

    # Explicit argtypes are load-bearing: without them ctypes passes
    # Python ints as 32-bit c_int, and on x86-64 the stack slots of
    # arguments 7+ then carry garbage upper bits into C `long`
    # parameters (intermittent overflows/segfaults).
    P = ctypes.c_void_p
    L = ctypes.c_long
    I = ctypes.c_int
    lib.vg_encode_glyph_block.restype = L
    lib.vg_encode_glyph_block.argtypes = [
        ctypes.c_char_p, L, ctypes.c_char_p, L, L,
        P, P, P, P, P, P, P, P, P, P, L,
    ]
    lib.vg_tar_header.restype = L
    lib.vg_tar_header.argtypes = [
        ctypes.c_char_p, L, ctypes.c_uint64, ctypes.c_uint64, I,
        ctypes.c_uint64, P,
    ]
    lib.vg_render_sdf_batch.restype = L
    lib.vg_render_sdf_batch.argtypes = [P, P, P, L, P, P, I]
    if hasattr(lib, "vg_glyf_rings"):
        lib.vg_glyf_rings.restype = L
        lib.vg_glyf_rings.argtypes = [
            P, L, P, L, L, P, L, P, L, ctypes.c_double, P, L, P, L, P, P,
        ]
    if hasattr(lib, "vg_cff_rings"):
        lib.vg_cff_rings.restype = L
        lib.vg_cff_rings.argtypes = [
            P, L, L, P, L, ctypes.c_double, P, L, P, L, P, P,
        ]
    if hasattr(lib, "vg_glyf_curves"):
        lib.vg_glyf_curves.restype = L
        lib.vg_glyf_curves.argtypes = [P, L, P, L, P, L, P, L, P, P, L, P, P]
    if hasattr(lib, "vg_cff_curves"):
        lib.vg_cff_curves.restype = L
        lib.vg_cff_curves.argtypes = [P, L, P, L, P, P, L, P, P]
    if hasattr(lib, "vg_prep_cores"):
        lib.vg_prep_cores.restype = L
        lib.vg_prep_cores.argtypes = [
            P, L, P, L, P, L, P, ctypes.c_double,
            P, P, P, P, P, P, P, P, P, P, P, P, P,
        ]
    if hasattr(lib, "vg_cff_glyph_count"):
        lib.vg_cff_glyph_count.restype = L
        lib.vg_cff_glyph_count.argtypes = [P, L]
    if hasattr(lib, "vg_cmap_union"):
        lib.vg_cmap_union.restype = L
        lib.vg_cmap_union.argtypes = [P, L, P, P, L]
    if hasattr(lib, "vg_hmtx_advances"):
        lib.vg_hmtx_advances.restype = L
        lib.vg_hmtx_advances.argtypes = [P, L, L, L, P]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def require() -> None:
    """Raise, with the compiler's or the loader's output, unless the
    native library is built and loaded."""
    if _load() is None:
        raise RuntimeError(f"native library unavailable: {_ERROR}")


def encode_glyph_block(name: str, range_str: str, glyphs) -> bytes | None:
    """Encode a block's `glyphs` message natively; None when the native
    library is unavailable. ``glyphs`` is a list of `proto.pbf.PbfGlyph`."""
    lib = _load()
    if lib is None:
        return None
    n = len(glyphs)
    ids = np.array([g.id for g in glyphs], dtype=np.uint32)
    widths = np.array([g.width for g in glyphs], dtype=np.uint32)
    heights = np.array([g.height for g in glyphs], dtype=np.uint32)
    lefts = np.array([g.left for g in glyphs], dtype=np.int32)
    tops = np.array([g.top for g in glyphs], dtype=np.int32)
    advances = np.array([g.advance for g in glyphs], dtype=np.uint32)
    has_bm = np.array([g.bitmap is not None for g in glyphs], dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    for i, g in enumerate(glyphs):
        offs[i + 1] = offs[i] + (len(g.bitmap) if g.bitmap is not None else 0)
    bitmaps = b"".join(g.bitmap for g in glyphs if g.bitmap is not None)
    bm_arr = np.frombuffer(bitmaps, dtype=np.uint8) if bitmaps else np.zeros(1, np.uint8)

    name_b = name.encode("utf-8")
    range_b = range_str.encode("utf-8")
    cap = int(offs[-1]) + 64 * max(n, 1) + len(name_b) + len(range_b) + 64
    out = np.zeros(cap, dtype=np.uint8)

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    written = lib.vg_encode_glyph_block(
        name_b, len(name_b), range_b, len(range_b), n,
        _p(ids), _p(widths), _p(heights), _p(lefts), _p(tops), _p(advances),
        _p(bm_arr), _p(offs), _p(has_bm), _p(out), cap,
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def tar_header(
    name: str, size: int, mode: int, typeflag: int, mtime: int
) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    name_b = name.encode("utf-8")
    out = np.zeros(512, dtype=np.uint8)
    rc = lib.vg_tar_header(
        name_b, len(name_b), ctypes.c_uint64(size), ctypes.c_uint64(mode),
        typeflag, ctypes.c_uint64(mtime), out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(f"tar entry name longer than 100 bytes: {name!r}")
    return out.tobytes()


def _lsb_arg(lsb):
    """(pointer, count) of an int16 left-side-bearing array, or (None, 0)
    where there is none (a glyph that needs one then fails)."""
    if lsb is None:
        return None, 0
    lsb = np.ascontiguousarray(lsb, dtype=np.int16)
    return lsb, len(lsb)


def glyf_rings(
    glyf: np.ndarray, loca: np.ndarray, gids: np.ndarray, tol_sq: float, lsb=None,
    fonttools_mode: bool = True,
):
    """Flattened outline rings for a batch of glyph ids, parsed natively
    from the raw glyf table (csrc vg_glyf_rings), with fontTools' drawing
    where the native walk gives up (which moves a top-level simple glyph
    by its hmtx ``lsb`` [glyphs] int16 minus its xMin; none with
    ``fonttools_mode`` False: the font has no fontTools glyph set).
    Returns
    (pts [npts, 2] f64, ring_lens [nrings] i32, glyph_nrings [n] i32 —
    -1 marks a glyph fontTools fails to draw too) or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "vg_glyf_rings"):
        return None
    glyf = np.ascontiguousarray(glyf, dtype=np.uint8)
    loca = np.ascontiguousarray(loca, dtype=np.uint32)
    gids = np.ascontiguousarray(gids, dtype=np.uint32)
    lsb_a, n_lsb = _lsb_arg(lsb)
    n = len(gids)
    nr = np.zeros(n, dtype=np.int32)
    counts = np.zeros(2, dtype=np.int64)

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    pts_cap, rings_cap = 1 << 20, 1 << 15
    for _ in range(3):
        pts = np.empty((pts_cap, 2), dtype=np.float64)
        ring_lens = np.empty(rings_cap, dtype=np.int32)
        rc = lib.vg_glyf_rings(
            _p(glyf), len(glyf), _p(loca), len(loca) - 1, int(fonttools_mode),
            None if lsb_a is None else _p(lsb_a), n_lsb, _p(gids), n,
            ctypes.c_double(tol_sq), _p(pts), pts_cap, _p(ring_lens),
            rings_cap, _p(nr), _p(counts),
        )
        if rc == 0:
            return pts[: int(counts[0])], ring_lens[: int(counts[1])], nr
        pts_cap = int(counts[0]) + 1
        rings_cap = int(counts[1]) + 1
    return None


def cff_rings(cff: np.ndarray, gids: np.ndarray, tol_sq: float, fonttools_mode: bool = True):
    """Flattened outline rings for a batch of glyph ids, parsed
    natively from a raw 'CFF ' or 'CFF2' table (csrc vg_cff_rings — Type
    2 charstring interpreter, with fontTools' semantics where the native
    walk gives up and for CFF2, unless ``fonttools_mode`` is False). Same
    return contract as `glyf_rings`;
    per-glyph -1 marks a glyph fontTools fails to draw too."""
    lib = _load()
    if lib is None or not hasattr(lib, "vg_cff_rings"):
        return None
    cff = np.ascontiguousarray(cff, dtype=np.uint8)
    gids = np.ascontiguousarray(gids, dtype=np.uint32)
    n = len(gids)
    nr = np.zeros(n, dtype=np.int32)
    counts = np.zeros(2, dtype=np.int64)

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    pts_cap, rings_cap = 1 << 20, 1 << 15
    for _ in range(3):
        pts = np.empty((pts_cap, 2), dtype=np.float64)
        ring_lens = np.empty(rings_cap, dtype=np.int32)
        rc = lib.vg_cff_rings(
            _p(cff), len(cff), int(fonttools_mode), _p(gids), n, ctypes.c_double(tol_sq),
            _p(pts), pts_cap, _p(ring_lens), rings_cap, _p(nr), _p(counts),
        )
        if rc == 0:
            return pts[: int(counts[0])], ring_lens[: int(counts[1])], nr
        pts_cap = int(counts[0]) + 1
        rings_cap = int(counts[1]) + 1
    return None


def _curves(call, n: int):
    """Run a ``vg_*_curves`` entry point, growing its buffers until they
    hold every record: (kinds [M] i8, pts [M, 4, 2] f64, glyph_nrecs [n]
    i32)."""
    nrecs = np.zeros(n, dtype=np.int32)
    count = np.zeros(1, dtype=np.int64)
    cap = 1 << 16
    for _ in range(3):
        kinds = np.empty(cap, dtype=np.int8)
        pts = np.empty((cap, 4, 2), dtype=np.float64)
        if call(_ptr(kinds), _ptr(pts), cap, _ptr(nrecs), _ptr(count)) == 0:
            m = int(count[0])
            return kinds[:m], pts[:m], nrecs
        cap = int(count[0]) + 1
    raise RuntimeError("native outline segments: buffer growth failed")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def glyf_curves(glyf: np.ndarray, loca: np.ndarray, gids: np.ndarray, lsb=None):
    """The outline segments of a batch of glyph ids, walked natively
    from the raw glyf table (csrc ``vg_glyf_curves``) as fontTools draws
    them into a pen (a top-level simple glyph moved by ``lsb`` - xMin): (kinds [M] i8 — 0 move, 1 line, 2 quadratic, 3 cubic,
    4 close —, pts [M, 4, 2] f64 — the current point, then the
    segment's points, a close ending at its contour's start —,
    glyph_nrecs [n] i32, −1 for a glyph fontTools fails to draw), or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    glyf = np.ascontiguousarray(glyf, dtype=np.uint8)
    loca = np.ascontiguousarray(loca, dtype=np.uint32)
    gids = np.ascontiguousarray(gids, dtype=np.uint32)
    lsb_a, n_lsb = _lsb_arg(lsb)
    return _curves(lambda *out: lib.vg_glyf_curves(
        _ptr(glyf), len(glyf), _ptr(loca), len(loca) - 1,
        None if lsb_a is None else _ptr(lsb_a), n_lsb, _ptr(gids), len(gids), *out),
        len(gids))


def cff_curves(cff: np.ndarray, gids: np.ndarray):
    """`glyf_curves` from a raw 'CFF ' or 'CFF2' table (csrc
    ``vg_cff_curves``, the Type 2 charstring walk as fontTools' pen
    draws it)."""
    lib = _load()
    if lib is None:
        return None
    cff = np.ascontiguousarray(cff, dtype=np.uint8)
    gids = np.ascontiguousarray(gids, dtype=np.uint32)
    return _curves(lambda *out: lib.vg_cff_curves(
        _ptr(cff), len(cff), _ptr(gids), len(gids), *out), len(gids))


def cff_glyph_count(cff: np.ndarray) -> int:
    """The number of charstrings of a raw 'CFF ' or 'CFF2' table, -1
    where it does not parse."""
    lib = _load()
    cff = np.ascontiguousarray(cff, dtype=np.uint8)
    return int(lib.vg_cff_glyph_count(_ptr(cff), len(cff)))


def render_sdf_batch(preps, n_threads: int | None = None):
    """Exact f64 SDF bitmaps for a list of non-empty `GlyphPrep`s, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n = len(preps)
    seg_offs = np.zeros(n + 1, dtype=np.int64)
    out_offs = np.zeros(n + 1, dtype=np.int64)
    meta = np.zeros((n, 4), dtype=np.int32)
    for i, p in enumerate(preps):
        seg_offs[i + 1] = seg_offs[i] + p.segments.shape[0]
        out_offs[i + 1] = out_offs[i] + p.width * p.height
        meta[i] = (p.x0, p.y0, p.width, p.height)
    segs = (
        np.concatenate([p.segments for p in preps], axis=0)
        if n
        else np.zeros((0, 4))
    )
    segs = np.ascontiguousarray(segs, dtype=np.float64)
    out = np.zeros(int(out_offs[-1]), dtype=np.uint8)

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.vg_render_sdf_batch(
        _p(segs), _p(seg_offs), _p(meta), n, _p(out), _p(out_offs), n_threads
    )
    return [
        out[out_offs[i] : out_offs[i + 1]].copy() for i in range(n)
    ]


def encode_block_from_preps(
    name: str, range_str: str, preps, bitmap_iter
) -> bytes | None:
    """Encode a block straight from `GlyphPrep`s + rendered bitmaps
    (consumed from ``bitmap_iter`` for each non-empty prep, in order) —
    the fused form of `Renderer.assemble_glyphs` + `encode_glyph_block`
    without the per-glyph `PbfGlyph` objects and the double bitmap
    copy. Byte-identical to that path (asserted in tests/test_pbf.py);
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(preps)
    ids = np.empty(n, dtype=np.uint32)
    widths = np.zeros(n, dtype=np.uint32)
    heights = np.zeros(n, dtype=np.uint32)
    lefts = np.zeros(n, dtype=np.int32)
    tops = np.zeros(n, dtype=np.int32)
    advances = np.empty(n, dtype=np.uint32)
    has_bm = np.zeros(n, dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    bm_parts = []
    total = 0
    for i, p in enumerate(preps):
        ids[i] = p.codepoint
        advances[i] = p.advance
        if not p.empty:
            widths[i] = p.pbf_width
            heights[i] = p.pbf_height
            lefts[i] = p.pbf_left
            tops[i] = p.pbf_top
            has_bm[i] = 1
            # ravel + .size: the iterator may legitimately yield
            # (h, w)-shaped bitmaps (assemble_glyphs flattens them the
            # same way); counting rows would corrupt offsets silently.
            bm = np.asarray(next(bitmap_iter), dtype=np.uint8).ravel()
            bm_parts.append(bm)
            total += bm.size
        offs[i + 1] = total
    bm_arr = (
        np.concatenate(bm_parts) if bm_parts else np.zeros(1, np.uint8)
    )
    name_b = name.encode("utf-8")
    range_b = range_str.encode("utf-8")
    cap = total + 64 * max(n, 1) + len(name_b) + len(range_b) + 64
    out = np.zeros(cap, dtype=np.uint8)

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    written = lib.vg_encode_glyph_block(
        name_b, len(name_b), range_b, len(range_b), n,
        _p(ids), _p(widths), _p(heights), _p(lefts), _p(tops), _p(advances),
        _p(bm_arr), _p(offs), _p(has_bm), _p(out), cap,
    )
    if written < 0:
        # The cap above over-provisions every field; reaching this
        # means a bug, and the caller's bitmap iterator has already
        # advanced — failing loudly beats a silent re-encode.
        raise RuntimeError(f"native block encode overflow ({written})")
    return out[:written].tobytes()


def prep_cores_batch(pts, ring_lens, glyph_nrings, advances, upem):
    """Whole-font glyph-prep numeric pass (csrc ``vg_prep_cores``):
    metrics + transformed points + every device transport cache in one
    native sweep, replacing ~10 allocating numpy passes. Returns a dict
    of the arrays `render.metrics.build_cores` slices per glyph, or
    None when the native library is unavailable (numpy fallback)."""
    lib = _load()
    if lib is None or not hasattr(lib, "vg_prep_cores"):
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    ring_lens = np.ascontiguousarray(ring_lens, dtype=np.int32)
    glyph_nrings = np.ascontiguousarray(glyph_nrings, dtype=np.int32)
    advances = np.ascontiguousarray(advances, dtype=np.float64)
    N = pts.shape[0]
    n = glyph_nrings.shape[0]
    out = {
        "adv": np.empty(n, np.int64),
        "dx": np.empty(n, np.float64),
        "empty": np.empty(n, np.uint8),
        "bbox": np.empty((n, 4), np.int32),
        "npts": np.empty(n, np.int64),
        "postarts": np.empty(n, np.int64),
        "xy": np.empty((max(N, 1), 2), np.float64),
        "chain16": np.empty((2, max(N, 1)), np.int16),
        "valid8": np.empty(max(N, 1), np.uint8),
        "d8": np.zeros((2, max(N, 1)), np.int8),
        "anc_local": np.empty(N + 1, np.int32),
        "anc_jumps": np.empty((2, N + 1), np.int32),
        "anc_starts": np.empty(n + 1, np.int64),
    }

    def _p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    n_anc = lib.vg_prep_cores(
        _p(pts), N, _p(ring_lens), ring_lens.shape[0],
        _p(glyph_nrings), n, _p(advances), ctypes.c_double(float(upem)),
        _p(out["adv"]), _p(out["dx"]), _p(out["empty"]), _p(out["bbox"]),
        _p(out["npts"]), _p(out["postarts"]), _p(out["xy"]),
        _p(out["chain16"]), _p(out["valid8"]), _p(out["d8"]),
        _p(out["anc_local"]), _p(out["anc_jumps"]), _p(out["anc_starts"]),
    )
    if n_anc < 0:
        return None
    out["n_anc"] = int(n_anc)
    return out


def cmap_union(cmap_bytes: np.ndarray):
    """Codepoint→glyph-id union over a raw cmap table's unicode
    subtables (csrc vg_cmap_union): record order, first subtable to map
    a codepoint wins, gid 0 excluded — the union fontTools' reader gives
    (format 14 subtables map nothing in both). Returns (cps u32 sorted,
    gids u32), or None when the library is unavailable; raises
    ValueError for a table fontTools fails to read (a unicode subtable
    cut short, or of a format fontTools has no decoder for)."""
    lib = _load()
    if lib is None or not hasattr(lib, "vg_cmap_union"):
        return None
    cm = np.ascontiguousarray(cmap_bytes, dtype=np.uint8)
    cap = 1 << 16
    for _ in range(3):
        cps = np.empty(cap, np.uint32)
        gids = np.empty(cap, np.uint32)
        rc = lib.vg_cmap_union(_ptr(cm), len(cm), _ptr(cps), _ptr(gids), cap)
        if rc >= 0:
            return cps[:rc].copy(), gids[:rc].copy()
        if rc == -2:
            raise ValueError("its malformed 'cmap' table")
        if rc <= -3:
            raise ValueError(f"its unicode 'cmap' subtable of format {-3 - rc}, "
                             "which fontTools has no decoder for")
        cap *= 32  # -1: capacity; retry bigger (caps at 0x110000 pairs)
    return None


def hmtx_advances(
    hmtx_bytes: np.ndarray, num_hmetrics: int, num_glyphs: int
):
    """Per-gid advance widths from a raw hmtx table (csrc
    vg_hmtx_advances); None when unavailable or malformed."""
    lib = _load()
    if lib is None or not hasattr(lib, "vg_hmtx_advances"):
        return None
    hm = np.ascontiguousarray(hmtx_bytes, dtype=np.uint8)
    out = np.zeros(max(num_glyphs, 1), np.uint16)
    rc = lib.vg_hmtx_advances(
        hm.ctypes.data_as(ctypes.c_void_p), len(hm),
        int(num_hmetrics), int(num_glyphs),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out
