"""Synthesized curved glyphs of real-font size, for tests and the chip
smoke run.

`versatiles_glyphs_tpu.utils.synth_font.build_ttf` draws squares: about
8 lanes per glyph. The outlines here are deterministic quadratic-curve
contours (an outer ring and, for two glyphs in three, a hole of the
opposite orientation), whose flattening (`ops.flatten`) gives a few
hundred points per glyph at the default detail, like a text font, and
about a thousand at ``quads=24``, like a heavy script.

`curved_outlines`, `curved_preps`, `synth_fit_batch` and `SynthEntry`
need only numpy (and torch); `build_ttf_curved` writes the same
outlines as a TrueType font with numpy and struct alone, so that a
machine without fontTools can make the fonts the CLI reads. The CPU
tests show that the font and the synthesized forms agree (the same
preps, the same fit batch, the same metadata) and that fontTools reads
the file as it reads FontBuilder's font of the same glyphs.

`cjk_outlines` draws CJK-like ideographs (6-16 stroke contours of lines
and integer cubics from a library of 48 strokes), and `build_otf_curved`
and `build_otf2_curved` write them as OpenType CFF (CID-keyed or
name-keyed) and CFF2 fonts over the CJK blocks (`cjk_codepoints`), with
global and local subrs, hints, every Type 2 path operator and, in CFF2,
blend and vsindex: 27,584 glyphs in about a second each. `cmap_format2`,
`cmap_format13` and `with_cmap` give a font a cmap of one of those
formats.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..ops.flatten import RingAccumulator
from ..render.metrics import prepare_glyph

UPEM = 1000
ASCENT = 800
DESCENT = -200
# head.created and head.modified of `build_ttf_curved`: 2024-01-01 in
# seconds since 1904, fixed so that the file is a function of its inputs.
TIMESTAMP = 3_786_912_000


def _ring(rng, cx: int, cy: int, radius: float, n: int, reverse: bool):
    """On-curve points P_j and off-curve points C_j (integer font units)
    of one closed quadratic contour: quad j runs P_j → C_j → P_{j+1}."""
    step = 2.0 * math.pi / n
    ang = step * np.arange(n) + rng.uniform(-0.2, 0.2, n) * step
    if reverse:
        ang = ang[::-1]
    r_on = radius * rng.uniform(0.85, 1.0, n)
    mid = ang + np.diff(np.append(ang, ang[0] + (-1 if reverse else 1) * 2.0 * math.pi)) / 2.0
    on = [(cx + round(r * math.cos(a)), cy + round(r * math.sin(a))) for r, a in zip(r_on, ang)]
    off = [(cx + round(radius * math.cos(a)), cy + round(radius * math.sin(a))) for a in mid]
    return on, off


def curved_outlines(n_glyphs: int, seed: int = 0, quads: int = 8):
    """Per glyph ``(advance, contours)``, each contour an ``(on, off)``
    pair of equal-length integer point lists. Deterministic in
    ``(seed, glyph index)``."""
    out = []
    for k in range(n_glyphs):
        rng = np.random.default_rng([seed, k])
        radius = float(rng.integers(190, 360))
        cx = 60 + round(1.3 * radius)
        cy = round(1.3 * radius) - 120
        contours = [_ring(rng, cx, cy, radius, quads + int(rng.integers(0, 3)), False)]
        if k % 3:
            contours.append(_ring(rng, cx, cy, 0.4 * radius, max(quads * 3 // 4, 3), True))
        out.append((2 * cx, contours))
    return out


def _draw(contours, move_to, quad_to, close):
    for on, off in contours:
        move_to(*on[0])
        n = len(on)
        for j in range(n):
            quad_to(*off[j], *on[(j + 1) % n])
        close()


def curved_preps(n_glyphs: int, first_cp: int = 32, seed: int = 0, quads: int = 8):
    """`GlyphPrep`s of `curved_outlines`, flattened by `ops.flatten` and
    measured by `render.metrics.prepare_glyph`, for codepoints
    ``first_cp ..``: what a font file holding these outlines gives."""
    preps = []
    for k, (advance, contours) in enumerate(curved_outlines(n_glyphs, seed, quads)):
        acc = RingAccumulator()
        _draw(contours, acc.move_to, acc.quad_to, acc.close_path)
        preps.append(prepare_glyph(first_cp + k, acc.finish(), UPEM, advance))
    return preps


def _checksum(data: bytes) -> int:
    """The sfnt checksum: the sum of big-endian u32 words, zero-padded."""
    data += b"\0" * (-len(data) % 4)
    return int(np.frombuffer(data, ">u4").sum(dtype=np.uint64)) & 0xFFFFFFFF


def _sfnt(tables: dict, version: bytes = b"\x00\x01\x00\x00") -> bytes:
    """An sfnt file of ``tables`` (tag -> bytes), TrueType or, with
    ``version`` ``OTTO``, OpenType CFF: the directory
    sorted by tag, each table 4-byte aligned with its checksum, and
    ``head.checkSumAdjustment`` making the file's sum 0xB1B0AFBA."""
    tags = sorted(tables)
    n = len(tags)
    sel = n.bit_length() - 1
    out = [version + struct.pack(">HHHH", n, 16 << sel, sel, 16 * n - (16 << sel))]
    off = 12 + 16 * n
    body, head_at = [], 0
    for tag in tags:
        data = tables[tag]
        out.append(struct.pack(">4sIII", tag.encode("latin1"), _checksum(data), off, len(data)))
        if tag == "head":
            head_at = off
        body.append(data + b"\0" * (-len(data) % 4))
        off += len(body[-1])
    font = bytearray(b"".join(out + body))
    font[head_at + 8:head_at + 12] = struct.pack(">I", (0xB1B0AFBA - _checksum(bytes(font))) & 0xFFFFFFFF)
    return bytes(font)


def _coords(values, short: int, same: int) -> tuple[list, bytes]:
    """Per point the flag bits and the bytes of one coordinate axis,
    delta-coded: 0 is ``same``, |d| < 256 one byte (``short``, with
    ``same`` for a positive d), else a signed word."""
    flags, out, prev = [], bytearray(), 0
    for v in values:
        d, prev = v - prev, v
        if d == 0:
            flags.append(same)
        elif -255 <= d <= 255:
            flags.append(short | (same if d > 0 else 0))
            out.append(abs(d))
        else:
            flags.append(0)
            out += struct.pack(">h", d)
    return flags, bytes(out)


def _simple_glyph(contours) -> tuple[bytes, tuple, int]:
    """A glyf simple glyph of `curved_outlines` contours, the points a
    TrueType pen keeps for `_draw` (P_0, C_0, P_1, C_1, ...): (bytes
    padded to 4, bbox over every point, point count)."""
    pts, on, ends = [], [], []
    for ring_on, ring_off in contours:
        for p, c in zip(ring_on, ring_off):
            pts += [p, c]
            on += [1, 0]
        ends.append(len(pts) - 1)
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    bbox = (min(xs), min(ys), max(xs), max(ys))
    fx, bx = _coords(xs, 0x02, 0x10)
    fy, by = _coords(ys, 0x04, 0x20)
    data = (struct.pack(">hhhhh", len(ends), *bbox) + struct.pack(f">{len(ends)}H", *ends)
            + struct.pack(">H", 0) + bytes(o | a | b for o, a, b in zip(on, fx, fy)) + bx + by)
    return data + b"\0" * (-len(data) % 4), bbox, len(pts)


def _cmap_table(cmap: dict) -> bytes:
    """A cmap of (0, 3) and (3, 1) format 4 over the BMP codepoints,
    and (3, 10) format 12 over all when one lies above U+FFFF (the
    subtables fontTools' FontBuilder writes)."""
    items = sorted(cmap.items())

    def runs(pairs):  # [start, end, first gid] of consecutive cps and gids
        out = []
        for cp, gid in pairs:
            if out and cp == out[-1][1] + 1 and gid == out[-1][2] + cp - out[-1][0]:
                out[-1][1] = cp
            else:
                out.append([cp, cp, gid])
        return out

    segs = runs([(cp, g) for cp, g in items if cp < 0xFFFF]) + [[0xFFFF, 0xFFFF, 0]]
    n = len(segs)
    sel = n.bit_length() - 1
    fmt4 = struct.pack(">7H", 4, 16 + 8 * n, 0, 2 * n, 2 << sel, sel, 2 * n - (2 << sel))
    fmt4 += struct.pack(f">{n}H", *(e for _, e, _ in segs)) + b"\0\0"
    fmt4 += struct.pack(f">{n}H", *(s for s, _, _ in segs))
    fmt4 += struct.pack(f">{n}H", *((g - s) % 65536 if s != 0xFFFF else 1 for s, _, g in segs))
    fmt4 += b"\0\0" * n
    subtables = [((0, 3), fmt4), ((3, 1), fmt4)]
    if items and items[-1][0] > 0xFFFF:
        groups = runs(items)
        fmt12 = struct.pack(">HHIII", 12, 0, 16 + 12 * len(groups), 0, len(groups))
        fmt12 += b"".join(struct.pack(">III", *g) for g in groups)
        subtables.append(((3, 10), fmt12))
    head = struct.pack(">HH", 0, len(subtables))
    off, recs, body, at = 4 + 8 * len(subtables), [], [], {}
    for (pid, eid), data in subtables:
        if id(data) not in at:
            at[id(data)] = off
            body.append(data)
            off += len(data)
        recs.append(struct.pack(">HHI", pid, eid, at[id(data)]))
    return head + b"".join(recs) + b"".join(body)


def cmap_format2(subheaders, keys: dict, glyphs) -> bytes:
    """A cmap subtable of format 2: ``keys`` {high byte: subHeader
    index} (0 for the rest, whose bytes are single-byte codes through
    subHeader 0), ``subheaders`` [(firstCode, entryCount, idDelta, index
    of its first entry in ``glyphs``)], ``glyphs`` the glyphIndexArray."""
    n = len(subheaders)
    sh = b"".join(struct.pack(">HHhH", first, count, delta, 8 * (n - i) - 6 + 2 * at)
                  for i, (first, count, delta, at) in enumerate(subheaders))
    body = (struct.pack(">256H", *(8 * keys.get(b, 0) for b in range(256))) + sh
            + struct.pack(f">{len(glyphs)}H", *glyphs))
    return struct.pack(">HHH", 2, 6 + len(body), 0) + body


def cmap_format13(groups, length: int | None = None) -> bytes:
    """A cmap subtable of format 13: [(startCharCode, endCharCode,
    glyph id)], each range mapped to its one glyph; ``length`` overrides
    the declared length."""
    data = b"".join(struct.pack(">III", *g) for g in groups)
    n = 16 + len(data)
    return struct.pack(">HHIII", 13, 0, n if length is None else length, 0, len(groups)) + data


def with_cmap(font: bytes, records) -> bytes:
    """``font`` (an sfnt, not a collection) with its cmap replaced by
    one of ``records`` [(platformID, encodingID, subtable bytes)], the
    other tables as they are (checksums recomputed)."""
    from ..font.sfnt import Sfnt

    sf = Sfnt(font)
    tables = {tag: sf.table(tag) for tag in sf.tables if tag != "cmap"}
    head = struct.pack(">HH", 0, len(records))
    off, recs, body = 4 + 8 * len(records), b"", b""
    for pid, eid, data in records:
        recs += struct.pack(">HHI", pid, eid, off + len(body))
        body += data
    tables["cmap"] = head + recs + body
    return _sfnt(tables, font[:4])


def _name_table(strings: dict) -> bytes:
    """A name table of ``strings`` (name ID -> text) on platform 1
    (Mac Roman, English) and platform 3 (UTF-16BE, en-US)."""
    recs, data = [], b""
    for pid, eid, lid, codec in ((1, 0, 0, "mac_roman"), (3, 1, 0x409, "utf_16_be")):
        for nid in sorted(strings):
            raw = strings[nid].encode(codec)
            recs.append(struct.pack(">6H", pid, eid, lid, nid, len(raw), len(data)))
            data += raw
    return struct.pack(">HHH", 0, len(recs), 6 + 12 * len(recs)) + b"".join(recs) + data


def build_ttf_curved(
    n_glyphs: int,
    first_cp: int = 32,
    seed: int = 0,
    quads: int = 8,
    family: str = "Synth Curved",
    style: str = "Regular",
) -> bytes:
    """A TrueType font of `curved_outlines`, glyph k (glyph id k + 1
    after an empty .notdef) mapped from ``first_cp + k``, written by
    hand with numpy and struct: head, hhea, maxp 1.0, OS/2 4, hmtx
    (left side bearing = xMin), cmap, loca, glyf, name (IDs 1, 2, 4 and
    6 on platforms 1 and 3) and post 3 (no glyph names), with table
    checksums and ``checkSumAdjustment``; the values fontTools'
    FontBuilder computes for the same glyphs (timestamps `TIMESTAMP`)."""
    outlines = curved_outlines(n_glyphs, seed, quads)
    glyphs = [(b"", None, 0)] + [_simple_glyph(contours) for _, contours in outlines]
    metrics = [(600, 0)] + [(adv, g[1][0]) for (adv, _), g in zip(outlines, glyphs[1:])]
    loca = np.cumsum([0] + [len(g[0]) for g in glyphs])
    short = loca[-1] < 0x20000
    boxes = [g[1] for g in glyphs if g[1] is not None]
    x0, y0 = min(b[0] for b in boxes), min(b[1] for b in boxes)
    x1, y1 = max(b[2] for b in boxes), max(b[3] for b in boxes)
    n_h = len(metrics)  # trailing equal advances share the last metric
    while n_h > 1 and metrics[n_h - 2][0] == metrics[-1][0]:
        n_h -= 1
    inked = [(adv, lsb, g[1]) for (adv, lsb), g in zip(metrics, glyphs) if g[1] is not None]
    cmap = {first_cp + k: k + 1 for k in range(n_glyphs)}
    tables = {
        "head": struct.pack(">IIIIHHqqhhhhHHhhh", 0x00010000, 0x00010000, 0, 0x5F0F3CF5, 0x0003,
                            UPEM, TIMESTAMP, TIMESTAMP, x0, y0, x1, y1, 0, 3, 2,
                            0 if short else 1, 0),
        "hhea": struct.pack(">IhhhHhhhhhh4hhH", 0x00010000, ASCENT, DESCENT, 0,
                            max(a for a, _ in metrics), min(lsb for _, lsb, _ in inked),
                            min(a - lsb - (b[2] - b[0]) for a, lsb, b in inked),
                            max(lsb + b[2] - b[0] for _, lsb, b in inked),
                            1, 0, 0, 0, 0, 0, 0, 0, n_h),
        "maxp": struct.pack(">IHHHHHHHHHHHHHH", 0x00010000, len(glyphs),
                            max(g[2] for g in glyphs), max(len(c) for _, c in outlines),
                            0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0),
        "OS/2": struct.pack(">HhHHH11h10s4I4sHHHhhhHHIIhhHHH", 4,
                            round(sum(a for a, _ in metrics) / len(metrics)), 400, 5, 0,
                            650, 600, 0, 75, 650, 600, 0, 350, 50, 300, 0, bytes(10),
                            0, 0, 0, 0, b"NONE", 0x40, min(min(cmap), 0xFFFF),
                            min(max(cmap), 0xFFFF), ASCENT, DESCENT, 0, ASCENT, -DESCENT,
                            1, 0, 0, 0, 0, 32, 0),
        "hmtx": b"".join(struct.pack(">Hh", a, lsb) for a, lsb in metrics[:n_h])
        + b"".join(struct.pack(">h", lsb) for _, lsb in metrics[n_h:]),
        "cmap": _cmap_table(cmap),
        "loca": (loca // 2).astype(">u2").tobytes() if short else loca.astype(">u4").tobytes(),
        "glyf": b"".join(g[0] for g in glyphs),
        "name": _name_table({1: family, 2: style, 4: f"{family} {style}",
                             6: f"{family.replace(' ', '')}-{style.replace(' ', '')}"}),
        "post": struct.pack(">IIhhIIIII", 0x00030000, 0, 0, 0, 0, 0, 0, 0, 0),
    }
    return _sfnt(tables)


# -- CJK-scale outlines and the OTF writers -------------------------------------

# The two CJK blocks of `cjk_codepoints`: CJK Unified Ideographs Extension A
# and CJK Unified Ideographs, 108 blocks of 256 codepoints.
CJK_RANGES = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF))
CJK_ADVANCE = 1000
_N_SHAPES = 48  # strokes of the library: a third global subrs, the rest local
_T2_OPS = {"rlineto": (5,), "hlineto": (6,), "vlineto": (7,), "rrcurveto": (8,),
           "callsubr": (10,), "return": (11,), "endchar": (14,), "vsindex": (15,),
           "blend": (16,), "hstemhm": (18,), "hintmask": (19,), "rmoveto": (21,),
           "vstemhm": (23,), "rcurveline": (24,), "rlinecurve": (25,), "vvcurveto": (26,),
           "hhcurveto": (27,), "callgsubr": (29,), "vhcurveto": (30,), "hvcurveto": (31,),
           "flex": (12, 35)}


def cjk_codepoints(n_glyphs: int | None = None) -> list:
    """The codepoints of `CJK_RANGES` in order (27,584), or the first
    ``n_glyphs`` of them."""
    cps = [cp for a, b in CJK_RANGES for cp in range(a, b + 1)]
    return cps if n_glyphs is None else cps[:n_glyphs]


def _stroke_shape(seed: int, i: int):
    """Stroke ``i`` of the library: Type 2 path operators with integer
    operands drawing one closed contour from the current point, of six
    kinds in turn (a horizontal bar by hlineto, a vertical bar by
    vlineto, a sweep by rlinecurve and rrcurveto, a dot by hvcurveto and
    vhcurveto, a hook by hhcurveto, vvcurveto and rcurveline, and a
    flexed stroke by rlineto and flex), so that the library uses every
    path operator."""
    rng = np.random.default_rng([seed, 7919, i])

    def r(a, b):
        return int(rng.integers(a, b))

    t = i % 6
    if t == 0:
        length, th = r(200, 650), r(36, 64)
        return [("hlineto", [length, th, -length])]
    if t == 1:
        length, th = r(200, 600), r(40, 68)
        return [("vlineto", [-length, th, length])]
    if t == 2:
        w, h, d = r(40, 70), r(180, 480), r(60, 300)
        return [("rlinecurve", [w, 0, -d // 4, -h // 3, -d // 3, -h // 3, -d // 3, -h // 3]),
                ("rrcurveto", [-r(20, 40), r(5, 20), d // 3, h // 4, d // 3 + r(0, 20), h // 3])]
    if t == 3:
        a = r(30, 70)
        return [("hvcurveto", [a, a // 2, a, a]), ("vhcurveto", [a // 2, -a, a // 2, -a, -r(0, 9)])]
    if t == 4:
        w, h = r(140, 360), r(120, 300)
        return [("hhcurveto", [r(0, 15), w // 3, w // 3, -r(0, 25), w // 3]),
                ("vvcurveto", [r(0, 12), -h // 3, -r(20, 50), -h // 3, -h // 3]),
                ("rcurveline", [-r(10, 30), h // 4, -r(20, 40), h // 4, -r(10, 30), h // 4,
                                -w // 2, r(0, 30)])]
    w = r(260, 640)
    return [("rlineto", [0, r(40, 60)]),
            ("flex", [w // 6, r(8, 20), w // 6, r(5, 15), w // 6, r(0, 8), w // 6, -r(0, 8),
                      w // 6, -r(5, 15), w // 6, -r(8, 20), 50]),
            ("rlineto", [0, -r(40, 60), -(w // 6) * 6, 0])]


def _shape_segments(ops):
    """The absolute segments (from (0, 0)) of a stroke's operators, as
    fontTools' T2OutlineExtractor draws them: [("l", p) | ("c", p1, p2,
    p3)], and the end point (the current point after them)."""
    x = y = 0
    segs = []

    def line(dx, dy):
        nonlocal x, y
        x, y = x + dx, y + dy
        segs.append(("l", (x, y)))

    def curve(a, b, c, d, e, f):
        nonlocal x, y
        p1 = (x + a, y + b)
        p2 = (p1[0] + c, p1[1] + d)
        x, y = p2[0] + e, p2[1] + f
        segs.append(("c", p1, p2, (x, y)))

    for name, a in ops:
        if name in ("hlineto", "vlineto"):
            horiz = name == "hlineto"
            for v in a:
                line(v, 0) if horiz else line(0, v)
                horiz = not horiz
        elif name == "rlineto":
            for k in range(0, len(a), 2):
                line(a[k], a[k + 1])
        elif name == "rrcurveto":
            for k in range(0, len(a), 6):
                curve(*a[k:k + 6])
        elif name == "rlinecurve":
            for k in range(0, len(a) - 6, 2):
                line(a[k], a[k + 1])
            curve(*a[-6:])
        elif name == "rcurveline":
            for k in range(0, len(a) - 2, 6):
                curve(*a[k:k + 6])
            line(*a[-2:])
        elif name in ("hhcurveto", "vvcurveto"):
            d1, rest = (a[0], a[1:]) if len(a) % 2 else (0, a)
            for k in range(0, len(rest), 4):
                p, q, s, t = rest[k:k + 4]
                curve(p, d1, q, s, t, 0) if name == "hhcurveto" else curve(d1, p, q, s, 0, t)
                d1 = 0
        elif name in ("hvcurveto", "vhcurveto"):
            horiz, k = name == "hvcurveto", 0
            while k < len(a):
                last = len(a) - k == 5
                e = a[k + 4] if last else 0
                if horiz:
                    curve(a[k], 0, a[k + 1], a[k + 2], e, a[k + 3])
                else:
                    curve(0, a[k], a[k + 1], a[k + 2], a[k + 3], e)
                k += 5 if last else 4
                horiz = not horiz
        elif name == "flex":
            curve(*a[0:6])
            curve(*a[6:12])
    return segs, (x, y)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 arrays (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _cjk_layouts(n_glyphs: int, seed: int):
    """Every glyph's advance and strokes at once, each glyph a function
    of ``(seed, glyph index)`` alone (a counter hash): 6-16 strokes of
    (library index, start x, start y), and 32 small deltas for the CFF2
    twin's blends. Returns (advances [n], counts [n], shapes, xs, ys
    [n, 16], deltas [n, 32])."""
    k = np.arange(n_glyphs, dtype=np.uint64)[:, None]
    j = np.arange(81, dtype=np.uint64)[None, :]
    h = _mix64(_mix64(np.uint64(seed * 0x9E3779B97F4A7C15 % (1 << 64)) + k)
               + j * np.uint64(0xD1B54A32D192ED03))
    counts = (6 + h[:, 0] % np.uint64(11)).astype(np.int64)
    shapes = (h[:, 1:17] % np.uint64(_N_SHAPES)).astype(np.int64)
    xs = (60 + h[:, 17:33] % np.uint64(580)).astype(np.int64)
    ys = (80 + h[:, 33:49] % np.uint64(640)).astype(np.int64)
    deltas = (1 + h[:, 49:81] % np.uint64(9)).astype(np.int64) * np.where(
        h[:, 49:81] & np.uint64(16), 1, -1)
    kk = np.arange(n_glyphs)
    advances = np.where(kk % 7 == 0, CJK_ADVANCE - 20 * (1 + kk % 5), CJK_ADVANCE)
    return advances, counts, shapes, xs, ys, deltas


def cjk_outlines(n_glyphs: int, seed: int = 0):
    """Per glyph ``(advance, contours)`` of CJK-like ideographs: 6-16
    stroke contours of lines and integer cubics, each ``(start,
    segments)`` with segments ``("l", p)`` or ``("c", p1, p2, p3)`` in
    absolute font units (the contour closes back to its start).
    Deterministic in ``(seed, glyph index)``; what `build_otf_curved` and
    `build_otf2_curved` write and what fontTools draws from them."""
    shapes = [_shape_segments(_stroke_shape(seed, i))[0] for i in range(_N_SHAPES)]
    advances, counts, sh, xs, ys, _ = _cjk_layouts(n_glyphs, seed)
    out = []
    for k in range(n_glyphs):
        contours = []
        for s in range(counts[k]):
            x0, y0 = int(xs[k, s]), int(ys[k, s])
            segs = [(seg[0], *[(px + x0, py + y0) for px, py in seg[1:]])
                    for seg in shapes[sh[k, s]]]
            contours.append(((x0, y0), segs))
        out.append((int(advances[k]), contours))
    return out


def _t2_int(v: int) -> bytes:
    """A Type 2 charstring integer operand."""
    if -107 <= v <= 107:
        return bytes((v + 139,))
    if 108 <= v <= 1131:
        v -= 108
        return bytes(((v >> 8) + 247, v & 0xFF))
    if -1131 <= v <= -108:
        v = -v - 108
        return bytes(((v >> 8) + 251, v & 0xFF))
    return b"\x1c" + struct.pack(">h", v)


_T2_SMALL = [_t2_int(v) for v in range(-1131, 1132)]


def _t2_enc(v: int) -> bytes:
    return _T2_SMALL[v + 1131] if -1131 <= v <= 1131 else _t2_int(v)


def _t2(*items) -> bytes:
    """Operands (int) and operators (str) as charstring bytes; a bytes
    item passes through (hintmask bits)."""
    out = bytearray()
    for it in items:
        if isinstance(it, str):
            out += bytes(_T2_OPS[it])
        elif isinstance(it, bytes):
            out += it
        else:
            out += _t2_enc(int(it))
    return bytes(out)


def _dict_int(v: int) -> bytes:
    """A DICT integer operand in its 5-byte form, so that offsets can be
    laid out before they are known."""
    return b"\x1d" + struct.pack(">i", v)


def _index(items, cff2: bool = False) -> bytes:
    """A CFF INDEX (a CFF2 one has a 32-bit count)."""
    count = struct.pack(">I" if cff2 else ">H", len(items))
    if not items:
        return count
    offs = np.cumsum([1] + [len(x) for x in items])
    size = 1 if offs[-1] < 0x100 else 2 if offs[-1] < 0x10000 else 3 if offs[-1] < 0x1000000 else 4
    raw = offs.astype(">u4").view(np.uint8).reshape(-1, 4)[:, 4 - size:].tobytes()
    return count + bytes((size,)) + raw + b"".join(items)


# Private DICT values of the writers (FontBuilder's defaults are 0).
_DEFAULT_WIDTH, _NOMINAL_WIDTH = CJK_ADVANCE, 960
_N_FDS = 5
# CFF2: two regions on one axis; ItemVariationData 0 uses one, 1 both.
_VAR_REGIONS = ((0, 16384, 16384), (-16384, -16384, 0))
_VAR_DATA = ((0,), (0, 1))
_FD_VSINDEX = (0, 0, 0, 1, 0)  # the Private DICT's vsindex of each FD


def _charstrings(n_glyphs: int, seed: int, cff2: bool, fd_of):
    """Glyph charstrings, global subrs and per-FD local subrs of
    `cjk_outlines`. Each glyph: its width (CFF, where it is not
    defaultWidthX), two hstemhm and two vstemhm hints, a hintmask, then
    per stroke an rmoveto to its start and its operators, from a subr
    (a third of the library global, the rest local to every FD) or
    inline (one stroke in four), a second hintmask halfway in every
    other glyph, and endchar (CFF). The CFF2 twin drops width and
    endchar and subrs' return, passes the rmoveto operands of every
    third stroke and the first operands of the local subrs through blend
    (defaults equal to the CFF values, nonzero deltas, one per region of
    the glyph's vsindex), and gives glyphs 5, 10, ... of FD 0 an explicit
    ``1 vsindex`` (those draw their local strokes inline: the local
    subrs' blends are made for their FD's vsindex)."""
    shapes = [_stroke_shape(seed, i) for i in range(_N_SHAPES)]
    ends = [_shape_segments(ops)[1] for ops in shapes]
    is_global = [i % 3 == 0 for i in range(_N_SHAPES)]
    gidx = {i: j for j, i in enumerate(i for i in range(_N_SHAPES) if is_global[i])}
    lidx = {i: j for j, i in enumerate(i for i in range(_N_SHAPES) if not is_global[i])}
    gbias = 107 if len(gidx) < 1240 else 1131
    lbias = 107 if len(lidx) < 1240 else 1131

    def body(ops, blend_k=0):
        out = []
        for j, (name, args) in enumerate(ops):
            out += list(args)
            if blend_k and j == 0:
                out += [1 + (3 * q + j) % 7 for q in range(len(args) * blend_k)] + [len(args), "blend"]
            out.append(name)
        return out

    tail = [] if cff2 else ["return"]
    gsubrs = [_t2(*body(ops), *tail) for i, ops in enumerate(shapes) if is_global[i]]
    lsubrs = []
    for fd in range(_N_FDS):
        k = len(_VAR_DATA[_FD_VSINDEX[fd]]) if cff2 else 0
        lsubrs.append([_t2(*body(ops, k), *tail) for i, ops in enumerate(shapes) if not is_global[i]])
    inline = [_t2(*body(ops)) for ops in shapes]
    call = [_t2(gidx[i] - gbias, "callgsubr") if is_global[i] else _t2(lidx[i] - lbias, "callsubr")
            for i in range(_N_SHAPES)]
    hints = _t2(-20, 60, 560, 50, "hstemhm", 120, 70, 500, 80, "vstemhm", "hintmask", b"\xf0")
    mask2, rmove, blend = _t2("hintmask", b"\xa0"), _t2("rmoveto"), _t2(2, "blend", "rmoveto")
    enc = _t2_enc
    advances, counts, shp, xs, ys, deltas = _cjk_layouts(n_glyphs, seed)
    shp, xs, ys, deltas = shp.tolist(), xs.tolist(), ys.tolist(), deltas.tolist()
    charstrings = [_t2() if cff2 else _t2("endchar")]  # .notdef
    for k in range(n_glyphs):
        fd = fd_of(k + 1)
        explicit_vs = cff2 and fd == 0 and k % 5 == 0
        nreg = len(_VAR_DATA[1 if explicit_vs else _FD_VSINDEX[fd]])
        parts = []
        if explicit_vs:
            parts.append(_t2(1, "vsindex"))
        if not cff2 and advances[k] != _DEFAULT_WIDTH:
            parts.append(enc(int(advances[k]) - _NOMINAL_WIDTH))
        parts.append(hints)
        x = y = 0
        n = int(counts[k])
        for s in range(n):
            sh, x0, y0 = shp[k][s], xs[k][s], ys[k][s]
            if k % 2 == 0 and s == n // 2:
                parts.append(mask2)
            parts += [enc(x0 - x), enc(y0 - y)]
            if cff2 and s % 3 == 1:
                d0 = (2 * s) % 28
                parts += [enc(d) for d in deltas[k][d0:d0 + 2 * nreg]]
                parts.append(blend)
            else:
                parts.append(rmove)
            use_inline = (k + s) % 4 == 0 or (explicit_vs and not is_global[sh])
            parts.append(inline[sh] if use_inline else call[sh])
            x, y = x0 + ends[sh][0], y0 + ends[sh][1]
        if not cff2:
            parts.append(b"\x0e")
        charstrings.append(b"".join(parts))
    return charstrings, gsubrs, lsubrs


def _cid_fd(gid: int) -> int:
    """FD of a glyph id of the CID-keyed fonts: .notdef FD 0, then FD
    (block of 256 glyphs mod `_N_FDS`), ranges of whole blocks."""
    return 0 if gid == 0 else ((gid - 1) // 256) % _N_FDS


def _fdselect(n: int, fd_of, fmt: int) -> bytes:
    """FDSelect of ``n`` glyphs in format 0, 3 or 4."""
    fds = [fd_of(g) for g in range(n)]
    if fmt == 0:
        return bytes((0,)) + bytes(fds)
    ranges = [(g, fds[g]) for g in range(n) if g == 0 or fds[g] != fds[g - 1]]
    if fmt == 3:
        return (struct.pack(">BH", 3, len(ranges)) + b"".join(struct.pack(">HB", g, f) for g, f in ranges)
                + struct.pack(">H", n))
    return (struct.pack(">BI", 4, len(ranges)) + b"".join(struct.pack(">IH", g, f) for g, f in ranges)
            + struct.pack(">I", n))


def _private(cff2: bool, fd: int, n_subrs: int) -> bytes:
    """A Private DICT (size fixed by its 5-byte operands) whose local
    subrs follow it: CFF widths, or CFF2 BlueValues through blend
    (after the FD's vsindex where it is not 0)."""
    body = b""
    if cff2:
        vs = _FD_VSINDEX[fd]
        if vs:
            body += _dict_int(vs) + b"\x16"
        k = len(_VAR_DATA[vs])
        blues = [-12, 12, 500, 12]
        body += b"".join(_dict_int(v) for v in blues) + b"".join(
            _dict_int(2 + j) for j in range(4 * k)) + _dict_int(4) + b"\x17\x06"
    else:
        body += _dict_int(_DEFAULT_WIDTH) + b"\x14" + _dict_int(_NOMINAL_WIDTH) + b"\x15"
    if n_subrs:
        body += _dict_int(len(body) + 6) + b"\x13"
    return body


def _cjk_boxes(n_glyphs: int, seed: int):
    """(advances [n], boxes [n, 4]: x0, y0, x1, y1 over every point of a
    glyph's contours, control points included) of `cjk_outlines`."""
    sb = []
    for i in range(_N_SHAPES):
        pts = [(0, 0)] + [p for seg in _shape_segments(_stroke_shape(seed, i))[0] for p in seg[1:]]
        sb.append((min(x for x, _ in pts), min(y for _, y in pts),
                   max(x for x, _ in pts), max(y for _, y in pts)))
    sb = np.array(sb, np.int64)
    advances, counts, shp, xs, ys, _ = _cjk_layouts(n_glyphs, seed)
    live = np.arange(16)[None, :] < counts[:, None]
    big = np.int64(1 << 40)
    boxes = np.stack([np.where(live, xs + sb[shp, 0], big).min(1),
                      np.where(live, ys + sb[shp, 1], big).min(1),
                      np.where(live, xs + sb[shp, 2], -big).max(1),
                      np.where(live, ys + sb[shp, 3], -big).max(1)], axis=1)
    return advances.tolist(), boxes.tolist()


def _otf_tables(cff_tag: str, cff: bytes, advances, boxes, cmap: dict, family: str,
                style: str) -> dict:
    """The tables of an OTF around its CFF or CFF2 table: head, hhea,
    maxp 0.5, OS/2 4, hmtx (left side bearing = xMin over every point),
    cmap, name and post 3."""
    metrics = [(_DEFAULT_WIDTH, 0)] + [(adv, b[0]) for adv, b in zip(advances, boxes)]
    x0, y0 = min(b[0] for b in boxes), min(b[1] for b in boxes)
    x1, y1 = max(b[2] for b in boxes), max(b[3] for b in boxes)
    n_h = len(metrics)
    while n_h > 1 and metrics[n_h - 2][0] == metrics[-1][0]:
        n_h -= 1
    ink = [(adv, lsb, b) for (adv, lsb), b in zip(metrics[1:], boxes)]
    return {
        cff_tag: cff,
        "head": struct.pack(">IIIIHHqqhhhhHHhhh", 0x00010000, 0x00010000, 0, 0x5F0F3CF5, 0x0003,
                            UPEM, TIMESTAMP, TIMESTAMP, x0, y0, x1, y1, 0, 3, 2, 0, 0),
        "hhea": struct.pack(">IhhhHhhhhhh4hhH", 0x00010000, ASCENT, DESCENT, 0,
                            max(a for a, _ in metrics), min(lsb for _, lsb, _ in ink),
                            min(a - lsb - (b[2] - b[0]) for a, lsb, b in ink),
                            max(lsb + b[2] - b[0] for _, lsb, b in ink), 1, 0, 0, 0, 0, 0, 0, 0, n_h),
        "maxp": struct.pack(">IH", 0x00005000, len(metrics)),
        "OS/2": struct.pack(">HhHHH11h10s4I4sHHHhhhHHIIhhHHH", 4,
                            round(sum(a for a, _ in metrics) / len(metrics)), 400, 5, 0,
                            650, 600, 0, 75, 650, 600, 0, 350, 50, 300, 0, bytes(10),
                            0, 0, 0, 0, b"NONE", 0x40, min(min(cmap), 0xFFFF),
                            min(max(cmap), 0xFFFF), ASCENT, DESCENT, 0, ASCENT, -DESCENT,
                            1, 0, 0, 0, 0, 32, 0),
        "hmtx": b"".join(struct.pack(">Hh", a, lsb) for a, lsb in metrics[:n_h])
        + b"".join(struct.pack(">h", lsb) for _, lsb in metrics[n_h:]),
        "cmap": _cmap_table(cmap),
        "name": _name_table({1: family, 2: style, 4: f"{family} {style}",
                             6: f"{family.replace(' ', '')}-{style.replace(' ', '')}"}),
        "post": struct.pack(">IIhhIIIII", 0x00030000, 0, 0, 0, 0, 0, 0, 0, 0),
    }


def build_otf_curved(n_glyphs: int, seed: int = 0, cid: bool = True, first_cp: int | None = None,
                     family: str = "Synth Ideo", style: str = "Regular") -> bytes:
    """An OpenType font with a 'CFF ' table of `cjk_outlines`, glyph k
    (glyph id k + 1 after an empty .notdef) mapped from
    ``cjk_codepoints()[k]`` (or ``first_cp + k``), written with numpy and
    struct: CID-keyed (ROS Adobe-Identity-0, CIDs equal to glyph ids, an
    FDArray of `_N_FDS` FDs with their own local subrs, FDSelect format
    3), or name-keyed (glyph names ``g<k>``, one Private DICT); global
    subrs, hints and every path operator (`_charstrings`)."""
    n = n_glyphs + 1
    fd_of = _cid_fd if cid else (lambda gid: 0)
    charstrings, gsubrs, lsubrs = _charstrings(n_glyphs, seed, False, fd_of)
    ps = f"{family.replace(' ', '')}-{style.replace(' ', '')}"
    strings = [b"Adobe", b"Identity"] if cid else [f"g{k}".encode() for k in range(n_glyphs)]
    if cid:
        charset = struct.pack(">BHH", 2, 1, n - 2)
        fdselect = _fdselect(n, fd_of, 3)
    else:
        charset = b"\0" + b"".join(struct.pack(">H", 391 + k) for k in range(n_glyphs))
        fdselect = b""
    n_fds = _N_FDS if cid else 1
    privs = [_private(False, fd, len(lsubrs[fd])) for fd in range(n_fds)]

    # The Top DICT's size does not depend on the offsets (5-byte operands).
    def top(cs_off, charset_off, fda_off, fds_off, priv):
        d = b""
        if cid:
            d += _dict_int(391) + _dict_int(392) + _dict_int(0) + b"\x0c\x1e"
            d += _dict_int(n) + b"\x0c\x22"
        d += _dict_int(charset_off) + b"\x0f" + _dict_int(cs_off) + b"\x11"
        if cid:
            d += _dict_int(fda_off) + b"\x0c\x24" + _dict_int(fds_off) + b"\x0c\x25"
        else:
            d += _dict_int(priv[0]) + _dict_int(priv[1]) + b"\x12"
        return d

    head = bytes((1, 0, 4, 4))
    name_idx = _index([ps.encode()])
    top_len = len(_index([top(0, 0, 0, 0, (0, 0))]))
    rest = _index(strings) + _index(gsubrs)
    at = len(head) + len(name_idx) + top_len + len(rest)
    charset_off = at
    at += len(charset)
    fds_off = at
    at += len(fdselect)
    cs_idx = _index(charstrings)
    cs_off = at
    at += len(cs_idx)
    blobs, priv_at = [], []
    fda_len = len(_index([_dict_int(0) + _dict_int(0) + b"\x12"] * n_fds)) if cid else 0
    fda_off = at
    at += fda_len
    for fd in range(n_fds):
        priv_at.append((len(privs[fd]), at))
        blob = privs[fd] + (_index(lsubrs[fd]) if lsubrs[fd] else b"")
        blobs.append(blob)
        at += len(blob)
    fda = _index([_dict_int(s) + _dict_int(o) + b"\x12" for s, o in priv_at]) if cid else b""
    top_idx = _index([top(cs_off, charset_off, fda_off, fds_off, priv_at[0])])
    assert len(top_idx) == top_len and len(fda) == fda_len
    cff = head + name_idx + top_idx + rest + charset + fdselect + cs_idx + fda + b"".join(blobs)
    cps = cjk_codepoints(n_glyphs) if first_cp is None else list(range(first_cp, first_cp + n_glyphs))
    cmap = {cp: k + 1 for k, cp in enumerate(cps)}
    return _sfnt(_otf_tables("CFF ", cff, *_cjk_boxes(n_glyphs, seed), cmap, family, style), b"OTTO")


def build_otf2_curved(n_glyphs: int, seed: int = 0, first_cp: int | None = None,
                      fdselect_format: int = 3, family: str = "Synth Ideo",
                      style: str = "Regular") -> bytes:
    """The CFF2 twin of `build_otf_curved` (CID-keyed): the same
    outlines, FDs and subrs, the charstrings without width and endchar,
    some operands through blend (`_charstrings`), a VariationStore of
    two regions on one axis (ItemVariationData 0 of one region, 1 of
    both; the Private DICT of FD 3 says vsindex 1, some glyphs do), and
    an FDSelect of ``fdselect_format`` 0, 3 or 4. Drawn at its default
    instance it is the CFF font's outline for outline."""
    n = n_glyphs + 1
    fd_of = _cid_fd
    charstrings, gsubrs, lsubrs = _charstrings(n_glyphs, seed, True, fd_of)
    regions = struct.pack(">HH", 1, len(_VAR_REGIONS)) + b"".join(
        struct.pack(">hhh", *r) for r in _VAR_REGIONS)
    datas = [struct.pack(">HHH", 0, 0, len(d)) + struct.pack(f">{len(d)}H", *d) for d in _VAR_DATA]
    ivs_head = 8 + 4 * len(datas)
    offs, at = [], ivs_head + len(regions)
    for d in datas:
        offs.append(at)
        at += len(d)
    ivs = (struct.pack(">HIH", 1, ivs_head, len(datas)) + struct.pack(f">{len(datas)}I", *offs)
           + regions + b"".join(datas))
    vstore = struct.pack(">H", len(ivs)) + ivs
    fdselect = _fdselect(n, fd_of, fdselect_format)
    privs = [_private(True, fd, len(lsubrs[fd])) for fd in range(_N_FDS)]

    def top(cs_off, fda_off, fds_off, vs_off):
        return (_dict_int(cs_off) + b"\x11" + _dict_int(fda_off) + b"\x0c\x24"
                + _dict_int(fds_off) + b"\x0c\x25" + _dict_int(vs_off) + b"\x18")

    top_len = len(top(0, 0, 0, 0))
    gs_idx = _index(gsubrs, cff2=True)
    at = 5 + top_len + len(gs_idx)
    vs_off = at
    at += len(vstore)
    fds_off = at
    at += len(fdselect)
    cs_idx = _index(charstrings, cff2=True)
    cs_off = at
    at += len(cs_idx)
    fda_len = len(_index([_dict_int(0) + _dict_int(0) + b"\x12"] * _N_FDS, cff2=True))
    fda_off = at
    at += fda_len
    blobs, priv_at = [], []
    for fd in range(_N_FDS):
        priv_at.append((len(privs[fd]), at))
        blob = privs[fd] + (_index(lsubrs[fd], cff2=True) if lsubrs[fd] else b"")
        blobs.append(blob)
        at += len(blob)
    fda = _index([_dict_int(s) + _dict_int(o) + b"\x12" for s, o in priv_at], cff2=True)
    cff2 = (struct.pack(">BBBH", 2, 0, 5, top_len) + top(cs_off, fda_off, fds_off, vs_off) + gs_idx
            + vstore + fdselect + cs_idx + fda + b"".join(blobs))
    cps = cjk_codepoints(n_glyphs) if first_cp is None else list(range(first_cp, first_cp + n_glyphs))
    cmap = {cp: k + 1 for k, cp in enumerate(cps)}
    return _sfnt(_otf_tables("CFF2", cff2, *_cjk_boxes(n_glyphs, seed), cmap, family, style), b"OTTO")


def _contour_curves(on, off):
    """The cubics [C, 4, 2] (font units, float64) that
    `font.entry.FontFileEntry.outline_curves` gives for one contour
    of `_draw`: each quadratic degree-elevated by 2/3, and a closing line
    (a collinear cubic) where the contour does not end at its start."""
    n = len(on)
    curves = []
    start = cur = on[0]
    for j in range(n):
        (sx, sy), (cx, cy), (ex, ey) = cur, off[j], on[(j + 1) % n]
        curves.append(((sx, sy),
                       (sx + 2.0 / 3.0 * (cx - sx), sy + 2.0 / 3.0 * (cy - sy)),
                       (ex + 2.0 / 3.0 * (cx - ex), ey + 2.0 / 3.0 * (cy - ey)),
                       (ex, ey)))
        cur = (ex, ey)
    if cur != start:
        (sx, sy), (ex, ey) = cur, start
        curves.append(((sx, sy),
                       (sx + (ex - sx) / 3.0, sy + (ey - sy) / 3.0),
                       (sx + 2.0 * (ex - sx) / 3.0, sy + 2.0 * (ey - sy) / 3.0),
                       (ex, ey)))
    return curves


def synth_fit_batch(
    n_glyphs: int,
    first_cp: int = 32,
    seed: int = 0,
    quads: int = 8,
    depth: int = 3,
    perturb: float = 0.0,
):
    """A `models.fitting.FitBatch` of `curved_outlines`, without a font
    file: what `models.fitting.make_fit_batch` gives for the font
    `build_ttf_curved` of the same arguments (a self-fit). Curves follow
    the rules of `font.pens` CurvePen, scaled by 24/UPEM and shifted by
    ``prep.dx``; targets are exact SDFs of the `curved_preps` outlines
    (the native f64 renderer where it is built, else
    `ops.sdf_ref.render_sdf_exact`; the two agree byte for byte).
    ``perturb`` > 0 adds seeded normal noise of that scale (pixels) to
    the live control points of the start. ``depth`` is the caller's
    fitting depth: the batch itself does not depend on it."""
    from ..ops.sdf_ref import render_sdf_exact
    from ..proto import native

    from ..models.fitting import assemble_fit_batch, fit_item

    del depth
    preps = curved_preps(n_glyphs, first_cp, seed, quads)
    if native.available():
        bitmaps = native.render_sdf_batch(preps)
    else:
        bitmaps = [render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0) for p in preps]
    items = []
    for (_, contours), prep, bitmap in zip(curved_outlines(n_glyphs, seed, quads), preps, bitmaps):
        curves = np.asarray(
            [c for on, off in contours for c in _contour_curves(on, off)], np.float64
        )
        curves = curves * (24.0 / UPEM) + np.array([prep.dx, 0.0])
        items.append(fit_item(prep.codepoint, curves, prep, bitmap))
    batch = assemble_fit_batch(items)
    if perturb > 0:
        rng = np.random.default_rng(seed)
        noise = rng.normal(0.0, perturb, batch.curves0.shape).astype(np.float32)
        batch.curves0 = batch.curves0 + noise * batch.curve_mask[:, :, None, None]
    return batch


class _SynthMetadata:
    """The metadata fields `font.index_files` reads, as
    `font.entry.FontMetadata` parses them from `build_ttf_curved`."""

    def __init__(self, codepoints):
        from ..font.names import parse_font_name

        self.name = "Synth Curved"
        self.family, self.style, self.weight, self.width = parse_font_name(
            "Synth Curved", "SynthCurved-Regular"
        )
        self.codepoints = list(codepoints)

    def generate_name(self) -> str:
        from ..font.names import generate_name

        return generate_name(self.family, self.style, self.weight, self.width)


class SynthEntry:
    """The part of `font.entry.FontFileEntry` that
    `models.render_fitted.fitted_preps`, `render_fitted_pbfs`, the
    manager (`font.wrapper.FontWrapper`, `font.manager.FontManager`) and
    `render.driver.Renderer.prep_glyph` / `prep_block` read (glyph keys,
    outlines as flattened rings, advances, units per EM, metadata), for
    the font `build_ttf_curved(n_glyphs, first_cp, seed, quads)`, without
    a file. Its keys are the font's glyph ids (glyph k is id k + 1). It
    has no table of prep cores, so the renderer preps each glyph from
    its rings: the preps of `curved_preps`."""

    units_per_em = UPEM
    prep_cores = None

    def __init__(self, n_glyphs: int, first_cp: int = 32, seed: int = 0, quads: int = 8):
        self.first_cp = first_cp
        self._outlines = curved_outlines(n_glyphs, seed, quads)
        self.metadata = _SynthMetadata(range(first_cp, first_cp + n_glyphs))

    def glyph_key(self, codepoint: int):
        k = codepoint - self.first_cp
        return k + 1 if 0 <= k < len(self._outlines) else None

    def hor_advance(self, gid: int) -> int:
        return self._outlines[gid - 1][0]

    def outline_rings(self, gid: int):
        """Flattened closed rings (font units, float64), as
        `curved_preps` flattens them."""
        acc = RingAccumulator()
        _draw(self._outlines[gid - 1][1], acc.move_to, acc.quad_to, acc.close_path)
        return acc.finish()


def _ring_prep(cp: int, w: int, h: int, ring):
    from ..render.metrics import GlyphPrep

    return GlyphPrep(codepoint=cp, advance=w, empty=False, width=w, height=h, x0=0, y0=0,
                     x1=w, y1=h, rings_px=[np.array(ring, dtype=np.float64)])


def row_list_edge_preps():
    """Three glyphs at the edges of the render kernels' crossing lists
    (``csrc/sdf_pair.cuh``, RowLists): a bitmap 3 pixels wide, so that
    256 pixels span 86 bitmap rows (more than a block lists); a comb
    whose rows cross 48 segments (more than a row lists); and a bitmap
    of 63 pixels, under one pixel tile of 64."""
    narrow = _ring_prep(70, 3, 90, [(0.5, 1.0), (2.5, 1.0), (2.5, 88.25), (0.5, 88.25), (0.5, 1.0)])
    teeth = [(2.0 + k, 28.5 if k % 2 else 2.25) for k in range(49)]
    comb = _ring_prep(71, 52, 30, [(2.0, 1.0), *teeth, (50.0, 1.0), (2.0, 1.0)])
    tiny = _ring_prep(72, 9, 7, [(1.0, 1.0), (7.5, 1.5), (4.0, 5.5), (1.0, 1.0)])
    return [narrow, comb, tiny]


def unaligned_point_chain():
    """A hand-made point chain (pts [2, 512] f32, mask words [16] i32,
    tile table [8, 6] i32 at 256 pixels a tile) for the render tile
    kernel's staging: a glyph whose lane run starts at lane 37, off a
    multiple of 32, with two rings (dead lanes 56 and 86 inside the
    run) over two tiles; a glyph whose lanes are all dead (bytes 0); a
    row with npts = 1 and one with npts = 0; and a row past w·h."""
    N = 512
    pts = np.zeros((2, N), np.float32)
    bits = np.zeros(N, bool)
    ang = np.linspace(0.0, 2 * np.pi, 20)[:-1]
    outer = np.stack([10 + 7.5 * np.cos(ang), 10 + 6.25 * np.sin(ang)], 1)
    outer = np.concatenate([outer, outer[:1]])  # 20 points, lanes 37..56
    ang = np.linspace(0.0, -2 * np.pi, 30)[:-1]
    inner = np.stack([10 + 3.5 * np.cos(ang), 10 + 2.75 * np.sin(ang)], 1)
    inner = np.concatenate([inner, inner[:1]])  # 30 points, lanes 57..86
    pts[:, 37:57] = outer.T
    pts[:, 57:87] = inner.T
    bits[37:56] = bits[57:86] = True
    pts[:, 100:110] = np.array([[2.0, 8, 8, 2, 2, 3, 4, 5, 6, 7], [2.0, 2, 8, 8, 2, 3, 4, 5, 6, 7]])
    pts[:, 120] = 4.0
    words = np.packbits(bits, bitorder="little").view(np.int32)
    tmeta = np.array([
        # x0, y0, w, h, npts, off, pix_base, _
        [0, 0, 20, 20, 50, 37, 0, 0], [0, 0, 20, 20, 50, 37, 256, 0],
        [0, 0, 10, 10, 10, 100, 0, 0], [0, 0, 8, 8, 1, 120, 0, 0], [0, 0, 8, 8, 0, 130, 0, 0],
        [0, 0, 20, 20, 50, 37, 512, 0],
    ], np.int32).T
    return pts, words, np.ascontiguousarray(tmeta)


def tied_point_chain():
    """A hand-made point chain (pts [2, 512] f32, mask words [16] i32,
    tile table [8, 2] i32 at 256 pixels a tile) for the min-field tile
    kernel's first argmin: one glyph of 400 points from lane 5, two
    staged chunks of lanes, four live segments, of which lanes 8 and 308
    are the same segment (the tie goes to 8, across the chunks and the
    dead lanes between)."""
    pts = np.zeros((2, 512), np.float32)
    bits = np.zeros(512, bool)
    for lane, (v, w) in {8: ((2.0, 2.0), (12.0, 15.0)), 308: ((2.0, 2.0), (12.0, 15.0)),
                         105: ((-2.0, 19.0), (0.0, 19.5)), 403: ((15.0, -2.0), (15.5, 0.0))}.items():
        pts[:, lane], pts[:, lane + 1] = v, w
        bits[lane] = True
    words = np.packbits(bits, bitorder="little").view(np.int32)
    tmeta = np.array([[-3, -3, 19, 23, 400, 5, 0, 0], [-3, -3, 19, 23, 400, 5, 256, 0]], np.int32).T
    return pts, words, np.ascontiguousarray(tmeta)


PADDED_EDGE_CASES = ("holes", "narrow", "comb", "chunks", "degenerate")
# The padded backward's: those, a glyph whose every pixel has one argmin
# segment, and a glyph of more pixels than one warp walks.
PADDED_BWD_EDGE_CASES = PADDED_EDGE_CASES + ("one_wins", "large")


def padded_edge_case(name: str):
    """An input at an edge of the padded min-field kernel
    (``csrc/sdf_min_field_padded.cu``), from a numpy seed: (segs
    [B, S, 4] f32, mask [B, S] f32, meta [B, 4] i32, P).

    ``holes``: masks with holes in the middle, so a staged segment's
    slot is not its index, and P = 437, a multiple of no block size.
    ``narrow``: a bitmap 5 pixels wide at P = 768, so that a span of
    384 pixels holds 77 bitmap rows, more than a block lists. ``comb``: glyph 0
    crosses every row 48 times, more than a row lists. ``chunks``: 300
    segments, more than a staged chunk; glyph 1 has four live ones, of
    which 3 and 260 are the same segment (the tie goes to 3).
    ``degenerate``: zero-length and horizontal segments, negative
    origins, and a glyph with every segment masked (the sentinel).
    ``one_wins``: glyph 0 has one live segment, so it wins every pixel.
    ``large``: 4,096 pixels a glyph, more than one warp of the padded
    backward kernel walks."""
    if name == "degenerate":
        segs = np.zeros((3, 8, 4), np.float32)
        segs[0, :6] = [[3, 4, 7, 4], [2, 2, 6, 2], [6, 2, 6, 6], [6, 6, 2, 6], [2, 6, 2, 2],
                       [4.5, 4.5, 4.5, 4.5]]
        segs[1, :3] = [[1, 1, 1, 1], [1, 1, 7, 1], [7, 1, 4, 5]]
        segs[2, :2] = [[0, 0, 5, 5], [5, 5, 0, 0]]  # masked below
        mask = np.zeros((3, 8), np.float32)
        mask[0, :6] = 1.0
        mask[1, :3] = 1.0
        return segs, mask, np.array([[0, 0, 10, 9], [-2, -1, 12, 6], [0, 0, 17, 17]], np.int32), 300
    seed, B, S, box, P = {
        "holes": (7, 4, 70, (-3, -3, 19, 23), 19 * 23),
        "narrow": (8, 2, 40, (0, 0, 5, 64), 768),
        "comb": (9, 2, 48, (0, 0, 16, 10), 160),
        "chunks": (10, 2, 300, (-3, -3, 19, 23), 19 * 23),
        "one_wins": (11, 2, 24, (-2, -2, 17, 17), 300),
        "large": (12, 3, 40, (0, 0, 64, 64), 4096),
    }[name]
    rng = np.random.default_rng(seed)
    x0, y0, w, h = box
    lo, hi = np.array([x0 - 1, y0 - 1] * 2), np.array([x0 + w + 1, y0 + h + 1] * 2)
    segs = rng.uniform(lo, hi, size=(B, S, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, S)) > 0.2).astype(np.float32)
    if name == "comb":
        x = (1.0 + 0.3 * np.arange(S)).astype(np.float32)
        up = np.arange(S) % 2 == 0
        segs[0] = np.stack([x, np.where(up, 0.2, 9.8), x, np.where(up, 9.8, 0.2)], 1)
        mask[0] = 1.0
        mask[1, 12:] = 0.0  # glyph 1 stays inside the lists
    if name == "one_wins":
        mask[0] = 0.0
        mask[0, 5] = 1.0
    if name == "chunks":
        mask[1] = 0.0
        mask[1, [3, 100, 260, 299]] = 1.0
        segs[1, 3] = segs[1, 260] = [2.0, 2.0, 12.0, 15.0]
        segs[1, 100], segs[1, 299] = [-2.0, 19.0, 0.0, 19.5], [15.0, -2.0, 15.5, 0.0]
    return segs, mask, np.tile(np.array([box], np.int32), (B, 1)), P


def out_of_range_argmin(am: np.ndarray, S: int, seed: int = 0) -> np.ndarray:
    """``am`` [B, P] i32 with about an eighth of its entries, drawn from
    a numpy seed, replaced by values that name no segment of [0, S):
    negative ones, S and beyond, the sentinel 2³¹−1 and −2³¹. The padded
    backward must add nothing for them."""
    rng = np.random.default_rng(seed)
    bad = np.array([-1, -7, S, S + 9, 2**31 - 1, -(2**31)], np.int64)
    out = np.where(rng.uniform(size=am.shape) < 0.125, rng.choice(bad, size=am.shape), am)
    return out.astype(np.int32)


def degenerate_fit_plan():
    """A flat-plan point chain for the fitting kernels' edges: (plan,
    chain [2, N] f32 torch tensor) of three glyphs at depth 2, one with
    zero-length curves, a horizontal line and a square, one with no
    live segment (the argmin sentinel), and one whose bitmap has
    negative origins."""
    import torch

    from ..models import fitting

    curves = np.zeros((3, 8, 4, 2), np.float32)
    mask = np.zeros((3, 8), bool)
    lines = [((3, 4), (7, 4)), ((2, 2), (6, 2)), ((6, 2), (6, 6)), ((6, 6), (2, 6)),
             ((2, 6), (2, 2))]
    for c, (a, b) in enumerate(lines):
        a, b = np.array(a, np.float32), np.array(b, np.float32)
        curves[0, c] = [a, a + (b - a) / 3, a + 2 * (b - a) / 3, b]
    curves[0, 5:7] = 4.5
    mask[0, :7] = True
    meta = np.array([[0, 0, 10, 9], [0, 0, 17, 17], [-2, -1, 12, 6]], np.int32)
    plan = fitting.build_flat_plan(mask, meta, 2, 512)
    chain = fitting.flat_chain_points(torch.tensor(curves), torch.zeros(3, 2), 2,
                                      torch.as_tensor(plan.chunk_map).long())
    return plan, chain.contiguous()


# The flat backward's edge inputs, made from a plan's own (pts, am, ct,
# tile table) by `flat_bwd_edge_case`.
FLAT_BWD_EDGE_CASES = ("unmasked", "one_wins", "out_of_run", "unaligned", "short_runs")


def flat_bwd_edge_case(name: str, pts: np.ndarray, am: np.ndarray, tmeta: np.ndarray,
                       seed: int = 0):
    """An input at an edge of the flat backward kernel
    (``csrc/sdf_min_field_bwd.cu``), made from a flat plan's point chain
    pts [2, N] f32, a forward's argmin am [T, TP] i32 and the tile table
    [8, T] i32, with a cotangent drawn from a numpy seed over every
    pixel (past w·h and on skip rows too, where it must add nothing):
    (pts, am, ct [T, TP] f32, tmeta), numpy arrays.

    ``unmasked``: the plan as it is. ``one_wins``: every pixel of a glyph
    has the argmin lane off + (npts − 1) // 2 (a step's 32 lanes are one
    set). ``out_of_run``: about a quarter of the argmins replaced by
    lanes outside their glyph's segment lanes [off, off + npts − 1): the
    lane before the run, the chain's last point, lanes past it, another
    glyph's lane, negative ones, N and beyond, and the sentinel.
    ``unaligned``: the lanes shifted by 5, so that no run starts on a
    multiple of 32. ``short_runs``: glyph 0 given npts = 1 and glyph 1
    npts = 0 (their argmins then lie outside their runs, and glyph 0
    owns one lane, glyph 1 none)."""
    rng = np.random.default_rng(seed)
    pts, am, tmeta = pts.copy(), am.copy(), tmeta.copy()
    T, TP = am.shape
    N = pts.shape[1]
    ct = rng.normal(size=(T, TP)).astype(np.float32)
    first = np.flatnonzero((tmeta[6] == 0) & (tmeta[2] * tmeta[3] > 0) & (tmeta[4] >= 2))
    # Each glyph's rows: from its first row while pix_base goes up.
    glyph = np.full(T, -1)
    for g, t0 in enumerate(first):
        t = t0
        while t < T and (t == t0 or tmeta[6, t] == tmeta[6, t - 1] + TP):
            glyph[t] = g
            t += 1
    off, npts = tmeta[5, first].astype(np.int64), tmeta[4, first].astype(np.int64)
    if name == "one_wins":
        rows = glyph >= 0
        am[rows] = (off + (npts - 1) // 2)[glyph[rows]][:, None]
    elif name == "out_of_run":
        rows = glyph >= 0
        g = glyph[rows][:, None]
        other = off[(glyph[rows] + 1) % len(first)][:, None]
        bad = np.stack(np.broadcast_arrays(
            off[g] - 1, off[g] + npts[g] - 1, off[g] + npts[g] + 3, other,
            np.full_like(g, -5), np.full_like(g, N), np.full_like(g, N + 40),
            np.full_like(g, 2**31 - 1)), -1)  # [rows, 1, 8]
        pick = bad[:, 0, :][np.arange(g.shape[0])[:, None], rng.integers(0, 8, size=(g.shape[0], TP))]
        am[rows] = np.where(rng.uniform(size=pick.shape) < 0.25, pick, am[rows])
    elif name == "unaligned":
        pts = np.concatenate([np.zeros((2, 5), np.float32), pts], 1)
        am = np.where((am >= 0) & (am < N), am + 5, am)
        tmeta[5] += 5
    elif name == "short_runs":
        tmeta[4, glyph == 0] = 1
        tmeta[4, glyph == 1] = 0
    elif name != "unmasked":
        raise ValueError(f"unknown flat backward case {name!r}")
    return pts, am.astype(np.int32), ct, np.ascontiguousarray(tmeta)
