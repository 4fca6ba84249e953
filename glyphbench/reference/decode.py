"""The benchmark's own readers of what the program writes: a ustar tar
stream and the Mapbox glyphs protobuf (``glyphs`` → one ``fontstack``
{name 1, range 2, glyphs 3} → ``glyph`` {id 1, bitmap 2, width 3,
height 4, left 5 (sint32), top 6 (sint32), advance 7}).

Imports nothing of the port.
"""

from __future__ import annotations

import os


def read_tar(data: bytes) -> dict:
    """{path: bytes} of every regular file of a tar stream (directories
    left out). Raises ValueError on a malformed header."""
    files = {}
    pos = 0
    while pos + 512 <= len(data):
        head = data[pos:pos + 512]
        if head == bytes(512):
            break
        chk = int(head[148:156].split(b"\0")[0].strip() or b"0", 8)
        if chk != sum(head[:148]) + 8 * 32 + sum(head[156:]):
            raise ValueError(f"tar header at {pos}: bad checksum")
        name = head[:100].split(b"\0")[0].decode("utf-8")
        prefix = head[345:500].split(b"\0")[0].decode("utf-8")
        if prefix:
            name = f"{prefix}/{name}"
        size = int(head[124:136].split(b"\0")[0].strip() or b"0", 8)
        kind = head[156:157]
        pos += 512
        if kind in (b"0", b"\0"):
            files[name] = data[pos:pos + size]
        pos += -(-size // 512) * 512
    return files


def read_tree(root: str) -> dict:
    """{relative path: bytes} of every file under a directory."""
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root).replace(os.sep, "/")] = f.read()
    return files


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, value) of a message: an int for varints, bytes
    for length-delimited fields."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unexpected wire type {wire}")
        yield num, val


def _sint(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def read_pbf(buf: bytes) -> list:
    """[(fontstack name, range, [(id, width, height, left, top,
    advance, bitmap bytes or None), ...])] of a glyphs PBF."""
    stacks = []
    for num, val in _fields(buf):
        if num != 1:
            continue
        name, rng, glyphs = "", "", []
        for n2, v2 in _fields(val):
            if n2 == 1:
                name = bytes(v2).decode("utf-8")
            elif n2 == 2:
                rng = bytes(v2).decode("utf-8")
            elif n2 == 3:
                g = {1: 0, 2: None, 3: 0, 4: 0, 5: 0, 6: 0, 7: 0}
                for n3, v3 in _fields(v2):
                    g[n3] = v3
                glyphs.append((g[1], g[3], g[4], _sint(g[5]), _sint(g[6]), g[7], g[2]))
        stacks.append((name, rng, glyphs))
    return stacks
