"""Mapbox glyphs.proto wire encoding/decoding (pure Python).

Hand-rolled protobuf for the three messages of
`reference/src/protobuf/` (glyph.rs, fontstack.rs, glyphs.rs):

- ``glyph``: id(1, uint32) bitmap(2, optional bytes) width(3, uint32)
  height(4, uint32) left(5, **sint32** zigzag) top(6, sint32)
  advance(7, uint32)
- ``fontstack``: name(1, string) range(2, string) glyphs(3, repeated)
- ``glyphs``: stacks(1, repeated) — always exactly one stack.

Field numbers and the sint32 zigzag for left/top are wire-compat
requirements. Fields are emitted in field-number order (prost's
behavior), so output bytes are size-identical to the reference.

A C++ fast path for whole-block encoding lives in `proto.native`; this
module is the always-available reference implementation and decoder.
"""

from __future__ import annotations

from dataclasses import dataclass


def encode_varint(value: int, out: bytearray) -> None:
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def zigzag32(value: int) -> int:
    return ((value << 1) ^ (value >> 31)) & 0xFFFFFFFF


def unzigzag32(value: int) -> int:
    v = (value >> 1) ^ -(value & 1)
    return v


@dataclass
class PbfGlyph:
    """One glyph message (see module docstring for the wire layout)."""

    id: int
    bitmap: bytes | None = None
    width: int = 0
    height: int = 0
    left: int = 0
    top: int = 0
    advance: int = 0

    @classmethod
    def empty(cls, id: int, advance: int) -> "PbfGlyph":
        return cls(id=id, advance=advance)

    def encode(self) -> bytes:
        out = bytearray()
        out.append((1 << 3) | 0)
        encode_varint(self.id, out)
        if self.bitmap is not None:
            out.append((2 << 3) | 2)
            encode_varint(len(self.bitmap), out)
            out += self.bitmap
        out.append((3 << 3) | 0)
        encode_varint(self.width, out)
        out.append((4 << 3) | 0)
        encode_varint(self.height, out)
        out.append((5 << 3) | 0)
        encode_varint(zigzag32(self.left), out)
        out.append((6 << 3) | 0)
        encode_varint(zigzag32(self.top), out)
        out.append((7 << 3) | 0)
        encode_varint(self.advance, out)
        return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _read_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def decode_glyph(buf: bytes) -> PbfGlyph:
    g = PbfGlyph(id=0)
    for field, wire, val in _read_fields(buf):
        if field == 1:
            g.id = val
        elif field == 2:
            g.bitmap = bytes(val)
        elif field == 3:
            g.width = val
        elif field == 4:
            g.height = val
        elif field == 5:
            g.left = unzigzag32(val)
        elif field == 6:
            g.top = unzigzag32(val)
        elif field == 7:
            g.advance = val
    return g


@dataclass
class Fontstack:
    name: str
    range: str
    glyphs: list

    def encode(self) -> bytes:
        out = bytearray()
        nb = self.name.encode("utf-8")
        out.append((1 << 3) | 2)
        encode_varint(len(nb), out)
        out += nb
        rb = self.range.encode("utf-8")
        out.append((2 << 3) | 2)
        encode_varint(len(rb), out)
        out += rb
        for g in self.glyphs:
            gb = g.encode()
            out.append((3 << 3) | 2)
            encode_varint(len(gb), out)
            out += gb
        return bytes(out)


def encode_glyphs(name: str, range_str: str, glyphs: list) -> bytes:
    """Encode the top-level `glyphs` message with exactly one stack
    (reference always writes one stack: `src/protobuf/glyphs.rs:28-32`).
    Uses the native encoder when built (byte-identical)."""
    from . import native

    encoded = native.encode_glyph_block(name, range_str, glyphs)
    if encoded is not None:
        return encoded
    return encode_glyphs_py(name, range_str, glyphs)


def encode_glyphs_py(name: str, range_str: str, glyphs: list) -> bytes:
    """Pure-Python encoding (the reference implementation the native
    path is tested against)."""
    stack = Fontstack(name=name, range=range_str, glyphs=glyphs).encode()
    out = bytearray()
    out.append((1 << 3) | 2)
    encode_varint(len(stack), out)
    out += stack
    return bytes(out)


def decode_glyphs(buf: bytes) -> list[PbfGlyph]:
    """Decode a `glyphs` message into the flat glyph list of every stack
    (the reference's `into_glyphs` helper, used by the debug command)."""
    glyphs: list[PbfGlyph] = []
    for field, wire, stack_buf in _read_fields(buf):
        if field == 1 and wire == 2:
            for f2, w2, val in _read_fields(bytes(stack_buf)):
                if f2 == 3 and w2 == 2:
                    glyphs.append(decode_glyph(bytes(val)))
    return glyphs
