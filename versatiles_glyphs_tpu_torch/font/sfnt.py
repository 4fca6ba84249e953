"""The sfnt container of a TrueType/OpenType font, read without fontTools.

What the port's font ingest takes from the file besides the tables the
native parsers read (`proto.native`: cmap, hmtx, glyf/loca, CFF): the
table directory, ``head.unitsPerEm`` and ``head.indexToLocFormat``,
``hhea.numberOfHMetrics``, ``maxp.numGlyphs`` and the strings of the
``name`` table, read as fontTools 4.61 reads them (`TTFont`,
``name.getDebugName``), so that a font gives the port the metadata it
gives the JAX package.

- The directory: sfnt version ``0x00010000``, ``OTTO`` or ``true``; a
  ``ttcf`` collection gives its font 0 (``TTFont(fontNumber=0)``). A
  table listed twice is the last listing. `table` slices a table's bytes
  as a file read does: a listing that runs past the end of the file
  gives the bytes there are (`covered` tells such a table apart).
- ``name``: `debug_name` follows ``getDebugName``: records in file
  order, strings sliced from the declared ``stringOffset`` even where it
  is wrong, records past the string data skipped, and of the records
  with the wanted ID the last one that decodes is kept, unless one with
  ``(platformID, langID)`` in ``((1, 0), (3, 0x409))`` decodes first,
  which wins at once; an empty result is None. A record's encoding is
  fontTools' ``encodingTools`` map, copied below: every encoding there is
  a codec of Python's own except the four CJK Mac ones of fontTools
  (``x_mac_*_ttx``: platform 1 encodings 1, 2, 3 and 25), which are
  decoded here as fontTools' ``encodings.codecs.ExtendCodec`` decodes
  them: Python's ``shift_jis``, ``big5``, ``euc_kr`` or ``gb2312`` with
  a few single bytes it cannot decode mapped to characters (`_MAC_CJK`,
  fontTools' ``_extended_encodings``). Unknown encodings decode as
  ASCII, and UTF-16 strings of odd length are repaired as
  ``NameRecord.toUnicode`` repairs them.
"""

from __future__ import annotations

import codecs
import struct

SFNT_VERSIONS = (b"\x00\x01\x00\x00", b"OTTO", b"true")

# fontTools.misc.encodingTools._encodingMap: platformID -> platEncID ->
# encoding, or -> langID -> encoding with ``...`` for the other langIDs.
_ENCODINGS = {
    0: {0: "utf_16_be", 1: "utf_16_be", 2: "utf_16_be", 3: "utf_16_be", 4: "utf_16_be",
        5: "utf_16_be", 6: "utf_16_be"},
    1: {
        0: {15: "mac_iceland", 17: "mac_turkish", 18: "mac_croatian", 24: "mac_latin2",
            25: "mac_latin2", 26: "mac_latin2", 27: "mac_latin2", 28: "mac_latin2",
            36: "mac_latin2", 37: "mac_romanian", 38: "mac_latin2", 39: "mac_latin2",
            40: "mac_latin2", ...: "mac_roman"},
        1: "x_mac_japanese_ttx", 2: "x_mac_trad_chinese_ttx", 3: "x_mac_korean_ttx",
        6: "mac_greek", 7: "mac_cyrillic", 25: "x_mac_simp_chinese_ttx", 29: "mac_latin2",
        35: "mac_turkish", 37: "mac_iceland",
    },
    2: {0: "ascii", 1: "utf_16_be", 2: "latin1"},
    3: {0: "utf_16_be", 1: "utf_16_be", 2: "shift_jis", 3: "gb2312", 4: "big5", 5: "euc_kr",
        6: "johab", 10: "utf_16_be"},
}
ENGLISH = ((1, 0), (3, 0x409))

# fontTools.encodings.codecs._extended_encodings: the base codec of each
# CJK Mac encoding and the bytes it cannot decode that map to a character.
_MAC_CJK = {
    "x_mac_japanese_ttx": ("shift_jis", {b"\xFC": "\u007C", b"\x7E": "\u007E", b"\x80": "\u005C",
                                         b"\xA0": "\u00A0", b"\xFD": "\u00A9", b"\xFE": "\u2122",
                                         b"\xFF": "\u2026"}),
    "x_mac_trad_chinese_ttx": ("big5", {b"\x80": "\u005C", b"\xA0": "\u00A0", b"\xFD": "\u00A9",
                                        b"\xFE": "\u2122", b"\xFF": "\u2026"}),
    "x_mac_korean_ttx": ("euc_kr", {b"\x80": "\u00A0", b"\x81": "\u20A9", b"\x82": "\u2014",
                                    b"\x83": "\u00A9", b"\xFE": "\u2122", b"\xFF": "\u2026"}),
    "x_mac_simp_chinese_ttx": ("gb2312", {b"\x80": "\u00FC", b"\xA0": "\u00A0", b"\xFD": "\u00A9",
                                          b"\xFE": "\u2122", b"\xFF": "\u2026"}),
}


def _mac_cjk_handler(mapping: dict):
    """``ExtendCodec.error`` for decoding: the shortest run of the bytes
    that failed, from where they start, that ``mapping`` holds, else the
    error is raised (fontTools decodes with ``errors="strict"``)."""

    def handler(e):
        if isinstance(e, UnicodeDecodeError):
            for end in range(e.start + 1, e.end + 1):
                s = e.object[e.start:end]
                if s in mapping:
                    return mapping[s], end
        raise e

    return handler


for _name, (_, _mapping) in _MAC_CJK.items():
    codecs.register_error("versatiles_" + _name, _mac_cjk_handler(_mapping))


def encoding_of(platform_id: int, enc_id: int, lang_id: int) -> str:
    """The codec name fontTools gives a name record ('ascii' if unknown)."""
    enc = _ENCODINGS.get(platform_id, {}).get(enc_id, "ascii")
    if isinstance(enc, dict):
        enc = enc.get(lang_id, enc[...])
    return enc


def _isascii(b: int) -> bool:
    return 0x20 <= b <= 0x7E or b in (0x09, 0x0A, 0x0D)


def decode_name(raw: bytes, platform_id: int, enc_id: int, lang_id: int) -> str:
    """A name record's string as ``NameRecord.toUnicode()`` gives it;
    raises UnicodeDecodeError where that does."""
    enc = encoding_of(platform_id, enc_id, lang_id)
    s = raw
    if enc == "utf_16_be" and len(s) % 2 == 1:
        if s[-1] == 0:
            s = s[:-1]
        elif all(b == 0 if i % 2 else _isascii(b) for i, b in enumerate(s)):
            s = b"\0" + s
        elif s[0] == 0 and all(_isascii(b) for b in s[1:]):
            s = b"".join(b"\0" + bytes([b]) for b in s[1:])
    if enc in _MAC_CJK:
        text = s.decode(_MAC_CJK[enc][0], errors="versatiles_" + enc)
    else:
        text = s.decode(enc)
    if all(ord(c) == 0 if i % 2 == 0 else _isascii(ord(c)) for i, c in enumerate(text)):
        text = "".join(text[1::2])
    return text


def name_records(data: bytes) -> list:
    """(platformID, platEncID, langID, nameID, string bytes) of a name
    table's records, as ``table__n_a_m_e.decompile`` keeps them."""
    if len(data) < 6:
        raise ValueError("'name' table is shorter than its header")
    _, n, string_offset = struct.unpack(">HHH", data[:6])
    strings = data[string_offset:]
    out = []
    for i in range(n):
        rec = data[6 + 12 * i: 18 + 12 * i]
        if len(rec) < 12:
            continue  # a truncated record (fontTools logs and skips it)
        pid, eid, lid, nid, length, offset = struct.unpack(">6H", rec)
        if offset + length > len(strings):
            continue
        out.append((pid, eid, lid, nid, strings[offset:offset + length]))
    return out


def debug_name(records, name_id: int) -> str | None:
    """``table__n_a_m_e.getDebugName(name_id)`` over `name_records`."""
    english = some = None
    for pid, eid, lid, nid, raw in records:
        if nid != name_id:
            continue
        try:
            text = decode_name(raw, pid, eid, lid)
        except (UnicodeDecodeError, LookupError):
            continue
        some = text
        if (pid, lid) in ENGLISH:
            english = text
            break
    return english or some or None


class Sfnt:
    """The table directory of one font in a file and the header fields
    the ingest reads. Raises ValueError where fontTools' `TTFont` would
    fail to open the file or to read those fields."""

    def __init__(self, data: bytes):
        self.data = data
        base = 0
        if data[:4] == b"ttcf":
            if len(data) < 16:
                raise ValueError("truncated font collection header")
            (base,) = struct.unpack(">I", data[12:16])  # font 0
        head = data[base:base + 12]
        if len(head) < 12:
            raise ValueError("not a TrueType or OpenType font (file too short)")
        if head[:4] not in SFNT_VERSIONS:
            raise ValueError(f"not a TrueType or OpenType font (sfnt version {head[:4]!r})")
        (n,) = struct.unpack(">H", head[4:6])
        self.tables: dict = {}
        for i in range(n):
            rec = data[base + 12 + 16 * i: base + 28 + 16 * i]
            if len(rec) < 16:
                raise ValueError("truncated table directory")
            tag = rec[:4].decode("latin1")
            _, offset, length = struct.unpack(">III", rec[4:])
            self.tables[tag] = (offset, length)
        head = self.table("head")
        if len(head) < 54:
            raise ValueError("font has no complete 'head' table")
        (self.units_per_em,) = struct.unpack(">H", head[18:20])
        (self.index_to_loc_format,) = struct.unpack(">h", head[50:52])

    def __contains__(self, tag: str) -> bool:
        return tag in self.tables

    def covered(self, tag: str) -> bool:
        """The table is listed and lies inside the file."""
        if tag not in self.tables:
            return False
        offset, length = self.tables[tag]
        return offset + length <= len(self.data)

    def table(self, tag: str) -> bytes:
        """A table's bytes (b"" where it is not listed)."""
        if tag not in self.tables:
            return b""
        offset, length = self.tables[tag]
        return self.data[offset:offset + length]

    def u16(self, tag: str, at: int) -> int | None:
        """The big-endian u16 at ``at`` of a table, None past its end."""
        raw = self.table(tag)[at:at + 2]
        return struct.unpack(">H", raw)[0] if len(raw) == 2 else None

    def names(self) -> tuple[str | None, str | None]:
        """(family, PostScript name): ``getDebugName(1)`` and ``(6)``."""
        if "name" not in self.tables:
            raise ValueError("font has no 'name' table")
        records = name_records(self.table("name"))
        return debug_name(records, 1), debug_name(records, 6)
