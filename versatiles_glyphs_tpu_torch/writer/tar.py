"""Streaming POSIX.1-1988 / ustar tar encoder.

Byte-layout parity with the reference's hand-rolled encoder
(`reference/src/writer/tar.rs:49-137`): 512-byte headers with
zero-padded, space-terminated octal fields, names ≤ 100 bytes (error
otherwise — truncating would corrupt the entry's identity), mtime = now,
file mode 0644 / dir mode 0755, ustar magic ``ustar\\0`` + version
``00``, checksum computed over a space-filled checksum field, file data
padded to 512, and 1024 zero bytes on finish.

Backed by the optional C++ header encoder in `proto.native` when built;
this pure-Python path is always available and byte-identical.
"""

from __future__ import annotations

import time

_ZEROS = bytes(1024)


def write_octal(buf: bytearray, start: int, length: int, val: int) -> None:
    """Right-aligned octal with a trailing space, zero-filled on the
    left — matches `tar.rs:147-156` exactly."""
    idx = start + length - 1
    buf[idx] = 0x20  # space
    while idx > start:
        idx -= 1
        buf[idx] = 0x30 + (val & 7)
        val >>= 3
    # (val may be nonzero if it didn't fit; the reference silently
    # truncates high bits the same way.)


def build_header(path: str, size: int, mode: int, typeflag: int, mtime: int | None = None) -> bytes:
    header = bytearray(512)
    name = path.encode("utf-8")
    if len(name) > 100:
        raise ValueError(f"tar entry name longer than 100 bytes: {path!r}")
    header[0 : len(name)] = name
    write_octal(header, 100, 8, mode)  # file mode
    write_octal(header, 108, 8, 0)  # uid
    write_octal(header, 116, 8, 0)  # gid
    write_octal(header, 124, 12, size)  # size
    if mtime is None:
        mtime = int(time.time())
    write_octal(header, 136, 12, mtime)
    header[156] = typeflag
    header[257:263] = b"ustar\0"
    header[263:265] = b"00"
    header[148:156] = b" " * 8
    csum = sum(header)
    write_octal(header, 148, 8, csum)
    return bytes(header)


class TarWriter:
    """Sequentially appends files/directories to a tar stream."""

    def __init__(self, stream):
        self.stream = stream

    def write_file(self, file_name: str, data: bytes) -> None:
        self.stream.write(build_header(file_name, len(data), 0o644, ord("0")))
        self.stream.write(data)
        rem = len(data) % 512
        if rem:
            self.stream.write(_ZEROS[: 512 - rem])

    def write_directory(self, dir_name: str) -> None:
        if not dir_name.endswith("/"):
            raise ValueError("dirname must end with a slash")
        self.stream.write(build_header(dir_name, 0, 0o755, ord("5")))

    def finish(self) -> None:
        self.stream.write(_ZEROS)
        if hasattr(self.stream, "flush"):
            self.stream.flush()

    def get_inner(self):
        return None
