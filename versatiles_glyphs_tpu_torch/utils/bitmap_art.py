"""Bitmap to text art, for reading SDF bitmaps in tests and by eye (a
copy of `versatiles_glyphs_tpu.utils.bitmap_art`).

The encodings of the reference's `src/utils/decode_bitmap.rs:15-78`:
digit art maps each byte to ``(v*100)//256`` as two zero-padded digits;
ASCII art maps intensity ranges to 2-character shade blocks.
"""

from __future__ import annotations


def bitmap_as_digit_art(bitmap, width: int) -> list[str]:
    rows = []
    for r0 in range(0, len(bitmap), width):
        row = bitmap[r0 : r0 + width]
        rows.append(" ".join(f"{min((int(v) * 100) // 256, 99):02d}" for v in row))
    return rows


def _shade(v: int) -> str:
    if v <= 60:
        return "  "
    if v <= 120:
        return "░░"
    if v <= 180:
        return "▒▒"
    if v <= 240:
        return "▓▓"
    return "█"


def bitmap_as_ascii_art(bitmap, width: int) -> list[str]:
    rows = []
    for r0 in range(0, len(bitmap), width):
        row = bitmap[r0 : r0 + width]
        rows.append("".join(_shade(int(v)) for v in row))
    return rows
