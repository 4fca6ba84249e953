"""index.json / font_families.json encoders.

Formatting parity with `reference/src/font/index_files.rs`
(serde_json pretty = 2-space indent; struct field order name→faces and
id→style→weight→width→codeblocks; families sorted by name; ids sorted).

``encode_codeblocks`` compacts codepoint coverage into 16-codepoint
blocks (``cp >> 4``), merging consecutive runs, uppercase hex, e.g.
``"0-3,5,A-C"`` (`index_files.rs:65-99`).
"""

from __future__ import annotations

import json


def encode_codeblocks(codepoints) -> str:
    blocks = sorted({cp >> 4 for cp in codepoints})
    if not blocks:
        return ""
    ranges = []
    start = prev = blocks[0]
    for b in blocks[1:]:
        if b != prev + 1:
            ranges.append((start, prev))
            start = b
        prev = b
    ranges.append((start, prev))
    return ",".join(f"{s:X}" if s == e else f"{s:X}-{e:X}" for s, e in ranges)


def build_index_json(ids) -> bytes:
    return json.dumps(sorted(ids), indent=2, ensure_ascii=False).encode("utf-8")


def build_font_families_json(fonts) -> bytes:
    """``fonts``: iterable of (id, FontWrapper). Groups faces by family
    name; families sorted by name."""
    family_map: dict[str, dict] = {}
    for font_id, wrapper in fonts:
        meta = wrapper.get_metadata()
        fam = family_map.setdefault(
            meta.family, {"name": meta.family, "faces": []}
        )
        fam["faces"].append(
            {
                "id": font_id,
                "style": meta.style,
                "weight": meta.weight,
                "width": meta.width,
                "codeblocks": encode_codeblocks(meta.codepoints),
            }
        )
    families = sorted(family_map.values(), key=lambda f: f["name"])
    return json.dumps(families, indent=2, ensure_ascii=False).encode("utf-8")
