"""Font name parsing: family / style / weight / width extraction.

Behavioral port of the reference's name parser
(`reference/src/font/parse_font_name.rs:214-322`), whose 250-case
inline test table is the de-facto spec. The script-token list
(`parse_font_name.rs:20-180`) strips script subsets (mostly Noto) so all
scripts of a family share one output bundle; ``"italic"`` is included so
the multi-word script "Old Italic" is fully dropped once "old" is
stripped.
"""

from __future__ import annotations

import re

# Lowercase tokens stripped from a raw family name during normalization.
# Authoritative list — to support a new Noto script, add its lowercased
# tokens here (multi-word scripts contribute every word as its own
# token). Mirrors `parse_font_name.rs:20-180`.
SCRIPT_TOKENS = frozenset(
    """
    aboriginal adlam albanian anatolian arabic aramaic armenian avestan
    balinese bamum bassa batak bengali bhaiksuki brahmi buginese buhid
    canadian carian caucasian chakma cham cherokee chiki cin coptic
    cuneiform cypriot deseret devanagari duployan egyptian elbasan
    elymaic ethiopic georgian glagolitic gondi gothic grantha gujarati
    gunjala gurmukhi hanifi hanunoo hatran hau hebrew hieroglyphs hmong
    hungarian imperial indic inscriptional italic javanese jp kaithi
    kannada kayah kharoshthi khmer khojki khudawadi kikakui kr lao le
    lepcha li limbu linear lisu lue lycian lydian mahajani malayalam
    mandaic manichaean marchen masaram mayan mayek medefaidrin meetei
    mende meroitic miao modi mongolian mro multani myanmar nabataean new
    newa nko north numbers nushu ogham ol old oriya osage osmanya pa
    pahawh pahlavi palmyrene parthian pau permic persian phags
    phoenician psalter rejang rohingya runic samaritan saurashtra sc
    sharada shavian siddham sinhala sogdian sompeng sora south soyombo
    square sundanese syloti symbols syriac tagalog tagbanwa tai takri
    tamil tangut tc telugu thaana thai tibetan tifinagh tirhuta turkic
    ugaritic vah vai wancho warang yi zanabazar
    """.split()
)

_WEIGHT_NAMES = {
    100: "Thin",
    200: "ExtraLight",
    300: "Light",
    400: "Regular",
    500: "Medium",
    600: "SemiBold",
    700: "Bold",
    800: "ExtraBold",
    900: "Black",
}


def find_weight(s: str) -> int:
    """Detect a font weight from a lowercased token; 400 when no keyword
    matches. Keyword precedence mirrors `parse_font_name.rs:295-322`."""
    if "hairline" in s or "thin" in s:
        return 100
    if "extralight" in s or "ultralight" in s:
        return 200
    if "light" in s:
        return 300
    if "regular" in s or "normal" in s or "book" in s:
        return 400
    if "medium" in s:
        return 500
    if "demibold" in s or "semibold" in s:
        return 600
    if "bold" in s:
        return 800 if ("extra" in s or "ultra" in s) else 700
    if "black" in s or "heavy" in s:
        return 900
    return 400


def parse_font_name(family: str, ps_name: str) -> tuple[str, str, int, str]:
    """Parse ``(family, style, weight, width)`` from a raw family name
    and a PostScript name.

    Style/weight come primarily from the PostScript suffix (after the
    last ``-``); the family string is scanned token-by-token to strip
    width descriptors, script subsets, and weight words.
    """
    style = "normal"
    weight = 400
    width = "normal"

    pos = ps_name.rfind("-")
    suffix = ps_name[pos + 1 :] if pos >= 0 else ps_name
    lower_suffix = suffix.lower()

    if "italic" in lower_suffix:
        style = "italic"

    ps_weight = find_weight(lower_suffix)
    if ps_weight != 400:
        weight = ps_weight

    tokens = family.split()
    out_tokens: list[str] = []
    i = 0
    while i < len(tokens):
        t = tokens[i].lower()

        # Multi-word width "Extra Condensed".
        if i + 1 < len(tokens) and t == "extra" and tokens[i + 1].lower() == "condensed":
            width = "extra-condensed"
            i += 2
            continue
        if t in ("semicondensed", "semi-condensed"):
            width = "semi-condensed"
            i += 1
            continue
        if t == "condensed":
            width = "condensed"
            i += 1
            continue
        if t in SCRIPT_TOKENS:
            i += 1
            continue

        maybe_w = find_weight(t)
        if maybe_w != 400:
            # Family-token weight applies only if the PS suffix didn't
            # already override it.
            if ps_weight == 400:
                weight = maybe_w
            i += 1
            continue

        out_tokens.append(tokens[i])
        i += 1

    return " ".join(out_tokens), style, weight, width


def generate_name(family: str, style: str, weight: int, width: str) -> str:
    """Human-readable face name: family + non-normal width + weight word
    + non-normal style (`reference/src/font/metadata.rs:42-67`)."""
    name = family
    if width != "normal":
        name = f"{name} {width}"
    name = f"{name} {_WEIGHT_NAMES.get(weight, 'Unknown')}"
    if style != "normal":
        name = f"{name} {style}"
    return name


_ID_RE = re.compile(r"[-_\s]+")


def name_to_id(name: str) -> str:
    """Normalize a face name into a directory id: lowercase, runs of
    ``[-_\\s]`` collapsed to one ``_``
    (`reference/src/font/manager.rs:141-147`)."""
    collapsed = _ID_RE.sub(" ", name.lower()).strip()
    return collapsed.replace(" ", "_")
