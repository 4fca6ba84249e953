"""Plain reference of what ``merge`` writes for fonts that share a
fontstack: first-file-claims.

Fonts are merged in the order given. Each fontstack's codepoints are the
union of its fonts' mapped codepoints; each codepoint belongs to the
first font, in that order, that maps it, and its metrics and bitmap are
that font's glyph's. The fontstack writes one PBF a 256-codepoint block
that holds a codepoint, and ``index.json`` lists the fontstacks sorted.
A codepoint a later font maps too is shadowed: mapped, not written.

Plain Python and NumPy; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

BLOCK = 256


class Claims:
    """First-file-claims over fonts in merge order: ``fontstacks`` [F]
    each font's fontstack id, ``codepoints`` [F] each font's mapped
    codepoints (unique; font ``fi``'s glyph ``k`` is mapped from
    ``codepoints[fi][k]``).

    ``owner[fs]``: codepoint -> (font, k) of its owning glyph, in
    claim order; ``owned[fi]``: the sorted ``k`` that font ``fi``
    owns."""

    def __init__(self, fontstacks, codepoints):
        self.n_fonts = len(fontstacks)
        self.fontstacks = list(dict.fromkeys(fontstacks))  # in order of first appearance
        self.owner: dict = {fs: {} for fs in self.fontstacks}
        self.shadowed = 0
        for fi, (fs, cps) in enumerate(zip(fontstacks, codepoints)):
            own = self.owner[fs]
            for k, cp in enumerate(np.asarray(cps).tolist()):
                if cp in own:
                    self.shadowed += 1
                else:
                    own[cp] = (fi, k)
        self.owned = [[] for _ in range(self.n_fonts)]
        for own in self.owner.values():
            for fi, k in own.values():
                self.owned[fi].append(k)
        self.owned = [sorted(ks) for ks in self.owned]

    def claimed(self) -> int:
        return sum(len(own) for own in self.owner.values())

    def blocks(self, fontstack: str) -> list:
        """The fontstack's block indices (codepoint // 256), sorted."""
        return sorted({cp // BLOCK for cp in self.owner[fontstack]})

    def block_range(self, b: int) -> str:
        return f"{b * BLOCK}-{b * BLOCK + BLOCK - 1}"

    def paths(self) -> set:
        """Every file the merge writes: the index files and the PBFs."""
        out = {"index.json", "font_families.json"}
        for fs in self.fontstacks:
            out |= {f"{fs}/{self.block_range(b)}.pbf" for b in self.blocks(fs)}
        return out

    def index(self) -> list:
        """``index.json``'s list."""
        return sorted(self.fontstacks)

    def mixed_blocks(self) -> int:
        """Blocks whose glyphs come from more than one font."""
        fonts: dict = {}
        for fs, own in self.owner.items():
            for cp, (fi, _) in own.items():
                fonts.setdefault((fs, cp // BLOCK), set()).add(fi)
        return sum(1 for s in fonts.values() if len(s) > 1)

    def stats(self) -> dict:
        """The counts of the claim walk: fonts, fontstacks, blocks, mixed
        blocks, claimed and shadowed codepoints."""
        return {"files": self.n_fonts, "fontstacks": len(self.fontstacks),
                "blocks": sum(len(self.blocks(fs)) for fs in self.fontstacks),
                "mixed_blocks": self.mixed_blocks(), "claimed": self.claimed(),
                "shadowed": self.shadowed}
