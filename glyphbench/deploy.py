"""A configuration's fonts: what the frozen writers make of it for a
seed, and what the plain reference expects a render of them to write.

A configuration (``configs/<name>.json``) lists its ``fonts``: each
entry names a ``generator``, ``generators/<generator>.py``, and gives
it its arguments. A generator module has ``fonts(spec, first, seed)``,
the entry's fonts, the first at place ``first`` in the configuration's
list; ``font_bytes(font)``, the file; and ``rings(font)``, the
flattened rings of its mapped glyphs by the frozen flattening. A
configuration of fonts of several kinds needs only a generator file
for each kind.

Font ``k`` of the list takes the outline seed `font_seed` (run seed,
k), so one seed gives one set of files.
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass

import numpy as np

from .frozen import outlines
from .harness import NAME_RE


@dataclass
class Font:
    filename: str
    fontstack: str
    family: str
    style: str
    generator: str
    seed: int
    n_glyphs: int
    quads: int
    codepoints: np.ndarray  # [n mapped], glyph k + 1 mapped from codepoints[k]


def codepoints(spec: dict) -> np.ndarray:
    return np.concatenate([np.arange(a, b + 1) for a, b in spec["codepoint_ranges"]])


def font_seed(seed: int, k: int) -> int:
    """The outline seed of font ``k`` of a run of seed ``seed`` (any
    whole number)."""
    return ((int(seed) % (1 << 56)) << 6) + k


def generator(name: str):
    if not NAME_RE.match(name):
        raise ValueError(f"bad font generator name {name!r}")
    return importlib.import_module(f"glyphbench.generators.{name}")


def fonts(config: dict, seed: int) -> list:
    """The configuration's fonts for run seed ``seed``."""
    out: list = []
    for spec in config["fonts"]:
        out += generator(spec["generator"]).fonts(spec, len(out), seed)
    return out


def font_bytes(font: Font) -> bytes:
    return generator(font.generator).font_bytes(font)


def write(fonts_: list, directory: str) -> int:
    """Write the fonts into ``directory``; returns the bytes written."""
    os.makedirs(directory, exist_ok=True)
    n = 0
    for f in fonts_:
        data = font_bytes(f)
        with open(os.path.join(directory, f.filename), "wb") as fh:
            fh.write(data)
        n += len(data)
    return n


def rings(font: Font) -> outlines.FontRings:
    """The flattened rings of the font's mapped glyphs, by the frozen
    flattening."""
    return generator(font.generator).rings(font)


class Expected:
    """The reference's view of a set of fonts: per font its prep
    (`outlines.prep`), and all fonts' segment soups back to back with
    each glyph's global index (`glyph_base` [fonts])."""

    def __init__(self, fonts_: list):
        self.fonts = fonts_
        self.preps = [outlines.prep(rings(f)) for f in fonts_]
        segs, owner, base = [], [], 0
        self.glyph_base = []
        for p in self.preps:
            s, g = outlines.segments(p)
            segs.append(s)
            owner.append(g + base)
            self.glyph_base.append(base)
            base += len(p.width)
        self.segs = np.concatenate(segs)
        self.seg_glyph = np.concatenate(owner)
        cat = lambda k: np.concatenate([getattr(p, k) for p in self.preps])  # noqa: E731
        self.width, self.height = cat("width"), cat("height")
        self.x0, self.y0 = cat("x0"), cat("y0")
        self.n_glyphs = base

    def render(self, device, dtype=None):
        """(bytes, each glyph's first index) of every glyph of every
        font, by the plain reference render."""
        import torch

        from .reference import render

        return render.render(self.segs, self.seg_glyph, self.width, self.height, self.x0, self.y0,
                             device=device, dtype=dtype or torch.float64)

    def work(self) -> dict:
        """The least work of rendering every glyph once (the frozen
        per-pair constants): f32 operations and bytes."""
        from .frozen import work

        return work.render_work(self.segs, self.seg_glyph, self.width, self.height, self.y0)
