"""Traffic ``merge_set_dir``: each request is ``merge <every font file,
in the configuration's order> -o <a directory under TMPDIR>`` through
the program's CLI in process: a font set whose files share fontstacks
(script subsets of one family) merged into one glyph set, written as a
tree of PBFs over the last request's. One client, closed loop. No
workload ``params``.

The comparison follows first-file-claims (`reference.merge.Claims`): a
fontstack's blocks and glyphs are the union of its files' codepoints,
each codepoint's metrics and bitmap those of the first file that maps
it, and a request's glyphs are the claimed codepoints alone.
"""

from __future__ import annotations

import json
import os

import numpy as np

from glyphbench import deploy
from glyphbench.frozen import outlines
from glyphbench.reference import decode
from glyphbench.reference.merge import Claims
from glyphbench.render_cell import RenderDriver


class ClaimedExpected(deploy.Expected):
    """`deploy.Expected` of the glyphs a merge writes: each font's
    claimed glyphs alone, font by font in merge order. ``index[fi]``:
    glyph ``k`` of font ``fi`` -> its place among them."""

    def __init__(self, fonts_: list, claims: Claims):
        self.fonts = fonts_
        self.preps, self.index = [], []
        segs, owner, cols = [], [], {k: [] for k in ("width", "height", "x0", "y0")}
        base = 0
        for f, ks in zip(fonts_, claims.owned):
            keep = np.asarray(ks, np.int64)
            p = outlines.prep(deploy.rings(f)) if len(keep) else None
            self.preps.append(p)
            self.index.append(dict(zip(keep.tolist(), range(base, base + len(keep)))))
            if p is None:
                continue
            s, g = outlines.segments(p)
            place = np.full(len(p.width), -1, np.int64)
            place[keep] = np.arange(base, base + len(keep))
            sel = place[g] >= 0
            segs.append(s[sel])
            owner.append(place[g[sel]])
            for k in cols:
                cols[k].append(getattr(p, k)[keep])
            base += len(keep)
        self.segs, self.seg_glyph = np.concatenate(segs), np.concatenate(owner)
        self.width, self.height, self.x0, self.y0 = (np.concatenate(cols[k]) for k in cols)
        self.n_glyphs = base


class Driver(RenderDriver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.claims = Claims([f.fontstack for f in self.fonts], [f.codepoints for f in self.fonts])
        self.glyphs_per_request = self.claims.claimed()

    def run_request(self) -> None:
        paths = [os.path.join(self.font_dir, f.filename) for f in self.fonts]
        self.run_cli(["merge", *paths, "-o", self.out_path])

    def read_output(self) -> dict:
        return decode.read_tree(self.out_path)

    def expected(self) -> ClaimedExpected:
        if self._expected is None:
            self._expected = ClaimedExpected(self.fonts, self.claims)
        return self._expected

    def compare(self, files: dict, exp: ClaimedExpected, ref: np.ndarray, starts) -> dict:
        """The numbers of one output against the reference, by
        first-file-claims."""
        c = self.claims
        missing = len(c.paths() ^ set(files))
        try:
            if json.loads(files.get("index.json", b"null")) != c.index():
                missing += 1
        except ValueError:
            missing += 1
        mismatches = 0
        got_parts, ref_parts = [], []
        for fs in c.fontstacks:
            glyphs = {}
            for b in c.blocks(fs):
                rng = c.block_range(b)
                data = files.get(f"{fs}/{rng}.pbf")
                if data is None:
                    continue
                try:
                    stacks = decode.read_pbf(data)
                except (ValueError, IndexError):
                    missing += 1
                    continue
                if len(stacks) != 1 or stacks[0][0] != fs or stacks[0][1] != rng:
                    missing += 1
                for _, _, gl in stacks:
                    for g in gl:
                        glyphs[g[0]] = g
            own = c.owner[fs]
            mismatches += len(set(glyphs) ^ set(own))
            for cp, (fi, k) in own.items():
                g = glyphs.get(cp)
                if g is None:
                    continue
                p = exp.preps[fi]
                metrics = (p.pbf_width[k], p.pbf_height[k], p.pbf_left[k], p.pbf_top[k], p.advance[k])
                n = int(p.width[k] * p.height[k])
                bm = g[6] or b""
                if tuple(int(v) for v in metrics) != tuple(g[1:6]) or len(bm) != (0 if p.empty[k] else n):
                    mismatches += 1
                    continue
                if n and not p.empty[k]:
                    got_parts.append(bm)
                    s = starts[exp.index[fi][k]]
                    ref_parts.append(ref[s:s + n])
        max_d, off = 0, 0.0
        if got_parts:
            got = np.frombuffer(b"".join(got_parts), np.uint8).astype(np.int16)
            diff = np.abs(got - np.concatenate(ref_parts).astype(np.int16))
            max_d, off = int(diff.max()), float(100.0 * np.count_nonzero(diff) / diff.size)
        return {"missing_or_extra_files": missing, "glyph_mismatches": mismatches,
                "max_abs_byte_diff": max_d, "pct_pixels_off": off}
