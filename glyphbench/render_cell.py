"""What the render cells share: set-up from a configuration's fonts,
requests through the program's CLI in process (`cli.main`, as a user's
``python -m versatiles_glyphs_tpu_torch`` runs it), the spans of the
traced run, and the comparison of what the requests wrote with the
plain reference.

Each request writes over the previous one's output. After each, the
harness reads the output back with the benchmark's own decoders and
keeps only a digest of its files (a tar's headers carry the time, so
the digest is of the files, not of the stream). Once the window has
closed, the last output, still on disk, is held against the reference:
every expected file and glyph there and no other, each glyph's integer
metrics equal, and its bitmap within the cell's limits of the
reference's bytes; and every request's digest has to be that one's
(``distinct_outputs``, at most 1).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

from . import deploy
from .reference import decode


def digest(files: dict) -> str:
    """A digest of {path: bytes}."""
    h = hashlib.sha256()
    for k in sorted(files):
        h.update(k.encode() + b"\0" + len(files[k]).to_bytes(8, "little") + b"\0")
        h.update(files[k])
    return h.hexdigest()


class RenderDriver:
    """A render cell's driver; subclasses give `run_request` and
    `read_output`, both of the path `out_path`."""

    END_TO_END = ("glyphs_per_s",)
    OUT_SUFFIX = ""
    attempts_per_request = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.fonts = deploy.fonts(ctx.config, ctx.seed)
        self.font_dir = os.path.join(ctx.workdir, "fonts")
        self.out_path = os.path.join(ctx.workdir, "out" + self.OUT_SUFFIX)
        self.glyphs_per_request = sum(len(f.codepoints) for f in self.fonts)
        self._written = 0
        self.digests: list = []  # of every request's output, the warm-up's first
        self._expected = None

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        with self.ctx.phase("write_fonts"):
            self._font_bytes = deploy.write(self.fonts, self.font_dir)
        self._written += self._font_bytes
        with self.ctx.phase("warm_up_request"):
            self.request("warm")

    def run_cli(self, argv, stdout=None) -> None:
        from versatiles_glyphs_tpu_torch import cli

        cli.main(argv, stdout=stdout)

    def request(self, i) -> int:
        self.run_request()
        with self.ctx.spans.span("output digest"):
            files = self.read_output()
        self._written += sum(len(v) for v in files.values())
        self.digests.append(digest(files))
        return self.glyphs_per_request

    def release(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def bytes_written(self) -> int:
        return self._written

    # -- metrics --------------------------------------------------------------

    def end_to_end(self, requests, t0, t1) -> dict:
        glyphs = sum(u for _, _, u, ok in requests if ok)
        return {"glyphs_per_s": (glyphs / (t1 - t0), "glyphs/s")}

    def wrap_spans(self, spans) -> None:
        import concurrent.futures

        from versatiles_glyphs_tpu_torch.proto import native
        from versatiles_glyphs_tpu_torch.render import driver
        from versatiles_glyphs_tpu_torch.writer import FileWriter
        from versatiles_glyphs_tpu_torch.writer.tar import TarWriter

        spans.wrap(driver.Renderer, "prep_block", "prep_block")
        spans.wrap(driver.RenderSession, "add", "RenderSession.add", main_only=True)
        spans.wrap(driver._Group, "wait", "fetch wait", main_only=True)
        spans.wrap(native, "encode_block_from_preps", "encode", main_only=True)
        spans.wrap(concurrent.futures.Future, "result", "prep wait", main_only=True)
        spans.wrap(FileWriter, "write_file", "write", main_only=True)
        spans.wrap(TarWriter, "write_file", "write", main_only=True)

    def counters(self) -> dict:
        """The program's counters now: `render.driver.WIRE_STATS`."""
        from versatiles_glyphs_tpu_torch.render.driver import WIRE_STATS

        return dict(WIRE_STATS)

    def expected(self) -> deploy.Expected:
        if self._expected is None:
            self._expected = deploy.Expected(self.fonts)
        return self._expected

    def work_per_request(self) -> dict:
        return self.expected().work()

    # -- the comparison -------------------------------------------------------

    def check(self, requests) -> dict:
        t = time.perf_counter()
        files = self.read_output()
        distinct = len(set(self.digests))
        exp = self.expected()
        ref, starts = exp.render(self.ctx.device)
        got = self.compare(files, exp, ref, starts)
        got["distinct_outputs"] = distinct
        limits = self.ctx.cell["limits"]
        out = {k: {"value": got[k], "limit": limits[k]} for k in limits}
        print(json.dumps({"check_s": time.perf_counter() - t, "outputs_read": len(self.digests)}),
              file=sys.stderr)
        return out

    def compare(self, files: dict, exp: deploy.Expected, ref: np.ndarray, starts) -> dict:
        """The numbers of one output against the reference."""
        missing = 0
        expected_paths = {"index.json", "font_families.json"}
        for f in self.fonts:
            for b in np.unique(f.codepoints >> 8):
                expected_paths.add(f"{f.fontstack}/{b * 256}-{b * 256 + 255}.pbf")
        missing += len(expected_paths ^ set(files))
        try:
            if json.loads(files.get("index.json", b"null")) != sorted(f.fontstack for f in self.fonts):
                missing += 1
        except ValueError:
            missing += 1
        mismatches = 0
        got_parts, ref_parts = [], []
        for fi, (f, p) in enumerate(zip(self.fonts, exp.preps)):
            glyphs = {}
            for b in np.unique(f.codepoints >> 8):
                rng = f"{b * 256}-{b * 256 + 255}"
                data = files.get(f"{f.fontstack}/{rng}.pbf")
                if data is None:
                    continue
                try:
                    stacks = decode.read_pbf(data)
                except (ValueError, IndexError):
                    missing += 1
                    continue
                if len(stacks) != 1 or stacks[0][0] != f.fontstack or stacks[0][1] != rng:
                    missing += 1
                for _, _, gl in stacks:
                    for g in gl:
                        glyphs[g[0]] = g
            want = set(f.codepoints.tolist())
            mismatches += len(set(glyphs) ^ want)
            base = exp.glyph_base[fi]
            for k, cp in enumerate(f.codepoints.tolist()):
                g = glyphs.get(cp)
                if g is None:
                    continue
                metrics = (p.pbf_width[k], p.pbf_height[k], p.pbf_left[k], p.pbf_top[k], p.advance[k])
                n = int(p.width[k] * p.height[k])
                bm = g[6] or b""
                want_len = 0 if p.empty[k] else n
                if tuple(int(v) for v in metrics) != tuple(g[1:6]) or len(bm) != want_len:
                    mismatches += 1
                    continue
                if n and not p.empty[k]:
                    got_parts.append(bm)
                    s = starts[base + k]
                    ref_parts.append(ref[s:s + n])
        if got_parts:
            got = np.frombuffer(b"".join(got_parts), np.uint8).astype(np.int16)
            want_b = np.concatenate(ref_parts).astype(np.int16)
            diff = np.abs(got - want_b)
            max_d, off = int(diff.max()), float(100.0 * np.count_nonzero(diff) / diff.size)
        else:
            max_d, off = 0, 0.0
        return {"missing_or_extra_files": missing, "glyph_mismatches": mismatches,
                "max_abs_byte_diff": max_d, "pct_pixels_off": off}
