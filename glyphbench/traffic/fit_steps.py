"""Traffic ``fit_steps``: a type designer's outline fit, as ``fit
--backend flat`` runs it.

Set-up writes the configuration's ``fit_style`` and ``target_style``
fonts, reads them with the program's font reader, builds the batch of
every mapped codepoint by `models.fitting.make_fit_batch` (the fitted
font's outlines toward the target font's exact bitmaps, ``depth``) and
starts a `FontFitter` (``learning_rate``, backend ``flat``). It then
drives the first 1 + ``steps_per_call`` steps through the window's own
entry, `step_many`: one call of one step, whose Adam state gives the
first gradient, and one call of ``steps_per_call`` steps, the window's
own call size, which warms it up. It keeps the losses, the first
gradient and the parameters before and after. Each request of the
window is one `step_many` call of ``steps_per_call`` steps with its
losses fetched, as `cmd_fit` runs them (`FontFitter.CHUNK` steps a call
from 200 steps on).

The comparison: the plain reference (`reference.fit`) repeats those
1 + ``steps_per_call`` steps from the same start, in float64
(`reference.fit.readings`: the first step's loss, every step's loss,
and the norms of the first gradient and of the parameters' change over
all the steps, leaf by leaf).

Workload ``params``: ``fit_style``, ``target_style``, ``depth``,
``learning_rate``, ``steps_per_call``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from glyphbench import deploy
from glyphbench.reference import fit as ref_fit


class Driver:
    END_TO_END = ("fit_step_ms",)

    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.cell["params"]
        self.depth = int(p["depth"])
        self.lr = float(p["learning_rate"])
        self.k = int(p["steps_per_call"])
        self.attempts_per_request = self.k  # a request is k steps
        fonts = {f.style: f for f in deploy.fonts(ctx.config, ctx.seed)}
        self.fit_font, self.target_font = fonts[p["fit_style"]], fonts[p["target_style"]]
        if {self.fit_font.generator, self.target_font.generator} != {"text_ttf"}:
            raise ValueError("fit_steps fits text_ttf fonts (the reference's outlines)")
        self.font_dir = os.path.join(ctx.workdir, "fonts")
        self._written = 0
        self.fitter = None

    def setup(self) -> None:
        import torch
        from versatiles_glyphs_tpu_torch.font.entry import FontFileEntry
        from versatiles_glyphs_tpu_torch.models.fitting import PARAM_KEYS, FontFitter, make_fit_batch

        ctx = self.ctx
        with ctx.phase("write_fonts"):
            self._written += deploy.write([self.fit_font, self.target_font], self.font_dir)
        with ctx.phase("make_fit_batch"):
            entries = []
            for f in (self.fit_font, self.target_font):
                with open(os.path.join(self.font_dir, f.filename), "rb") as fh:
                    entries.append(FontFileEntry(fh.read()))
            batch = make_fit_batch(entries[0], self.fit_font.codepoints.tolist(), depth=self.depth,
                                   target_entry=entries[1])
        self.n_glyphs = int(batch.curves0.shape[0])
        with ctx.phase("fitter_init"):
            self.fitter = FontFitter(depth=self.depth, learning_rate=self.lr, backend="flat")
            self.params, self.opt, self.dev_batch = self.fitter.init(batch)
        p0 = {k: self.params[k].detach().double().cpu().numpy().copy() for k in PARAM_KEYS}
        with ctx.phase("first_steps_and_graph_capture"):
            self.params, self.opt, lo1 = self.fitter.step_many(self.params, self.opt,
                                                               self.dev_batch, 1)
            beta1 = self.opt.param_groups[0]["betas"][0]
            # No state: the step never reached Adam (read as a zero gradient).
            grad1 = {k: self.opt.state.get(self.params[k], {}).get(
                "exp_avg", torch.zeros_like(self.params[k])).double().cpu().numpy()
                / (1.0 - beta1) for k in PARAM_KEYS}
            self.params, self.opt, lok = self.fitter.step_many(self.params, self.opt,
                                                               self.dev_batch, self.k)
        delta = {k: self.params[k].detach().double().cpu().numpy() - p0[k] for k in PARAM_KEYS}
        self.first = {"losses": np.concatenate([lo1, lok]).astype(np.float64), "grad1": grad1,
                      "delta": delta}

    def request(self, i) -> int:
        self.params, self.opt, losses = self.fitter.step_many(self.params, self.opt,
                                                              self.dev_batch, self.k)
        if not np.all(np.isfinite(losses)):
            raise FloatingPointError(f"non-finite loss in call {i}")
        return self.k

    def release(self) -> None:
        import gc

        import torch

        self.fitter = self.params = self.opt = self.dev_batch = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def bytes_written(self) -> int:
        return self._written

    def end_to_end(self, requests, t0, t1) -> dict:
        steps = sum(u for _, _, u, ok in requests if ok)
        return {"fit_step_ms": (1e3 * (t1 - t0) / steps, "ms")}

    def counters(self) -> dict:
        return {}

    def wrap_spans(self, spans) -> None:
        import torch

        from versatiles_glyphs_tpu_torch.models import fitting

        spans.wrap(fitting.FontFitter, "step_many", "step_many", main_only=True)
        spans.wrap(fitting.StepGraph, "replay", "graph replay", main_only=True)
        spans.wrap(torch.optim.Adam, "step", "Adam.step", main_only=True)

    # -- the yardstick's view ---------------------------------------------------

    def reference_batch(self):
        if getattr(self, "_ref_batch", None) is None:
            f, t = self.fit_font, self.target_font
            self._ref_batch = ref_fit.build_batch(f.seed, t.seed, len(f.codepoints), f.quads,
                                                  self.ctx.device)
        return self._ref_batch

    def work_per_step(self) -> dict:
        """The least work of one step's min field and backward, from the
        reference's own chords at the start."""
        from glyphbench.frozen import outlines, work

        b = self.reference_batch()
        K = (1 << self.depth) + 1
        t = np.arange(K) / (K - 1)
        m = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t ** 3], axis=1)
        chain = np.einsum("kj,cjd->ckd", m, b.curves)
        segs = np.concatenate([chain[:, :-1], chain[:, 1:]], axis=2).reshape(-1, 4)
        seg_glyph = np.repeat(np.repeat(np.arange(len(b.ncurves)), b.ncurves), K - 1)
        tgt = outlines.prep(deploy.rings(self.target_font))
        return work.fit_step_work(segs, seg_glyph, tgt.width, tgt.height, tgt.y0,
                                  lanes=int(b.ncurves.sum()) * K)

    def check(self, requests) -> dict:
        b = self.reference_batch()
        ref = ref_fit.run_steps(b, 1 + self.k, self.depth, self.lr, self.ctx.device)
        got = ref_fit.readings(self.first, ref)
        print(f"fit check: leaves left out (reference gradient under a thousandth of the median "
              f"leaf's): {got.pop('skipped')}", file=sys.stderr)
        limits = self.ctx.cell["limits"]
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}
