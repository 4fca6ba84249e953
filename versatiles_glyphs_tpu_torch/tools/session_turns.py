"""Warm renders through the render session on the card, in turns.

    python -m versatiles_glyphs_tpu_torch.tools.session_turns \\
        [--font synth_text] [--reps 12] [--parent build/parent]
        [--variant LABEL=DIR ...] [--timeline]

A render is the atlas path below the font parser, as `chip_smoke.py`
phase 4 runs it: a synthesized font's glyphs (`tools.roofline.FONTS`)
in blocks of 256 codepoints through one `Renderer("cuda")` session, the
fused native PBF encode and the directory writer, ended by
`torch.cuda.synchronize()`. ``--parent DIR`` adds the variant
``parent``: the package of another checkout unpacked at DIR (``git
archive``), imported under another name (`kernel_turns.import_parent`),
with its own session, kernels and native library; ``--variant
LABEL=DIR`` adds another such package under its own label (``--parent
DIR`` is ``--variant parent=DIR``). After one untimed
render each, the variants render ``--reps`` times in turns (in order,
then in reverse order), on the host clock: each variant's median,
interquartile range and, beside every other variant, the turns in which
the first variant was faster; then one render each under
`torch.profiler` gives the share of its wall time in which the card ran
a kernel or a copy (the union of the device events' intervals), and the
package's `WIRE_STATS` where it has them. ``--timeline`` adds one more
render each with its stages timed on the host clock (`STAGES`, by the
thread that ran them, from the render's start): where the session's
threads spend a render. The trees of every variant must be equal byte
for byte. JSON lines; raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from ..device import cuda_device
from .roofline import FONTS, emit, nvidia_smi_line


class Variant:
    """A package's render path: its renderer, native library, writer and
    synthesized preps."""

    def __init__(self, label: str, pkg: str, backend: str):
        import importlib

        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.label = label
        self.pkg = pkg
        self.driver = mod("render.driver")
        self.native = mod("proto.native")
        self.writer = mod("writer")
        self.index_files = mod("font.index_files")
        self.synth = mod("utils.synth_font")
        self.native.require()
        self.renderer = self.driver.Renderer(backend)

    def preps(self, font: str) -> list:
        n, first_cp, seed, quads = FONTS[font]
        return self.synth.curved_preps(n, first_cp, seed=seed, quads=quads)

    def render(self, name: str, preps, out_dir: str, sync) -> float:
        """Seconds of one render of ``preps`` as fontstack ``name`` into
        ``out_dir``."""
        blocks: dict[int, list] = {}
        for p in preps:
            blocks.setdefault(p.codepoint >> 8, []).append(p)
        t0 = time.perf_counter()
        w = self.writer.Writer.new_file(out_dir)
        w.write_directory(f"{name}/")
        with self.renderer.start_session() as session:
            for bp in blocks.values():
                session.add([p for p in bp if not p.empty])
            bm_iter = session.results()
            for b, bp in blocks.items():
                rng = f"{b * 256}-{b * 256 + 255}"
                w.write_file(f"{name}/{rng}.pbf",
                             self.native.encode_block_from_preps(name, rng, bp, bm_iter))
        w.write_file("index.json", self.index_files.build_index_json([name]))
        w.finish()
        sync()
        return time.perf_counter() - t0


# (module, attribute, stage) of the functions `timeline` times, where
# the package has them: the packers, the upload, the
# decode, tile table and launch, the fetch, the waits of `results` and
# the PBF encode.
STAGES = (
    ("render.batch", "pack_points_delta", "pack"),
    ("render.batch", "pack_points", "pack"),
    ("render.batch", "plan_tiles", "plan"),
    ("render.batch", "wire_to_device", "upload"),
    ("ops.sdf_cuda", "render_bitmaps_cuda_delta", "render"),
    ("ops.sdf_cuda", "render_bitmaps_cuda_pts", "render"),
    ("render.batch", "DeviceLane.fetch_to_host", "fetch"),
    ("render.driver", "_Group.wait", "wait_fetch"),
    ("proto.native", "encode_block_from_preps", "encode"),
)


@contextlib.contextmanager
def timed_stages(pkg: str, spans: list, t0: list):
    """Within the block, the `STAGES` of package ``pkg`` append
    (thread, stage, start ms, end ms) to ``spans``, from ``t0[0]``.
    Nested stages count in both."""
    import importlib

    undo = []
    for mod_name, attr, stage in STAGES:
        owner = importlib.import_module(f"{pkg}.{mod_name}")
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part, None)
        real = getattr(owner, name, None) if owner is not None else None
        if real is None:
            continue

        def timed(*a, _real=real, _stage=stage, **kw):
            start = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                spans.append((threading.current_thread().name, _stage,
                              1e3 * (start - t0[0]), 1e3 * (time.perf_counter() - t0[0])))

        setattr(owner, name, timed)
        undo.append((owner, name, real))
    try:
        yield
    finally:
        for owner, name, real in reversed(undo):
            setattr(owner, name, real)


def timeline(v, font: str, preps, out_dir: str, sync) -> dict:
    """One render of ``v`` with its stages timed: the render's seconds,
    each (thread, stage)'s summed milliseconds and the spans in order."""
    spans, t0 = [], [0.0]
    with timed_stages(v.pkg, spans, t0):
        t0[0] = time.perf_counter()
        secs = v.render(font, preps, out_dir, sync)
    sums: dict = {}
    for thread, stage, a, b in spans:
        key = f"{thread.split('_')[0]}:{stage}"
        sums[key] = sums.get(key, 0.0) + (b - a)
    return {"seconds": secs, "stage_ms": sums,
            "spans": sorted([t, s, round(a, 3), round(b, 3)] for t, s, a, b in spans)}


def read_tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def device_events(fn) -> tuple:
    """(``fn()``'s result, its device events as (name, start µs, end
    µs)): ``fn`` run under `torch.profiler`, tracing the card where there
    is one (on the CPU the list is empty). The kernels, copies and sets
    the card ran; not the user annotations that the profiler puts on the
    device's timeline (``Optimizer.step#Adam.step`` spans all of
    Adam's kernels and the gaps between them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        got = fn()
    return got, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals: the time in
    which the device ran at least one event."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def busy_share(fn) -> dict:
    """``fn()`` (which returns its seconds) under `torch.profiler`: its
    seconds, the union of the device events' intervals over them, and
    the copies' summed times each way (None where no device event was
    seen, as on the CPU)."""
    secs, events = device_events(fn)
    copy_us = {"HtoD": 0.0, "DtoH": 0.0}
    for name, a, b in events:
        for way in copy_us:
            if "Memcpy" in name and way in name:
                copy_us[way] += b - a
    spans = [(a, b) for _, a, b in events]
    busy = union_us(spans)
    seen = bool(spans)
    return {"seconds_profiled": secs, "device_events": len(spans),
            "device_busy_ms": busy / 1e3 if seen else None,
            "device_busy_share": busy / (secs * 1e6) if seen else None,
            "htod_ms": copy_us["HtoD"] / 1e3 if seen else None,
            "dtoh_ms": copy_us["DtoH"] / 1e3 if seen else None}


def turns(variants, fonts, reps: int, sync, with_timeline: bool = False) -> dict:
    """Time each variant's warm renders of each font in turns; returns
    {font: {label: record}}. Raises if two variants' trees differ."""
    work = tempfile.mkdtemp(prefix="session_turns_")
    res: dict = {}
    try:
        for font in fonts:
            preps = {v.label: v.preps(font) for v in variants}
            trees, times = {}, {v.label: [] for v in variants}
            for v in variants:
                out = os.path.join(work, v.label)
                v.render(font, preps[v.label], out, sync)
                trees[v.label] = read_tree(out)
                shutil.rmtree(out)
            first = variants[0].label
            for v in variants[1:]:
                if trees[v.label] != trees[first]:
                    raise AssertionError(f"{font}: {v.label}'s tree differs from {first}'s")
            for k in range(reps):
                for v in (variants if k % 2 == 0 else variants[::-1]):
                    out = os.path.join(work, f"{v.label}_{k}")
                    times[v.label].append(v.render(font, preps[v.label], out, sync))
                    shutil.rmtree(out)
            res[font] = {}
            for v in variants:
                ts = times[v.label]
                q1, q3 = np.percentile(ts, [25, 75])
                rec = {"seconds_median": statistics.median(ts), "seconds_min": min(ts),
                       "seconds_iqr": float(q3 - q1), "seconds": ts}
                if v is not variants[0]:
                    # Turns in which the first variant rendered faster.
                    rec["turns_first_faster"] = sum(a < b for a, b in zip(times[first], ts))
                wire = getattr(v.driver, "WIRE_STATS", None)
                if wire is not None:
                    v.driver.reset_wire_stats()
                out = os.path.join(work, f"{v.label}_prof")
                rec.update(busy_share(lambda: v.render(font, preps[v.label], out, sync)))
                shutil.rmtree(out)
                if wire is not None:
                    rec["wire_stats"] = dict(wire)
                if with_timeline:
                    rec["timeline"] = timeline(v, font, preps[v.label], out, sync)
                    shutil.rmtree(out)
                res[font][v.label] = rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.session_turns",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--font", choices=sorted(FONTS), action="append")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--parent", metavar="DIR", default=None)
    ap.add_argument("--variant", metavar="LABEL=DIR", action="append", default=[])
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args(argv)

    dev = cuda_device()
    emit({"tool": "session_turns", "step": "device", "device": torch.cuda.get_device_name(dev),
          "nvidia_smi": nvidia_smi_line()})
    variants = [Variant("this", __package__.rsplit(".", 1)[0], "cuda")]
    others = [v.split("=", 1) for v in args.variant]
    if args.parent:
        others.append(("parent", args.parent))
    for label, root in others:
        from .kernel_turns import import_parent

        import_parent(root, f"vg_{label}")
        variants.append(Variant(label, f"vg_{label}", "cuda"))
    res = turns(variants, args.font or sorted(FONTS), args.reps, torch.cuda.synchronize,
                args.timeline)
    for font, recs in res.items():
        for label, rec in recs.items():
            emit({"tool": "session_turns", "font": font, "variant": label, **rec})
    return res


if __name__ == "__main__":
    main()
