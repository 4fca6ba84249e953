"""Where the time of the render and the fit goes, on the card
(counterparts of the JAX package's ``scripts/profile_tpu.py``,
``scripts/e2e_probe.py`` and ``scripts/e2e_cpuprof.py``).

    python -m versatiles_glyphs_tpu_torch.tools.profile \\
        [all|render|e2e|cpuprof|fit] [--font synth_text] [--quick]

Subcommands (``all``, the default, runs the four in this order), each
printing JSON lines:

- ``render``: the first render group of a synthesized font
  (`tools.roofline.FONTS`) through the main path's stages, each timed on
  the host clock and between CUDA events on the current stream: pack
  (with the host's lane-run check), upload, the i8 decode and the tile
  table, kernel 1, fetch; then `Renderer.render_bitmaps` of the whole
  font end to end, warm.
- ``e2e``: `FontManager.render_glyphs` over K copies of the font
  (`utils.synth_font.SynthEntry`, which has no ``prep_cores``, so the
  manager preps glyph by glyph, not by a real font's font-level cores)
  into a dummy writer, in turns with the device-only
  `Renderer.render_bitmaps` of the same preps K times: seconds a font
  of each side and their paired ratio.
- ``cpuprof``: one ``e2e`` manager run under cProfile of the caller's
  thread: wall and CPU seconds a font, and the top 22 frames by own
  time.
- ``fit``: 10 warm steps each of the graphed one-device ``flat`` step,
  the graphed sharded ``flat`` step over the card listed twice
  (`models.fitting.ShardedStepGraph`), the eager sharded step and the
  padded `batch_loss_kernel` step (eager): the host wall a step, and
  under `torch.profiler` the device-busy share (the union of the device
  events' intervals over the profiled wall, `session_turns.union_us`;
  also the busy time over the unprofiled wall, as the profiler slows
  the host), the device time a step and the device events a step by
  name.

``--quick`` keeps every size but runs fewer repetitions and two fonts in
``e2e`` (``chip_smoke.py`` runs it). It runs on the first CUDA device
and raises without one; `main` returns the records.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import os
import pstats
import statistics
import time
from collections import Counter

import torch

from ..device import cuda_device
from .roofline import FONTS, TP, emit, first_group, font_preps, nvidia_smi_line
from .session_turns import device_events, union_us

FIT_DEPTH = 3
FIT_STEPS = 10
TOP_FRAMES = 22
# name -> (render reps, manager fonts K, e2e pairs, fit runs)
SIZES = {"full": (10, 8, 4, 3), "quick": (3, 2, 1, 1)}


class StageTimer:
    """Milliseconds of named stages, run after run: on the host clock
    and, with ``cuda``, between CUDA events recorded on the current
    stream at each stage's start and end (what the card ran of it)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.host: dict = {}
        self.events: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        if ev is not None:
            ev[1].record()
            self.events.setdefault(name, []).append(ev)
        self.host.setdefault(name, []).append(1e3 * (t1 - t0))

    def records(self) -> list:
        """One record a stage, in the order first run, leaving out the
        first run (warm-up): the host and device medians (the device's
        None without ``cuda``) and the host times."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for name, host in self.host.items():
            host = host[1:]
            dev = [a.elapsed_time(b) for a, b in self.events[name][1:]] if self.cuda else None
            out.append({"stage": name, "runs": len(host),
                        "host_ms_median": statistics.median(host),
                        "device_ms_median": statistics.median(dev) if dev else None,
                        "host_ms": host})
        return out


def render_stages(preps, dev: torch.device, reps: int) -> list:
    """Stage records (`StageTimer`) of the first render group of
    ``preps`` through the main path on ``dev`` (the session's steps,
    one at a time), ``reps`` runs after one warm-up; the bitmaps of the
    last run must equal the session's."""
    import numpy as np

    from ..ops import sdf_cuda, sdf_torch
    from ..render.batch import pack_points_delta, tile_starts, wire_to_device
    from ..render.driver import Renderer

    group = first_group(preps)
    timer = StageTimer(dev.type == "cuda")
    for _ in range(reps + 1):
        with timer("pack"):
            deltas, words, anchors, meta = pack_points_delta(group)
            starts, T = tile_starts(meta, len(group), TP)
            sdf_cuda.check_lane_runs(deltas.shape[1], meta[:, 4], meta[:, 5], anchors[0])
        with timer("upload"):
            d8, w, a8, m = wire_to_device((deltas, words, anchors, meta), dev)
        with timer("decode_and_tile_table"):
            pts = sdf_torch.dequantize(sdf_torch.reconstruct_delta(d8, a8))
            tmeta = sdf_torch.derive_tmeta(m, TP, T)
        with timer("kernel"):
            out = sdf_cuda.render_bitmaps_cuda_pts(pts, w, tmeta, TP, checked=True)
        with timer("fetch"):
            host = out.cpu().numpy().reshape(-1)
    want = Renderer("cuda" if dev.type == "cuda" else "torch", transport="i8").render_bitmaps(group)
    for g, (s, p) in enumerate(zip(starts, group)):
        if not np.array_equal(host[s * TP : s * TP + p.width * p.height], want[g]):
            raise AssertionError(f"glyph {g} of the staged render differs from the session's")
    return timer.records()


def host_runs(fn, reps: int) -> list:
    """Seconds of ``reps`` calls of ``fn`` after one warm-up."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def synth_entries(font: str, k: int) -> list:
    from ..utils.synth_font import SynthEntry

    n, first_cp, seed, quads = FONTS[font]
    return [SynthEntry(n, first_cp, seed=seed, quads=quads)] * k


def manager_run(entries, renderer) -> tuple[float, float]:
    """(wall, CPU) seconds of one `FontManager.render_glyphs` of
    ``entries``, each its own font, into a dummy writer."""
    from ..font.manager import FontManager
    from ..font.wrapper import FontWrapper
    from ..writer import Writer

    manager = FontManager()
    for i, entry in enumerate(entries):
        manager.fonts[f"synth_{i}"] = FontWrapper()
        manager.fonts[f"synth_{i}"].add_file(entry)
    writer = Writer.new_dummy()
    t0, c0 = time.perf_counter(), time.process_time()
    manager.render_glyphs(writer, renderer)
    writer.finish()
    return time.perf_counter() - t0, time.process_time() - c0


def e2e(font: str, k: int, pairs: int, backend: str) -> dict:
    """The manager over ``k`` copies of ``font`` against the device-only
    render of the same preps ``k`` times, ``pairs`` times in turns after
    one warm-up each: seconds a font and the ratio of each pair."""
    from ..render.driver import Renderer

    renderer = Renderer(backend)
    entries = synth_entries(font, k)
    entry = entries[0]
    preps = [p for p in (renderer.prep_glyph(entry, cp) for cp in entry.metadata.codepoints)
             if p is not None and not p.empty]

    def device_only():
        t0 = time.perf_counter()
        renderer.render_bitmaps(preps * k)
        return (time.perf_counter() - t0) / k

    manager_run(entries, renderer)
    device_only()
    e2e_s, dev_s = [], []
    for _ in range(pairs):
        e2e_s.append(manager_run(entries, renderer)[0] / k)
        dev_s.append(device_only())
    ratios = [e / d for e, d in zip(e2e_s, dev_s)]
    glyphs = len(entry.metadata.codepoints)
    return {"font": font, "fonts": k, "glyphs_a_font": glyphs, "preps_a_font": len(preps),
            "prep": "SynthEntry has no prep_cores: the manager preps glyph by glyph",
            "e2e_s_a_font": e2e_s, "device_only_s_a_font": dev_s, "paired_ratio": ratios,
            "paired_ratio_median": statistics.median(ratios),
            "e2e_glyphs_per_s_best": glyphs / min(e2e_s)}


def top_frames(prof: cProfile.Profile, n: int = TOP_FRAMES) -> list:
    """The ``n`` frames of a finished cProfile run with the most own
    time, as records."""
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"function": f"{'/'.join(path.split(os.sep)[-2:])}:{line}({name})",
             "calls": nc, "primitive_calls": cc, "own_s": tt, "cumulative_s": ct}
            for (path, line, name), (cc, nc, tt, ct, _) in rows]


def cpuprof(font: str, k: int, backend: str) -> dict:
    """One manager run over ``k`` copies of ``font`` unprofiled, then one
    under cProfile of this thread (after a warm-up): wall and CPU
    seconds a font of each, and the profiled run's top frames."""
    from ..render.driver import Renderer

    renderer = Renderer(backend)
    entries = synth_entries(font, k)
    manager_run(entries, renderer)
    wall, cpu = manager_run(entries, renderer)
    prof = cProfile.Profile()
    prof.enable()
    try:
        pwall, pcpu = manager_run(entries, renderer)
    finally:
        prof.disable()
    return {"font": font, "fonts": k, "wall_s_a_font": wall / k, "cpu_s_a_font": cpu / k,
            "profiled_wall_s_a_font": pwall / k, "profiled_cpu_s_a_font": pcpu / k,
            "top_frames": top_frames(prof)}


def short_name(name: str, width: int = 120) -> str:
    """A device event's name without ``void`` and PyTorch's namespaces,
    cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:width]


def steps_record(events, steps: int, seconds: float) -> dict:
    """What a profiled run of ``steps`` steps that took ``seconds`` did
    on the device, from its device events (name, start µs, end µs): the
    busy share (the union of the events' intervals over the wall), busy
    and summed event milliseconds a step, and events a step by
    `short_name`; the device numbers None where no event was seen."""
    seen = bool(events)
    busy = union_us([(a, b) for _, a, b in events])
    by_name = Counter(short_name(name) for name, _, _ in events)
    return {"steps": steps, "profiled_wall_ms_a_step": 1e3 * seconds / steps,
            "device_busy_share": busy / (seconds * 1e6) if seen else None,
            "device_busy_ms_a_step": busy / 1e3 / steps if seen else None,
            "device_event_ms_a_step": sum(b - a for _, a, b in events) / 1e3 / steps
            if seen else None,
            "device_events_a_step": len(events) / steps,
            "device_events_a_step_by_name": {n: c / steps for n, c in sorted(by_name.items())}}


def fit_steps(font: str, dev: torch.device, devices: list, runs: int) -> dict:
    """{variant: record} of `FIT_STEPS` warm steps of each fit step on
    the font's fit batch (see the module docstring): the host wall a
    step (median of ``runs`` runs), peak memory from `init` through the
    warm-up above what was allocated before, the port's kernel launches
    a step (`sdf_cuda.LAUNCHES`),
    and `steps_record` of one more run under `torch.profiler`."""
    from ..models.fitting import FontFitter, batch_loss_kernel
    from ..ops import sdf_cuda
    from ..utils.synth_font import synth_fit_batch

    n, first_cp, seed, quads = FONTS[font]
    batch = synth_fit_batch(n, first_cp, seed=seed, quads=quads, depth=FIT_DEPTH, perturb=0.35)
    one = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    sh = FontFitter(depth=FIT_DEPTH, backend="flat", devices=devices)
    cuda = dev.type == "cuda"

    def eager(fitter):
        def run(p, o, d):
            return torch.stack([fitter.step(p, o, d)[2] for _ in range(FIT_STEPS)]).cpu()
        return run

    def padded(p, o, d):
        losses = []
        for _ in range(FIT_STEPS):
            o.zero_grad(set_to_none=True)
            loss = batch_loss_kernel(p, d, FIT_DEPTH)
            loss.backward()
            o.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu()

    variants = {
        "graphed_one_device": (one, lambda p, o, d: one.step_many(p, o, d, FIT_STEPS)),
        "graphed_sharded": (sh, lambda p, o, d: sh.step_many(p, o, d, FIT_STEPS)),
        "eager_sharded": (sh, eager(sh)),
        "padded_eager": (one, padded),
    }
    res = {}
    for name, (fitter, run) in variants.items():
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        p, o, d = fitter.init(batch)
        run(p, o, d)  # warm-up: captures the graphs
        peak = torch.cuda.max_memory_allocated(dev) - held if cuda else None
        walls = host_runs(lambda: run(p, o, d), runs)
        sdf_cuda.reset_launches()
        run(p, o, d)
        launches = {k: v / FIT_STEPS for k, v in sdf_cuda.LAUNCHES.items() if v}

        def profiled():
            t0 = time.perf_counter()
            run(p, o, d)
            return time.perf_counter() - t0

        seconds, events = device_events(profiled)
        rec = {"variant": name, "glyphs": int(batch.curves0.shape[0]),
               "devices": [str(x) for x in (fitter.devices or [fitter.device])],
               "wall_ms_a_step": 1e3 * statistics.median(walls) / FIT_STEPS,
               "wall_ms_a_step_each": [1e3 * w / FIT_STEPS for w in walls],
               "peak_memory_above_start_bytes": peak, "kernel_launches_a_step": launches,
               **steps_record(events, FIT_STEPS, seconds)}
        # The profiler slows the host, not the card: the device's busy
        # time over the unprofiled wall is the share a user's step sees.
        busy = rec["device_busy_ms_a_step"]
        rec["device_busy_ms_over_unprofiled_wall"] = (
            None if busy is None else busy / rec["wall_ms_a_step"])
        res[name] = rec
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=["all", "render", "e2e", "cpuprof", "fit"])
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    dev = cuda_device()
    reps, k, pairs, runs = SIZES["quick" if args.quick else "full"]
    res: dict = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line(),
                 "font": args.font, "quick": args.quick}
    emit({"tool": "profile", "step": "device", **res})
    todo = ["render", "e2e", "cpuprof", "fit"] if args.what == "all" else [args.what]
    if "render" in todo:
        from ..render.driver import Renderer

        preps = font_preps(args.font)
        res["render"] = render_stages(preps, dev, reps)
        for rec in res["render"]:
            emit({"tool": "profile", "step": "render", **rec})
        renderer = Renderer("cuda")
        secs = host_runs(lambda: renderer.render_bitmaps(preps), reps)
        res["render_bitmaps_s"] = secs
        emit({"tool": "profile", "step": "render_bitmaps", "glyphs": len(preps),
              "seconds_median": statistics.median(secs), "seconds": secs})
    if "e2e" in todo:
        res["e2e"] = e2e(args.font, k, pairs, "cuda")
        emit({"tool": "profile", "step": "e2e", **res["e2e"]})
    if "cpuprof" in todo:
        res["cpuprof"] = cpuprof(args.font, k, "cuda")
        frames = res["cpuprof"]["top_frames"]
        emit({"tool": "profile", "step": "cpuprof",
              **{key: v for key, v in res["cpuprof"].items() if key != "top_frames"}})
        for rank, frame in enumerate(frames):
            emit({"tool": "profile", "step": "cpuprof_frame", "rank": rank, **frame})
    if "fit" in todo:
        res["fit"] = fit_steps(args.font, dev, [dev, dev], runs)
        for rec in res["fit"].values():
            emit({"tool": "profile", "step": "fit", **rec})
    return res


if __name__ == "__main__":
    main()
