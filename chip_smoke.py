#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's atlas render path, its CLI on font files
it writes itself, its outline-fitting path on one device and sharded
(both graphed), the renders over the flat segment layout, the
padded-layout render and fitting loss, the graft entry, the two
measurement tools and the profiling tool once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device (built
for Hopper, sm_90a). It imports the port (`versatiles_glyphs_tpu_torch`),
torch and numpy, and never JAX or the JAX package. Phases, each printing
JSON lines:

1. device — the card's name and power limit (nvidia-smi), its SM count
   and top SM clock.
2. build  — nvcc builds every kernel from ``csrc/``, one process each,
   all at once, and ptxas's report (registers, spills, shared memory)
   of the eight redesigned kernels, Adam's and the fused loss's four is
   printed; g++ builds the
   native host library from ``csrc/vg_native.cpp``
   (`proto.native.require`).
3. kernel — each kernel against its plain PyTorch version on the card,
   at its path's shapes; times both by CUDA events (the kernel by its
   launch alone, and by its wrapper's call with the checks). The render tile
   kernel at group 0 of both fonts (i8 and f32 wires), on degenerate
   segments, on a hand-made chain (a lane run that starts off a
   multiple of 32 with dead lanes inside, a glyph with every lane dead,
   rows of npts <= 1), on glyphs past its crossing lists' sizes and at
   64 pixels a tile: bytes equal. The min-field kernel at the full
   fit batch, on degenerate segments, on the tile kernel's edge inputs
   (the hand-made chain, the glyphs past the crossing lists' sizes, 64
   pixels a tile) and on a glyph whose lanes 8 and 308 are one segment
   (the tie goes to 8, across staged chunks): d² bit-equal, winding and
   argmin exact. The backward kernel at the full fit batch, at the heavy
   font's (also in passes of 64 lanes and at 128 threads a block), on a
   cotangent past w·h, one lane winning every pixel of a glyph, argmins
   outside their glyph's run, runs off a multiple of 32, runs of npts
   <= 1 and the degenerate plan's sentinels: 0 bits from the sum in
   pixel order (`sdf_torch.min_field_bwd_pts_ordered`), within
   1e-4·max|dpts| of the plain version (whose scatter-add on the card
   sums in no fixed order), and bit-identical across two runs; the flat
   field's forward and backward on the host clock with the wrappers'
   checks at every call and with the plan checked once, in turns. The two
   segment-layout render kernels at group 0 of both fonts (packed by
   ``pack_flat``), on degenerate segments, on glyphs past the crossing
   lists' sizes, at 64 and 32 pixels a tile and, for the grid kernel,
   at eight pixel tiles a glyph with a bitmap under one tile: bytes
   equal, and each glyph's bytes against the point-chain kernel's and
   its split variant's on the f32 wire (the split variant keeps the
   per-pair loop that the three render kernels no longer run) and the
   grid kernel's against the flat tile kernel's. The
   padded min-field kernel at the full fit batch, on a degenerate
   padded case and at its edges (masks with holes, a pixel count that
   no block size divides, a bitmap too narrow and a row too crossed for
   the crossing lists, more segments than a staged chunk with a tie
   across chunks, an all-masked glyph): d² bit-equal, winding and
   argmin exact; its backward at the full fit batch, at the heavy
   font's (352 segments a glyph), on the same edge inputs with the
   forward kernel's argmin and a cotangent not masked past w·h, on a
   glyph whose every pixel has one argmin segment, on 4,096 pixels a
   glyph (two warps a glyph), on argmins that name no segment, and
   with the segments walked in chunks and four warps a glyph:
   within 1e-4·max|dsegs|, bit-identical across two runs and, with one
   warp a glyph, bit-identical to the sum in pixel order
   (`sdf_torch.min_field_padded_bwd_ordered`). The ALU
   roof kernel on group 0's grid: bit-equal to its plain version. The
   split variant of the tile kernel at group 0 (i8 and f32 wires), on
   degenerate segments and on the tile kernel's edge cases: bytes equal
   to its plain version and to the tile kernel's. The fused flat-fit
   loss's four kernels (`ops.flat_loss`: the chain, the loss, its
   backward with a per-glyph and with a broadcast cotangent, the chain's
   backward) at the full fit batch with translate and gain moved off
   the start: bit-equal to their plain versions on CPU copies of the
   same inputs and across two runs.
4. slice  — two synthesized fonts at real sizes (a text font of 1,700
   glyphs over 7 blocks, a heavy one of 1,150 glyphs of ~1,000 points)
   through the port's renderer, pipelined render session (each group's
   launch and fetch queued without a host wait, copies on their own
   streams from pinned staging), native PBF encode and writer, with the launch
   counts reset just before. Every PBF is held against the exact f64
   renderer (integer metrics equal, bitmaps within 1 on at most 5 % of
   pixels) and one block against the ``torch`` backend on the CPU byte
   for byte. A warm render runs under `torch.profiler`: the card's busy
   share of its wall time, the copies' times, `WIRE_STATS` and the rates
   they imply, and no session thread left after it. Then the session's
   several-device path with the one card listed twice as the local
   devices (`parallel.mesh.data_devices` patched; two lanes, each
   with its streams; the bins of `Renderer._lpt_rounds`): its tree must
   equal the one-device tree byte for byte, one launch a group. Then
   both fonts whole through each segment-layout render kernel (one
   launch each a font), held against the exact renderer to the same
   bound. Then both fonts through the ``padded`` renderer (the JAX
   ``jax``: `render.batch.pack_block` and
   `ops.sdf_torch.render_bitmaps_padded`, torch ops on the card, no
   kernel): against the exact renderer to the same bound, seconds a
   font (first and the median of three warm), glyphs/s and
   `torch.cuda.max_memory_allocated`; each font's largest block at chunk
   budgets of 2^24 to 2^30 pairs (bytes equal at each, CUDA events, peak
   memory); the heavy font's last block against the same renderer on
   the CPU, byte for byte.
4b. cli   — the port's CLI as a user runs it, on font files the port
   writes without fontTools (`utils.synth_font.build_ttf_curved`: the
   text and heavy fonts, and eight text fonts of their own families and
   seeds). Each command runs as ``python -m versatiles_glyphs_tpu_torch``
   in an interpreter whose import system refuses fontTools, JAX and the
   JAX package: ``merge`` of each font (``--renderer auto``, kernel 1 on
   the i8 wire) against the same CLI's ``--renderer exact`` tree (files
   equal, integer metrics equal, bitmaps within 1 on at most 5 % of
   pixels) with ``debug``'s rows of both trees equal (``debug`` runs in
   this process); ``recurse --tar`` over the eight fonts (eight
   fontstacks, ``index.json`` and ``font_families.json``; every entry
   equal to the directory run's file); ``fit --backend flat --render``
   of the text font's 1,700 glyphs toward the first of the eight
   fonts' bitmaps (``--target-font``), 20 steps (the loss descends;
   ``debug`` reads the fitted atlas). Then the same merges and fit in this process through
   `cli.main`, with the counts reset: seconds a font, first and the
   median of three warm (kernel 1 twice a text font, its two groups),
   the host seconds of `make_fit_batch`, seconds a step through the
   CLI, the flat step's six kernels counted as in phase 5 (23 in 20
   steps).
   Then OTFs written without fontTools (`utils.synth_font`): a CJK font
   of 27,584 glyphs over U+3400-4DBF and U+4E00-9FFF (108 blocks), a
   CID-keyed CFF (`build_otf_curved`), and its CFF2 twin with blends
   (`build_otf2_curved`); ``merge`` of the CJK font against the same
   CLI's exact tree (the contract above), the twin's tree byte-equal to
   it; two small TTFs whose only unicode cmap subtable is of format 13
   and of format 2, merged against their exact trees. In this process:
   the host seconds of the CJK font's parse and prep cores, the twin's
   `outline_curves` bit-equal to the CFF font's for every glyph, the
   CJK merge's seconds (first and the median of three warm) with
   kernel 1's launches equal to the render groups (`driver.WIRE_STATS`),
   and lanes, tiles and flattened points a glyph.
5. fit    — a self-fit of the text font's 1,700 glyphs at depth 3 from
   a perturbed start (`utils.synth_font.synth_fit_batch`): 20 Adam steps
   of the ``flat`` backend through `FontFitter.step_many`, which
   captures a CUDA graph of the forward and backward (`StepGraph`) and
   replays it a step, with the counts reset just before (the step's six
   kernels, kernels 2 and 3 and the fused loss's four, launch once in
   each of the graph's warm-up runs, are recorded once into the graph,
   and are counted once a replay: 10 more steps count 10 each, and the
   Adam kernel once a step; the loss descends; peak
   memory); the Adam kernel (`ops.adam`) at the fit cell's leaves
   (1,686 × 16 curves, 1,686 translations, the gain): three steps bit-equal
   to its plain version on CPU copies, and one step's time on the card
   (queued behind a sleep, and from a CUDA graph) beside its plain
   version's, `torch.optim.Adam`'s foreach step's (``library_ms``), the
   host's enqueue of both and its bytes bound; 10 graphed steps against
   10 eager `step` calls, bit for bit in parameters and losses, for the
   ``flat`` backend at full size and the ``torch`` backend on the first
   256-codepoint block (the pair-tensor loss captured too), with each
   one's peak memory; the warm step graphed against eager in turns;
   5 + 5 steps through a checkpoint against 10 (Δ = 0), into a fresh
   init and back into the same tensors (the graph kept); the ``torch``
   and ``flat`` backends' loss and gradients on the first 256-codepoint
   block; the open ends of the fitted float64 chains that a pixel row's
   crossing rule decides apart in float64 and in f32; the fitted atlas
   (the fit's own f32 chains) through the ``cuda`` renderer (f32 wire)
   against the exact one; seconds per step, warm. Then 20 Adam steps of the
   padded-layout loss `models.fitting.batch_loss_kernel` on its own batch
   (`padded_batch`) from the same start (each padded kernel and the Adam
   kernel launch once a step, the loss descends), and its loss and
   gradients against the ``torch`` backend's on the first 256-codepoint
   block.
6. sharded_fit — the fit of phase 5 sharded over the one card listed
   twice (`FontFitter(devices=[cuda:0, cuda:0])`, 850 glyphs a shard,
   each with its own flat plan): one loss and gradient against the
   one-device fitter (loss within 1e-6 relative, gradients within
   1e-5·max|g|); 20 Adam steps through `step_many`, which captures one
   CUDA graph a shard (`ShardedStepGraph`), with the counts reset just
   before (the loss descends; the step's six kernels launch 2 × (20 + 3):
   each shard's 3 warm-up runs, then one launch a shard a replay; the
   Adam kernel once a step) and 10 more (exactly 2 a step); one replay of a fresh graph against the
   one-device fitter (the same tolerances; each shard's capture
   recorded each of the six once); 10 steps against 10 on one device
   (losses within 1e-5 relative, parameters within 1e-3 px); 5 + 5
   steps through a checkpoint against 10 (Δ = 0), into a fresh init
   and back into the same tensors (the graph kept); seconds a step
   warm in 8 turns each: graphed sharded, eager sharded and the graphed
   one-device step (its graph captured before the turns). The same for
   `make_sharded_kernel_loss` against `batch_loss_kernel` on their own
   batches (eager; kernels 4 and 5 twice a step). Then 10 graphed sharded steps
   against 10 eager sharded `step` calls, bit for bit in parameters and
   losses, with each one's peak memory: the ``flat`` backend at full
   size and the ``torch`` backend on block 0. Then the graft entry
   (`__graft_entry_torch__.py`): `entry()` (kernel 1 once, its bytes
   equal to `sdf_torch.render_tiles_pts` on the same wire) and
   `dryrun_multichip(2)` (finite losses, kernels 2 and 3 once a shard,
   the render over the card listed twice equal to the one-device
   render).
7. tools  — `tools.roofline.main` and `tools.kernel_ab.main` on the text
   font, with the launch counts reset just before: the tile kernel
   against the measured ALU and copy roofs and against its split
   variant.
8. profile — `tools.profile.main(["--quick"])`: the render group's
   stages (host clock and CUDA events), the manager over two copies
   of the text font against the device-only render, cProfile's top
   frames, and 10 warm steps each of the graphed one-device, graphed
   sharded, eager sharded and padded fit steps under `torch.profiler`
   (device-busy share, device time and events a step).

Phases 4-8 enter below the font parser with synthesized outlines (the
same outlines as phase 4b's font files, whose parse the CPU tests hold
against the JAX package); phase 4b enters through the CLI.
Then a ``{"kernels": [...]}`` line (the fourteen kernels, each with its
launches on its path, kernel 1's in phases 4 and 4b, its time by CUDA events over back-to-back launches
and replayed from a CUDA graph, its plain version's time and its bound:
the larger of its f32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s, counted from this run's inputs by `tools.work`; the ALU roof
kernel also with its share of the un-fused issue rate, SMs × 128 × the
top SM clock read in phase 1), and last ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
T_START = time.perf_counter()  # before torch is imported

import numpy as np  # noqa: E402
import torch  # noqa: E402

TP = 256
FIT_DEPTH = 3
FIT_STEPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, *fmt) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> tuple[int, float]:
    """Print the card's name and power limit; return its SM count and
    top SM clock (MHz), the yardstick of the ALU roof's issue rate."""
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock = float(nvidia_smi("clocks.max.sm", ",nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "sms": sms, "sm_clock_max_mhz": clock,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return sms, clock


def phase_build() -> None:
    from versatiles_glyphs_tpu_torch.ops import _build, sdf_cuda

    t0 = time.perf_counter()
    _build.build_all(sdf_cuda.KERNELS)
    for name in sdf_cuda.KERNELS:
        _build.load(name)
        so, nvcc_s = _build.BUILDS[name]
        emit({"phase": "build", "kernel": name, "arch": "sm_90a",
              "so": os.path.relpath(so, ROOT), "nvcc_s": nvcc_s})
    emit({"phase": "build", "all_s": time.perf_counter() - t0})
    # What ptxas said of the eight redesigned kernels, Adam's and the fused
    # loss's (-Xptxas -v).
    for name in ("sdf_tiles_pts", "sdf_grid_flat", "sdf_tiles_flat", "sdf_min_field_padded",
                 "sdf_min_field_pts", "sdf_min_field_padded_bwd", "sdf_min_field_bwd",
                 "sdf_tiles_pts_acc", "adam_flat", "flat_chain_fwd", "flat_loss_fwd",
                 "flat_loss_bwd", "flat_chain_bwd"):
        so = _build.BUILDS[name][0]
        emit({"phase": "build", "kernel": name, "ptxas": _build.ptxas_report(so)})
    from versatiles_glyphs_tpu_torch.proto import native

    t0 = time.perf_counter()
    native.require()
    emit({"phase": "build", "native": os.path.relpath(native.library_path(), ROOT),
          "gxx_s": time.perf_counter() - t0})


def fonts():
    """(name, preps) of the two synthesized fonts: host prep done once,
    outside every timed region."""
    from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

    return [
        ("synth_text", curved_preps(1700, 32, seed=0, quads=8)),
        ("synth_heavy", curved_preps(1150, 0x600, seed=1, quads=24)),
    ]


def bound_of(ops, nbytes) -> dict:
    """The ``bound_ms`` and ``bound_by`` of the kernels line, with the
    counts they come from."""
    from versatiles_glyphs_tpu_torch.tools import work

    ms, by = work.bound(ops, nbytes)
    return {"bound_ms": ms, "bound_by": by, "f32_ops": int(ops), "bytes": int(nbytes)}


def row_shared_bound_of(wk) -> dict:
    """`bound_of` a kernel's `tools.work.row_shared_work`, with the
    counts of the row-shared crossing test it comes from and, for
    comparison with bounds stated at 22 operations a pair, that bound."""
    from versatiles_glyphs_tpu_torch.tools import work

    return {**bound_of(wk["f32_ops"], wk["bytes"]),
            **{key: wk[key] for key in ("pairs", "pixels", "row_tests", "crossings", "crossing_pixels")},
            "f32_ops_a_pair": wk["f32_ops"] / max(wk["pairs"], 1),
            "bound_ms_at_22_ops_a_pair": work.bound(wk["f32_ops_per_pair_test"], wk["bytes"])[0]}


def degenerate_preps():
    from versatiles_glyphs_tpu_torch.render.metrics import GlyphPrep

    segs = np.array([
        [5.0, 5.0, 5.0, 5.0], [5.0, 5.0, 15.0, 5.0], [15.0, 5.0, 15.0, 15.0],
        [15.0, 15.0, 5.0, 15.0], [5.0, 15.0, 5.0, 5.0], [9.5, 9.5, 9.5, 9.5],
    ])
    box = GlyphPrep(codepoint=65, advance=20, empty=False, width=22, height=22,
                    x0=-1, y0=-1, x1=21, y1=21, segments=segs)
    rings = GlyphPrep(codepoint=66, advance=20, empty=False, width=20, height=20,
                      x0=0, y0=0, x1=20, y1=20,
                      rings_px=[np.array([[3.0, 3.0], [12.0, 3.0], [12.0, 12.0], [3.0, 3.0]]),
                                np.array([[6.0, 6.0], [6.0, 6.0], [7.0, 6.0]])])
    return [box, rings]


def graph_ms(fn, reps: int) -> float:
    """`tools.roofline.graph_ms`: ``fn``'s launches replayed from a CUDA
    graph, the card's time without the host's enqueue in it."""
    from versatiles_glyphs_tpu_torch.tools.roofline import graph_ms as replayed_ms

    return replayed_ms(fn, reps)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> tuple[float, bool]:
    """Mean milliseconds of ``fn()`` on the card, back to back: the
    ``reps`` calls are queued behind a sleeping kernel that outlasts
    their enqueue, so CUDA events time the card even where the host
    enqueues slower than the card runs and the calls cannot be captured
    into a graph (`torch.optim.Adam.step`). Also whether the card was
    still asleep when the host had queued them all (else host gaps may
    be inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 10**6)  # ~2x the enqueue at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    whole = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, whole


def adam_kernel(dev) -> dict:
    """The Adam kernel (`ops.adam`, ``csrc/adam_flat.cu``) at the fit
    cell's leaves (1,686 glyphs of at most 16 curves: curves, translate,
    log_gain): three steps bit-equal to the plain version on CPU copies,
    and the time of one step by the kernel (queued behind a sleep, and
    replayed from a CUDA graph), by its plain version on the card, and
    by `torch.optim.Adam`'s foreach step (``library_ms``), with the
    host's enqueue of each and the bytes bound."""
    from versatiles_glyphs_tpu_torch.ops import adam

    rng = np.random.default_rng(18)
    shapes = [(1686, 16, 4, 2), (1686, 2), ()]
    host = [torch.from_numpy(rng.normal(0, 5, sh).astype(np.float32)) for sh in shapes]
    grads = [torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)) for sh in shapes]

    def leaves(device, **kw):
        ps = [t.to(device, copy=True).requires_grad_() for t in host]
        for p, g in zip(ps, grads):
            p.grad = g.to(device, copy=True)
        return ps, torch.optim.Adam(ps, lr=0.01, **kw)

    pk, ok = leaves(dev)
    pc, oc = leaves("cpu")
    for _ in range(3):
        adam.adam_step(ok)
        adam.adam_step(oc)
    pairs = [(a, b) for x, y in zip(pk, pc)
             for a, b in ((x, y), *zip(ok.state[x].values(), oc.state[y].values()))
             if a.device.type == "cuda"]
    err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in pairs)
    equal = all(np.array_equal(a.detach().cpu().numpy().view(np.int32),
                               b.detach().numpy().view(np.int32)) for a, b in pairs)

    n = sum(p.numel() for p in pk)
    bound = bound_of(n * adam.OPS_PER_ELEMENT, n * adam.BYTES_PER_ELEMENT)
    ms, whole = queued_ms(lambda: adam.adam_step(ok), 200)
    plain_leaves = [(p.detach(), p.grad, *ok.state[p].values()) for p in pk]
    scalars = adam.step_scalars(0.01, (0.9, 0.999), 1e-8, 5.0)

    def plain():
        for p, g, _, m, v in plain_leaves:
            adam.adam_update_plain(p, g, m, v, scalars)

    _, ol = leaves(dev, foreach=True)
    # 100 steps: seven launches each stay inside the card's queue of
    # pending launches, so the host never waits on it while the card sleeps.
    library_ms, library_whole = queued_ms(ol.step, 100)

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        return us

    rec = {"phase": "fit", "step": "adam_kernel", "leaves": [list(sh) for sh in shapes],
           "elements": n, "bit_equal_3_steps": equal, "max_abs_err": err,
           "ms": ms, "queued_whole": whole, "graph_ms": graph_ms(lambda: adam.adam_step(ok), 200),
           "plain_ms": time_ms(plain, 50), "library_ms": library_ms,
           "library_queued_whole": library_whole,
           "host_us_a_step": host_us(lambda: adam.adam_step(ok)),
           "library_host_us_a_step": host_us(ol.step), **bound}
    emit(rec)
    if not equal:
        raise AssertionError(f"the Adam kernel differs from its plain version by {err}")
    return rec


def tile_kernel_edge_cases(preps, dev) -> dict:
    """Inputs of the render tile kernel beside the fonts' groups, on the
    card: key -> (pts, mask words, tile table [8, T], TP). A hand-made
    chain whose glyph starts off a multiple of 32 with dead lanes
    inside, with an all-dead glyph and rows of npts <= 1; glyphs past
    the crossing lists' sizes (too many rows, too many crossings); and
    a tile size other than 256."""
    from versatiles_glyphs_tpu_torch.render.batch import pack_points, plan_tiles, tile_starts, wire_to_device
    from versatiles_glyphs_tpu_torch.utils.synth_font import row_list_edge_preps, unaligned_point_chain

    cases = {"unaligned": (*wire_to_device(unaligned_point_chain(), dev), TP)}
    for key, gp, tp in (("row_list_edges", row_list_edge_preps(), TP),
                        ("tp64", preps[:48] + row_list_edge_preps(), 64)):
        pts, pw, pm = pack_points(gp, dtype=np.float32, arena_tag="edge_" + key)
        tm = plan_tiles(gp, pm, tp, T_pad=tile_starts(pm, len(gp), tp)[1])[0]
        cases[key] = (*wire_to_device((pts, pw, tm.T), dev), tp)
    return cases


def phase_kernel(preps, heavy) -> dict:
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.tools import work
    from versatiles_glyphs_tpu_torch.tools.roofline import first_group
    from versatiles_glyphs_tpu_torch.render.batch import (
        pack_points, pack_points_delta, plan_tiles, tile_starts, wire_to_device,
    )

    dev = torch.device("cuda", 0)
    group = first_group(preps)
    G = len(group)
    cases = {}

    deltas, words, anchors, meta = pack_points_delta(group)
    _, T = tile_starts(meta, G, TP)
    d, w, a, m = wire_to_device((deltas, words, anchors, meta), dev)
    cases["i8"] = (
        lambda: sdf_cuda.render_bitmaps_cuda_delta(d, w, a, m, TP, T_pad=T),
        lambda: sdf_torch.render_tiles_pts(
            sdf_torch.dequantize(sdf_torch.reconstruct_delta(d, a)), w,
            sdf_torch.derive_tmeta(m, TP, T), TP),
    )
    f32_inputs = f32_work = heavy_inputs = None
    for key, gp in (("f32", group), ("degenerate", degenerate_preps()),
                    ("f32_heavy", first_group(heavy))):
        pts, pw, pm = pack_points(gp, dtype=np.float32, arena_tag=key)
        tm = plan_tiles(gp, pm, TP, T_pad=tile_starts(pm, len(gp), TP)[1])[0]
        p_d, pw_d, tm_d = wire_to_device((pts, pw, tm.T), dev)
        f32_inputs = f32_inputs or (p_d, pw_d, tm_d)
        if key == "f32":
            f32_work = work.row_shared_work(pts, tm.T, TP, pw)
        if key == "f32_heavy":
            heavy_inputs = (p_d, pw_d, tm_d)
        cases[key] = (
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d: sdf_cuda.render_bitmaps_cuda_pts(p_d, pw_d, tm_d, TP),
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d: sdf_torch.render_tiles_pts(p_d, pw_d, tm_d, TP),
        )
    for key, (p_d, pw_d, tm_d, tp) in tile_kernel_edge_cases(group, dev).items():
        cases[key] = (
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d, tp=tp: sdf_cuda.render_bitmaps_cuda_pts(p_d, pw_d, tm_d, tp),
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d, tp=tp: sdf_torch.render_tiles_pts(p_d, pw_d, tm_d, tp),
        )

    max_err = 0
    for key, (kern, plain) in cases.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.uint8:
            raise AssertionError(f"{key}: kernel {tuple(got.shape)} {got.dtype} "
                                 f"vs plain {tuple(want.shape)} {want.dtype}")
        err = (got.int() - want.int()).abs()
        mismatches = int((err > 0).sum())
        max_err = max(max_err, int(err.max()) if err.numel() else 0)
        rec = {"phase": "kernel", "case": key, "tiles": int(got.shape[0]), "TP": int(got.shape[1]),
               "mismatches": mismatches, "max_abs_err": int(err.max()) if err.numel() else 0,
               "nonzero_bytes": int((got > 0).sum())}
        if key in ("i8", "f32"):
            rec["glyphs"] = G
            rec["lanes"] = int(sum(p.npts for p in group))
            rec["kernel_ms"] = time_ms(kern, 20)
            rec["plain_ms"] = time_ms(plain, 3)
        emit(rec)
        if mismatches or not rec["nonzero_bytes"]:
            raise AssertionError(f"{key}: kernel and plain version differ on {mismatches} bytes")
    # The all-dead glyph and the rows of npts <= 1 and past w*h are zeros.
    if bool(cases["unaligned"][0]()[2:].any()):
        raise AssertionError("unaligned: a row with no live segment is not zeros")

    # The tile kernel on the f32 wire: the numbers of the kernels line.
    # "ms" is the launch alone; "call_ms" adds the wrapper's checks.
    kern, plain = cases["f32"]
    rec = {"phase": "kernel", "kernel": "sdf_tiles_pts", "case": "f32",
           "ms": time_ms(lambda: sdf_cuda.launch_tiles_pts(*f32_inputs, TP), 50),
           "graph_ms": graph_ms(lambda: sdf_cuda.launch_tiles_pts(*f32_inputs, TP), 50),
           "call_ms": time_ms(kern, 50), "plain_ms": time_ms(plain, 3)}
    rec.update(pixels_per_thread=sdf_cuda.pixels_per_thread(TP),
               ms_synth_heavy=time_ms(lambda: sdf_cuda.launch_tiles_pts(*heavy_inputs, TP), 50),
               **row_shared_bound_of(f32_work))
    emit(rec)
    return {"max_abs_err": max_err, **rec}


def fit_batch():
    """The fit phase's batch: every glyph of the text font, perturbed
    start; host work done once, outside every timed region."""
    from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

    return synth_fit_batch(1700, 32, seed=0, quads=8, depth=FIT_DEPTH, perturb=0.35)


def heavy_fit_batch():
    """The heavy font's fit batch (1,150 glyphs, 352 segments a glyph at
    depth 3), for the padded backward kernel at that size."""
    from versatiles_glyphs_tpu_torch.utils.synth_font import synth_fit_batch

    return synth_fit_batch(1150, 0x600, seed=1, quads=24, depth=FIT_DEPTH, perturb=0.35)


def eager_losses(loss_fn, params, opt, db, k: int):
    """The losses of ``k`` eager Adam steps (`models.fitting.eager_step`)."""
    from versatiles_glyphs_tpu_torch.models.fitting import eager_step

    return torch.stack([eager_step(loss_fn, params, opt, db) for _ in range(k)]).cpu().numpy()


def first_block(batch):
    """The fit batch's glyphs of the first 256-codepoint block."""
    rows = batch.codepoints < 256
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rows] for f in dataclasses.fields(batch)})


def fit_inputs(batch, dev):
    """The flat backend's kernel inputs at the start of the fit: the
    point chain [2, N], mask words and tile table on the card."""
    from versatiles_glyphs_tpu_torch.models import fitting

    fitter = fitting.FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    params, _, db = fitter.init(batch)
    with torch.no_grad():
        pts = fitting.flat_chain_points(params["curves"], params["translate"], FIT_DEPTH,
                                        db["chunk_map"]).contiguous()
    return pts, db["plan_words"], db["plan_tmeta"]


def phase_fit_kernels(batch, heavy_batch, preps) -> dict:
    """Kernels 2 and 3 against their plain versions at the fit's shapes;
    kernel 2 also on degenerate segments, on the render tile kernel's
    edge inputs (`tile_kernel_edge_cases`: it shares that kernel's
    staging and crossing lists) and on a tie across staged chunks
    (`utils.synth_font.tied_point_chain`). Kernel 3 on kernel 2's argmin
    at the fit batch (the cotangent masked past w·h, as the loss masks
    it), at the heavy font's (~400 lanes a glyph, also in passes of 64
    lanes and at 128 threads a block), on the degenerate plan's
    sentinels and on `utils.synth_font.FLAT_BWD_EDGE_CASES` (a
    cotangent over every pixel, one lane winning every pixel of a glyph,
    argmins outside their glyph's run, runs off a multiple of 32, runs
    of npts <= 1): 0 bits from the sum in pixel order
    (`sdf_torch.min_field_bwd_pts_ordered`), within 1e-4·max of the
    plain version and bit-identical across two runs. Returns the numbers
    of the kernels line."""
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.render.batch import wire_to_device
    from versatiles_glyphs_tpu_torch.tools import work
    from versatiles_glyphs_tpu_torch.tools.roofline import first_group
    from versatiles_glyphs_tpu_torch.utils.synth_font import (
        FLAT_BWD_EDGE_CASES, degenerate_fit_plan, flat_bwd_edge_case, tied_point_chain,
    )

    dev = torch.device("cuda", 0)
    pts, words, tmeta = fit_inputs(batch, dev)
    plan, dpts_ = degenerate_fit_plan()
    cases = {"fit": (pts, words, tmeta, TP),
             "degenerate": (*(t.to(dev) for t in (dpts_, torch.as_tensor(plan.mask_words),
                                                  torch.as_tensor(plan.tmeta.T.copy()))), TP),
             **tile_kernel_edge_cases(first_group(preps), dev),
             "tied": (*wire_to_device(tied_point_chain(), dev), TP)}
    out = {}
    for key, (p, w, tm, tp) in cases.items():
        got = sdf_cuda.min_field_cuda_pts(p, w, tm, tp)
        want = sdf_torch.min_field_pts(p, w, tm, tp)
        torch.cuda.synchronize()
        d2_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        wn_off = int((got[1] != want[1]).sum())
        am_off = int((got[2] != want[2]).sum())
        rec = {"phase": "kernel", "kernel": "sdf_min_field_pts", "case": key,
               "tiles": int(tm.shape[1]), "lanes": int(p.shape[1]), "TP": tp,
               "pixels_per_thread": sdf_cuda.min_field_pixels_per_thread(tp),
               "d2_bits_differ": d2_bits, "wn_differ": wn_off, "am_differ": am_off,
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "sentinels": int((got[2] == sdf_torch._BIGI).sum())}
        if key == "fit":
            rec["kernel_ms"] = out["min_ms"] = time_ms(
                lambda: sdf_cuda.launch_min_field_pts(p, w, tm, TP), 50)
            rec["graph_ms"] = out["min_graph_ms"] = graph_ms(
                lambda: sdf_cuda.launch_min_field_pts(p, w, tm, TP), 50)
            rec["call_ms"] = time_ms(lambda: sdf_cuda.min_field_cuda_pts(p, w, tm, TP), 50)
            rec["plain_ms"] = out["min_plain_ms"] = time_ms(
                lambda: sdf_torch.min_field_pts(p, w, tm, TP), 3)
            out["min_err"] = rec["max_abs_err"]
            wk = work.row_shared_work(p.cpu().numpy(), tm.cpu().numpy(), TP, w.cpu().numpy(),
                                      out_bytes_per_pixel=12, pixel_ops=0)
            out["min_bound"] = row_shared_bound_of(wk)
            rec.update(out["min_bound"])
        emit(rec)
        if d2_bits or wn_off or am_off:
            raise AssertionError(f"min field {key}: kernel and plain version differ")
        if key in ("degenerate", "unaligned") and not rec["sentinels"]:
            raise AssertionError(f"{key} case: no sentinel pixel")
        # The row past w*h is zeros in all three outputs.
        if key == "unaligned" and any(bool(t[5].any()) for t in got):
            raise AssertionError("unaligned: the row past w*h is not zeros")
        if key == "tied" and (int((got[2] == 308).sum()) or not int((got[2] == 8).sum())):
            raise AssertionError("tied: the tie of lanes 8 and 308 is not 8's")

    # Kernel 3: key -> (pts, am from kernel 2, ct, tile table, launch
    # shape (None: the launcher's own)).
    _, _, am = sdf_cuda.min_field_cuda_pts(pts, words, tmeta, TP)
    gen = torch.Generator(device=dev).manual_seed(0)
    ct = torch.randn(am.shape, generator=gen, device=dev)
    i = tmeta[6][:, None] + torch.arange(TP, device=dev)[None, :]
    ct = torch.where(i < (tmeta[2] * tmeta[3])[:, None], ct, 0.0).contiguous()
    bwd = {"fit": (pts, am, ct, tmeta, None)}
    host = [t.cpu().numpy() for t in (pts, am, tmeta)]
    for name in FLAT_BWD_EDGE_CASES:
        bwd[name] = (*(torch.as_tensor(a, device=dev)
                       for a in flat_bwd_edge_case(name, *host, seed=1)), None)
    for key, (p, w, tm) in (("fit_heavy", fit_inputs(heavy_batch, dev)),
                            ("degenerate", cases["degenerate"][:3])):
        a_ = sdf_cuda.min_field_cuda_pts(p, w, tm, TP)[2]
        bwd[key] = (*(torch.as_tensor(a, device=dev) for a in flat_bwd_edge_case(
            "unmasked", p.cpu().numpy(), a_.cpu().numpy(), tm.cpu().numpy(), seed=2)), None)
    # The heavy plan's glyphs (~400 lanes) walked in passes of 64 lanes,
    # and at 128 threads a block (768 lanes a pass).
    bwd["heavy_passes"] = (*bwd["fit_heavy"][:4], (128, 64))
    bwd["heavy_t128"] = (*bwd["fit_heavy"][:4], sdf_cuda.flat_bwd_launch_shape(128))
    for key, (p, a_, c_, tm, shape) in bwd.items():
        if shape is None:
            run = lambda: sdf_cuda.min_field_bwd_cuda(p, a_, c_, tm, TP)
        else:
            run = lambda: sdf_cuda.launch_min_field_bwd(p, a_, c_, tm, TP, shape)
        got, again = run(), run()
        want = sdf_torch.min_field_bwd_pts(p, a_, c_, tm, TP)
        ordered = sdf_torch.min_field_bwd_pts_ordered(p, a_, c_, tm, TP)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        identical = bool(torch.equal(got, again))
        order_bits = int((got.view(torch.int32) != ordered.view(torch.int32)).sum())
        ii = tm[6][:, None] + torch.arange(TP, device=dev)[None, :]
        inside = ii < (tm[2] * tm[3])[:, None]
        rec = {"phase": "kernel", "kernel": "sdf_min_field_bwd", "case": key,
               "tiles": int(tm.shape[1]), "lanes": int(p.shape[1]),
               "launch_shape": list(shape or sdf_cuda.flat_bwd_launch_shape()),
               "sentinels": int((inside & (a_ == sdf_torch._BIGI)).sum()),
               "ct_past_wh": bool(c_[~inside].any()),
               "max_abs_err": err, "max_abs_plain": scale, "tolerance": 1e-4 * scale,
               "bit_identical_rerun": identical, "bits_differ_from_pixel_order": order_bits}
        if key in ("fit", "fit_heavy", "one_wins"):
            rec["kernel_ms"] = time_ms(
                lambda: sdf_cuda.launch_min_field_bwd(p, a_, c_, tm, TP, shape), 50)
            rec["graph_ms"] = graph_ms(
                lambda: sdf_cuda.launch_min_field_bwd(p, a_, c_, tm, TP, shape), 50)
        if key == "fit":
            # Pixels of the bitmaps whose argmin is a live segment; inputs
            # pts, am, ct and the tile table, output dpts.
            n_px = int((inside & (a_ != sdf_torch._BIGI)).sum())
            N, T = p.shape[1], tm.shape[1]
            out["bwd_bound"] = bound_of(n_px * work.BWD_PIXEL_F32_OPS,
                                        8 * N + 8 * T * TP + 32 * T + 8 * N)
            rec.update(argmin_pixels=n_px, **out["bwd_bound"])
            rec["call_ms"] = time_ms(run, 50)
            rec["plain_ms"] = time_ms(lambda: sdf_torch.min_field_bwd_pts(p, a_, c_, tm, TP), 3)
            out.update(bwd_err=err, bwd_ms=rec["kernel_ms"], bwd_graph_ms=rec["graph_ms"],
                       bwd_plain_ms=rec["plain_ms"])
        if key in ("fit_heavy", "one_wins"):
            out["bwd_ms_" + key] = rec["kernel_ms"]
            out["bwd_graph_ms_" + key] = rec["graph_ms"]
        emit(rec)
        if not scale > 0 or err > 1e-4 * scale:
            raise AssertionError(f"backward {key}: off by {err} (plain max {scale})")
        if not identical:
            raise AssertionError(f"backward {key}: differs between two runs")
        if order_bits:
            raise AssertionError(f"backward {key}: {order_bits} values are not the sum in pixel "
                                 "order")
        if key == "degenerate" and not rec["sentinels"]:
            raise AssertionError("degenerate backward case: no sentinel pixel")
        if key in ("unmasked", "fit_heavy") and not rec["ct_past_wh"]:
            raise AssertionError(f"backward {key}: the cotangent past w*h is zero")

    # The flat field's forward and backward on the host clock, with the
    # wrappers' checks at every call (a host sync each) and with the
    # plan checked once, as the fitter runs it: in turns.
    from versatiles_glyphs_tpu_torch.ops.sdf_grad import signed_field_flat
    from versatiles_glyphs_tpu_torch.tools.roofline import host_ms

    sdf_cuda.check_flat_plan(pts.shape[1], words, tmeta, TP)

    def field_and_grad(checked):
        p = pts.clone().requires_grad_()
        (signed_field_flat(p, words, tmeta, TP, checked=checked) * ct).sum().backward()
        return p.grad

    turns = [(c, host_ms(lambda: field_and_grad(c), 10)) for c in (False, True, True, False)]
    same = bool(torch.equal(field_and_grad(False), field_and_grad(True)))
    emit({"phase": "kernel", "kernel": "signed_field_flat", "case": "fit",
          "host_ms_checks_each_call": min(t for c, t in turns if not c),
          "host_ms_plan_checked_once": min(t for c, t in turns if c),
          "turns_ms": [["once" if c else "each_call", t] for c, t in turns],
          "gradients_equal": same})
    if not same:
        raise AssertionError("signed_field_flat: checked and unchecked gradients differ")
    return out


def phase_fused_loss_kernels(batch) -> dict:
    """The fused flat-fit loss's four kernels (`ops.flat_loss`) at the fit
    batch, translate and log_gain moved off the start, each on its
    inputs as a step makes them (kernel 2's field, a random per-glyph
    cotangent, kernel 3's dpts): against its plain version on CPU copies
    of the same inputs bit for bit, and bit-identical across two runs;
    the loss's backward also with a broadcast cotangent (a sum's, stride
    0). Each one's time by CUDA events over back-to-back launches and
    replayed from a CUDA graph, its plain version's on the card and its
    bytes bound (`flat_loss.work`). Returns {kernel: numbers of the
    kernels line}."""
    from versatiles_glyphs_tpu_torch.models.fitting import FontFitter
    from versatiles_glyphs_tpu_torch.ops import flat_loss, sdf_cuda

    dev = torch.device("cuda", 0)
    params, _, db = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev).init(batch)
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.no_grad():
        params["translate"].add_(0.3 * torch.randn(params["translate"].shape, generator=gen,
                                                   device=dev))
        params["log_gain"].fill_(0.05)
    c, t, lg = (params[k].detach() for k in ("curves", "translate", "log_gain"))
    rows, cmap, target = db["glyph_rows"], db["chunk_map"], db["target_tiles"]
    words, tmeta = db["plan_words"], db["plan_tmeta"]
    N, B, C = words.shape[0] * 32, c.shape[0], c.shape[1]
    bern = flat_loss.bernstein_matrix(FIT_DEPTH, dev)
    pts = flat_loss.chain_fwd(c, t, bern, cmap, rows, N)
    d2, wn, am = sdf_cuda.launch_min_field_pts(pts, words, tmeta, TP)
    ct = torch.rand(B, generator=gen, device=dev) / B
    broadcast = torch.full((), 1.0 / B, device=dev).expand(B)
    ct_d2, part = flat_loss.loss_bwd(ct, d2, wn, target, rows, lg, TP)
    dpts = sdf_cuda.launch_min_field_bwd(pts, am, ct_d2, tmeta, TP)

    def host(*ts):
        return [x.cpu() for x in ts]

    # case -> (kernel, its launch, the plain version on CPU copies, on the card)
    cases = {
        "chain": ("flat_chain_fwd", lambda: flat_loss.chain_fwd(c, t, bern, cmap, rows, N),
                  lambda: flat_loss.chain_fwd_plain(*host(c, t, bern, cmap, rows), N),
                  lambda: flat_loss.chain_fwd_plain(c, t, bern, cmap, rows, N)),
        "loss": ("flat_loss_fwd", lambda: flat_loss.loss_fwd(d2, wn, target, rows, lg, TP),
                 lambda: flat_loss.loss_fwd_plain(*host(d2, wn, target, rows, lg), TP),
                 lambda: flat_loss.loss_fwd_plain(d2, wn, target, rows, lg, TP)),
        "loss_bwd": ("flat_loss_bwd",
                     lambda: flat_loss.loss_bwd(ct, d2, wn, target, rows, lg, TP),
                     lambda: flat_loss.loss_bwd_plain(*host(ct, d2, wn, target, rows, lg), TP),
                     lambda: flat_loss.loss_bwd_plain(ct, d2, wn, target, rows, lg, TP)),
        "loss_bwd_broadcast": (
            "flat_loss_bwd", lambda: flat_loss.loss_bwd(broadcast, d2, wn, target, rows, lg, TP),
            lambda: flat_loss.loss_bwd_plain(broadcast.cpu(), *host(d2, wn, target, rows, lg),
                                             TP), None),
        "chain_bwd": ("flat_chain_bwd", lambda: flat_loss.chain_bwd(dpts, bern, rows, C, part, lg),
                      lambda: flat_loss.chain_bwd_plain(*host(dpts, bern, rows), C,
                                                        *host(part, lg)),
                      lambda: flat_loss.chain_bwd_plain(dpts, bern, rows, C, part, lg)),
    }
    work = flat_loss.work(rows.cpu().numpy(), C, bern.shape[0], N, tmeta.shape[1], TP)

    def outs(x):
        return [o.detach() for o in (x if isinstance(x, tuple) else (x,))]

    out = {}
    for case, (name, run, plain, plain_card) in cases.items():
        got, again = outs(run()), outs(run())
        want = outs(plain())
        torch.cuda.synchronize()
        bits = sum(int((g.cpu().view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))
        rerun = sum(int((g.view(torch.int32) != a.view(torch.int32)).sum())
                    for g, a in zip(got, again))
        err = max(float((g.cpu() - w).abs().max()) if w.numel() else 0.0
                  for g, w in zip(got, want))
        rec = {"phase": "kernel", "kernel": name, "case": case, "glyphs": B, "lanes": N,
               "tiles": int(tmeta.shape[1]), "bits_differ_from_plain": bits,
               "bits_differ_between_runs": rerun, "max_abs_err": err,
               "shapes": [list(g.shape) for g in got]}
        if plain_card is not None:
            rec["kernel_ms"] = time_ms(run, 50)
            rec["graph_ms"] = graph_ms(run, 50)
            rec["plain_ms"] = time_ms(plain_card, 3)
            rec.update(bound_of(*work[name]))
            out[name] = {"err": err, "ms": rec["kernel_ms"], "graph_ms": rec["graph_ms"],
                         "plain_ms": rec["plain_ms"], "bound": bound_of(*work[name])}
        emit(rec)
        if bits or rerun:
            raise AssertionError(f"{name} ({case}): {bits} values differ from the plain "
                                 f"version, {rerun} between two runs")
    return out


def flat_case(gp, dev, tp: int = TP):
    """Glyphs ``gp`` packed by `pack_flat` and uploaded, with kernel 6's
    tile table at ``tp`` pixels a tile: (flat [4, N], meta [G, 8], tmeta
    [8, T], P_pad, each glyph's first tile row)."""
    from versatiles_glyphs_tpu_torch.render.batch import (
        pack_flat, plan_tiles, tile_starts, wire_to_device,
    )

    G = len(gp)
    flat, meta, P = pack_flat(gp)
    starts, T = tile_starts(meta, G, tp)
    tm = plan_tiles(gp, meta, tp, T_pad=T)[0]
    return (*wire_to_device((flat, meta[:G], tm.T), dev), P, starts)


def glyph_bitmap(kernel, out, starts, i, tp: int = TP):
    """Glyph i's bitmap (from its first byte) in the output of kernel 6
    (tile rows of ``tp`` pixels from ``starts[i]``) or kernel 7 (grid
    row i)."""
    return out.reshape(-1)[starts[i] * tp:] if kernel == "sdf_tiles_flat" else out[i]


def phase_flat_kernels(preps, heavy) -> dict:
    """Kernels 6 and 7 (the segment-layout renders) against their plain
    versions at group 0 of both fonts, on degenerate segments, on glyphs
    past the crossing lists' sizes, kernel 6 at 64 and 32 pixels a tile
    (two pixels a thread and one), and kernel 7 at eight pixel tiles a
    glyph with a bitmap under one tile; each glyph's bytes against
    kernel 1's and kernel 9's on the f32 wire (kernels 1, 6 and 7 share
    their records and crossing lists; kernel 9 keeps the per-pair loop),
    and kernel 7's against kernel 6's. Returns the numbers of the
    kernels line."""
    from versatiles_glyphs_tpu_torch.ops import legacy, sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.render.batch import pack_points, plan_tiles, wire_to_device
    from versatiles_glyphs_tpu_torch.tools import work
    from versatiles_glyphs_tpu_torch.tools.roofline import first_group
    from versatiles_glyphs_tpu_torch.utils.synth_font import row_list_edge_preps

    dev = torch.device("cuda", 0)
    out = {"sdf_tiles_flat_err": 0, "sdf_grid_flat_err": 0}
    group = first_group(preps)
    # key -> (glyphs, pixel tiles a glyph of kernel 7 (None: TP =
    # min(1024, P)), pixels a tile of kernel 6)
    cases = {"group0": (group, None, TP), "degenerate": (degenerate_preps(), None, TP),
             "group0_heavy": (first_group(heavy), None, TP),
             "row_list_edges": (row_list_edge_preps(), None, TP),
             "eight_tiles": (group[:64] + row_list_edge_preps()[2:], 8, TP),
             "tp64": (group[:48] + row_list_edge_preps(), None, 64),
             "tp32": (group[:48] + row_list_edge_preps(), None, 32)}
    for key, (gp, tiles7, tp6) in cases.items():
        G = len(gp)
        f_d, m_d, tm_d, P, starts = flat_case(gp, dev, tp6)
        tp7 = P // tiles7 if tiles7 else min(1024, P)
        pts, pw, pm = pack_points(gp, dtype=np.float32, arena_tag="flat_" + key)
        tm1 = plan_tiles(gp, pm, tp6, T_pad=tm_d.shape[1])[0]
        chain = wire_to_device((pts, pw, tm1.T), dev)
        pts_bytes = sdf_cuda.render_bitmaps_cuda_pts(*chain, tp6).reshape(-1).cpu().numpy()
        acc_bytes = sdf_cuda.render_bitmaps_cuda_pts_acc(*chain, tp6).reshape(-1).cpu().numpy()
        # name -> (TP, wrapper call, plain version, launch alone)
        kernels = {
            "sdf_tiles_flat": (tp6, lambda: legacy.render_bitmaps_cuda_tiles(f_d, tm_d, tp6),
                               lambda: sdf_torch.render_tiles_flat(f_d, tm_d, tp6),
                               lambda: legacy.launch_tiles_flat(f_d, tm_d, tp6)),
            "sdf_grid_flat": (tp7, lambda: legacy.render_bitmaps_cuda_grid(f_d, m_d, P, tp7),
                              lambda: sdf_torch.render_grid_flat(f_d, m_d, P, tp7),
                              lambda: legacy.launch_grid_flat(f_d, m_d, P, tp7)),
        }
        tiles_flat = None
        for name, (tp, kern, plain, launch) in kernels.items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.uint8:
                raise AssertionError(f"{name} {key}: kernel {tuple(got.shape)} {got.dtype} "
                                     f"vs plain {tuple(want.shape)} {want.dtype}")
            err = (got.int() - want.int()).abs()
            mismatches = int((err > 0).sum())
            g = got.cpu().numpy()
            vs_pts = vs_acc = vs_flat = 0
            for i, p in enumerate(gp):
                n, s0 = p.width * p.height, starts[i] * tp6
                mine = glyph_bitmap(name, g, starts, i, tp6)[:n]
                vs_pts += int((mine != pts_bytes[s0 : s0 + n]).sum())
                vs_acc += int((mine != acc_bytes[s0 : s0 + n]).sum())
                if tiles_flat is not None:
                    vs_flat += int((mine != tiles_flat[s0 : s0 + n]).sum())
            rec = {"phase": "kernel", "kernel": name, "case": key, "glyphs": G,
                   "lanes": int(f_d.shape[1]), "P": P, "TP": tp,
                   "out_shape": list(got.shape), "mismatches": mismatches,
                   "max_abs_err": int(err.max()) if err.numel() else 0,
                   "bytes_differ_from_sdf_tiles_pts": vs_pts,
                   "bytes_differ_from_sdf_tiles_pts_acc": vs_acc,
                   "nonzero_bytes": int((got > 0).sum())}
            if name == "sdf_tiles_flat":
                tiles_flat = g.reshape(-1)
                rec["pixels_per_thread"] = sdf_cuda.pixels_per_thread(tp6)
            else:
                rec["bytes_differ_from_sdf_tiles_flat"] = vs_flat
                rec["threads"], rec["grid"] = legacy.grid_launch_shape(G, P)
            if key == "group0_heavy":
                rec["ms"] = out[name + "_ms_synth_heavy"] = time_ms(launch, 50)
            if key == "group0":
                rec["ms"] = out[name + "_ms"] = time_ms(launch, 50)
                rec["graph_ms"] = out[name + "_graph_ms"] = graph_ms(launch, 50)
                rec["call_ms"] = time_ms(kern, 50)
                rec["plain_ms"] = out[name + "_plain_ms"] = time_ms(plain, 3)
                # Kernel 7's rows are its padded grid's tiles; it reads
                # meta [G, 8] where kernel 6 reads a tile table.
                table = tm_d if name == "sdf_tiles_flat" else sdf_torch.grid_tmeta(m_d, P, tp)
                wk = work.row_shared_work(f_d.cpu().numpy(), table.cpu().numpy(), tp)
                if name == "sdf_grid_flat":
                    wk["bytes"] += 32 * (G - wk["tiles"])
                out[name + "_bound"] = row_shared_bound_of(wk)
                rec.update(out[name + "_bound"])
            out[name + "_err"] = max(out[name + "_err"], rec["max_abs_err"])
            emit(rec)
            if mismatches or vs_pts or vs_acc or vs_flat or not rec["nonzero_bytes"]:
                raise AssertionError(
                    f"{name} {key}: {mismatches} bytes differ from the plain version, {vs_pts} "
                    f"from the point-chain kernel's glyphs, {vs_acc} from its split variant's, "
                    f"{vs_flat} from the flat tile kernel's")
    return out


def padded_inputs(batch, dev):
    """The padded kernels' inputs at the start of the fit: segments
    [B, S, 4] of the perturbed curves, their mask, meta [B, 4] and P."""
    from versatiles_glyphs_tpu_torch.models.glyph_model import curves_to_segments

    segs = curves_to_segments(torch.as_tensor(batch.curves0, device=dev), FIT_DEPTH).contiguous()
    mask = torch.as_tensor(np.repeat(batch.curve_mask, 2 ** FIT_DEPTH, axis=1), device=dev)
    meta = torch.as_tensor(batch.meta, dtype=torch.int32, device=dev)
    return segs, mask.float(), meta, batch.target.shape[1]


def phase_padded_kernels(batch, heavy_batch) -> dict:
    """Kernels 4 and 5 (the padded pair) against their plain versions at
    the full fit batch; kernel 5 also at the heavy font's batch, on
    `utils.synth_font.PADDED_BWD_EDGE_CASES` (argmin from kernel 4, a
    seeded cotangent over every pixel), on argmins outside [0, S), on a
    batch whose every pixel has one argmin segment, and at launch shapes
    the launcher does not pick for these sizes (the segments in passes,
    four warps a glyph); kernel 4 also on the edge inputs of
    `utils.synth_font.padded_edge_case` (masks with holes, P a multiple
    of no block size, a bitmap too narrow and a row too crossed for the
    crossing lists, more segments than a staged chunk with a tie across
    chunks, and the degenerate case: zero-length and horizontal
    segments, negative origins, an all-masked glyph at P = 300).
    Returns the numbers of the kernels line."""
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.tools import work
    from versatiles_glyphs_tpu_torch.utils.synth_font import (
        PADDED_BWD_EDGE_CASES, PADDED_EDGE_CASES, out_of_range_argmin, padded_edge_case,
    )

    dev = torch.device("cuda", 0)
    fit = padded_inputs(batch, dev)
    out = {}
    cases = {"fit": fit}
    for name in PADDED_EDGE_CASES:
        segs, mask, meta, P = padded_edge_case(name)
        cases[name] = (*(torch.as_tensor(a, device=dev) for a in (segs, mask, meta)), P)
    for key, (segs, mask, meta, P) in cases.items():
        got = sdf_cuda.min_field_cuda_padded(segs, mask, meta, P)
        want = sdf_torch.min_field_padded(segs, mask, meta, P)
        torch.cuda.synchronize()
        d2_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        wn_off = int((got[1] != want[1]).sum())
        am_off = int((got[2] != want[2]).sum())
        rec = {"phase": "kernel", "kernel": "sdf_min_field_padded", "case": key,
               "glyphs": int(segs.shape[0]), "segments": int(segs.shape[1]), "P": P,
               "d2_bits_differ": d2_bits, "wn_differ": wn_off, "am_differ": am_off,
               "max_abs_err": float((got[0] - want[0]).abs().max()),
               "sentinels": int((got[2] == sdf_torch._BIGI).sum()),
               "launch_shape": list(sdf_cuda.padded_launch_shape(P))}
        if key == "fit":
            rec["ms"] = out["pad_ms"] = time_ms(
                lambda: sdf_cuda.launch_min_field_padded(segs, mask, meta, P), 50)
            rec["graph_ms"] = out["pad_graph_ms"] = graph_ms(
                lambda: sdf_cuda.launch_min_field_padded(segs, mask, meta, P), 50)
            rec["call_ms"] = time_ms(lambda: sdf_cuda.min_field_cuda_padded(segs, mask, meta, P), 50)
            rec["plain_ms"] = out["pad_plain_ms"] = time_ms(
                lambda: sdf_torch.min_field_padded(segs, mask, meta, P), 3)
            out["pad_err"] = rec["max_abs_err"]
            # Every pixel against its glyph's live segments: the soup of
            # the live segments, one tile of P pixels a glyph.
            B, S = segs.shape[:2]
            live = (mask != 0).cpu().numpy()
            n = live.sum(1)
            table = np.zeros((8, B), np.int64)
            table[:4], table[4], table[5] = meta.cpu().numpy().T, n, np.cumsum(n) - n
            wk = work.row_shared_work(segs.cpu().numpy()[live].T, table, P, pixel_ops=0)
            wk["bytes"] = 16 * B * S + 4 * B * S + 16 * B + 12 * B * P
            if wk["pairs"] != P * int(n.sum()):
                raise AssertionError("padded min field: a glyph of the batch has an empty bitmap")
            out["pad_bound"] = row_shared_bound_of(wk)
            rec.update(out["pad_bound"])
        emit(rec)
        if d2_bits or wn_off or am_off:
            raise AssertionError(f"padded min field {key}: kernel and plain version differ")
        if key == "degenerate" and not rec["sentinels"]:
            raise AssertionError("degenerate padded case: no sentinel pixel")
        if key == "chunks" and (int((got[2][1] == 260).sum()) or not int((got[2][1] == 3).sum())):
            raise AssertionError("padded case chunks: the tie of segments 3 and 260 is not 3's")

    # Kernel 5: key -> (segs, meta, am from kernel 4, cotangent over
    # every pixel, the launch shape (None: the launcher's own)).
    def bwd_case(segs, mask, meta, P, seed):
        am = sdf_cuda.min_field_cuda_padded(segs, mask, meta, P)[2]
        gen = torch.Generator(device=dev).manual_seed(seed)
        return segs, meta, am, torch.randn(am.shape, generator=gen, device=dev)

    bwd = {"fit": (*bwd_case(*fit, 0), None),
           "fit_heavy": (*bwd_case(*padded_inputs(heavy_batch, dev), 1), None)}
    for k, name in enumerate(PADDED_BWD_EDGE_CASES):
        segs, mask, meta, P = padded_edge_case(name)
        bwd[name] = (*bwd_case(*(torch.as_tensor(a, device=dev) for a in (segs, mask, meta)), P,
                               2 + k), None)
    segs, meta, am, ct, _ = bwd["holes"]
    wild = torch.as_tensor(out_of_range_argmin(am.cpu().numpy(), segs.shape[1]), device=dev)
    bwd["out_of_range"] = (segs, meta, wild, ct, None)
    # Every pixel of the fit batch with one argmin segment: the longest
    # sets a warp can meet, at full size.
    segs, meta, am, ct, _ = bwd["fit"]
    bwd["fit_one_wins"] = (segs, meta, torch.full_like(am, 5), ct, None)
    # The segments walked in passes of 64, and four warps a glyph.
    bwd["chunks_passes"] = (*bwd["chunks"][:4], (128, 1, 64))
    bwd["chunks_warps"] = (*bwd["chunks"][:4], (128, 4, 300))
    for key, (segs, meta, am, ct, shape) in bwd.items():
        B, S = segs.shape[:2]
        P = am.shape[1]
        launch_shape = shape or sdf_cuda.padded_bwd_launch_shape(S, P)
        if shape is None:
            run = lambda: sdf_cuda.min_field_padded_bwd_cuda(segs, meta, am, ct)
        else:
            run = lambda: sdf_cuda.launch_min_field_padded_bwd(segs, meta, am, ct, shape)
        got, again = run(), run()
        want = sdf_torch.min_field_padded_bwd(segs, meta, am, ct)
        ordered = sdf_torch.min_field_padded_bwd_ordered(segs, meta, am, ct)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        identical = bool(torch.equal(got, again))
        order_bits = int((got.view(torch.int32) != ordered.view(torch.int32)).sum())
        n_px = int(((am >= 0) & (am < S)).sum())
        rec = {"phase": "kernel", "kernel": "sdf_min_field_padded_bwd", "case": key,
               "argmin_pixels": n_px, "glyphs": B, "segments": S, "P": P,
               "launch_shape": list(launch_shape),
               "max_abs_err": err, "max_abs_plain": scale, "tolerance": 1e-4 * scale,
               "bit_identical_rerun": identical, "bits_differ_from_pixel_order": order_bits}
        if key in ("fit", "fit_heavy", "fit_one_wins"):
            rec["ms"] = time_ms(lambda: sdf_cuda.launch_min_field_padded_bwd(segs, meta, am, ct), 50)
            rec["graph_ms"] = graph_ms(
                lambda: sdf_cuda.launch_min_field_padded_bwd(segs, meta, am, ct), 50)
        if key == "fit":
            out["pad_bwd_bound"] = bound_of(n_px * work.BWD_PIXEL_F32_OPS,
                                            16 * B * S + 16 * B + 8 * B * P + 16 * B * S)
            rec.update(out["pad_bwd_bound"])
            rec["call_ms"] = time_ms(run, 50)
            rec["plain_ms"] = time_ms(
                lambda: sdf_torch.min_field_padded_bwd(segs, meta, am, ct), 3)
            out.update(pad_bwd_err=err, pad_bwd_ms=rec["ms"], pad_bwd_graph_ms=rec["graph_ms"],
                       pad_bwd_plain_ms=rec["plain_ms"])
        if key in ("fit_heavy", "fit_one_wins"):
            out["pad_bwd_ms_" + key[4:]] = rec["ms"]
        emit(rec)
        if not scale > 0 or err > 1e-4 * scale:
            raise AssertionError(f"padded backward {key}: off by {err} (plain max {scale})")
        if not identical:
            raise AssertionError(f"padded backward {key}: differs between two runs")
        if launch_shape[1] == 1 and order_bits:
            raise AssertionError(f"padded backward {key}: {order_bits} values are not the sum in "
                                 "pixel order")
        if key == "degenerate" and bool(got[2].any()):
            raise AssertionError("padded backward: the all-sentinel glyph's gradient is not zero")
        if key == "large" and launch_shape[1] < 2:
            raise AssertionError("padded backward: 4,096 pixels a glyph on one warp")
    return out


def phase_tool_kernels(preps) -> dict:
    """Kernel 8 (the ALU roof) against its plain version on group 0's
    grid, bit for bit; kernel 9 (the split tile kernel) against its
    plain version, which is kernel 1's, and against kernel 1 itself at
    group 0 (i8 and f32 wires), on degenerate segments and on the tile
    kernel's edge cases (`tile_kernel_edge_cases`), byte for byte.
    Returns the numbers of the kernels line."""
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.render.batch import pack_points_delta, tile_starts, wire_to_device
    from versatiles_glyphs_tpu_torch.tools import roofline, work

    dev = torch.device("cuda", 0)
    group = roofline.first_group(preps)
    out = {}

    w = roofline.group_work(group, arena_tag="_k8")
    T, n_chunk = w["tiles"], roofline.roof_chunks(w)
    got = sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev)
    want = sdf_torch.alu_roof(T, TP, n_chunk, dev)
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    ops = sdf_cuda.alu_roof_ops(T, TP, n_chunk)
    rec = {"phase": "kernel", "kernel": "alu_roof", "case": "group0", "tiles": T, "TP": TP,
           "n_chunk": n_chunk, "chains": sdf_cuda.ALU_ROOF_CHAINS,
           "bits_differ": differ, "max_abs_err": float((got - want).abs().max()),
           "value": float(got[0, 0]), "all_equal": bool((got == got[0, 0]).all()),
           "ms": time_ms(lambda: sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev), 20),
           "graph_ms": graph_ms(lambda: sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev), 20),
           "plain_ms": time_ms(lambda: sdf_torch.alu_roof(T, TP, n_chunk, dev), 2),
           **bound_of(ops, 4 * T * TP)}
    emit(rec)
    if differ or not rec["all_equal"] or got.shape != (T, TP):
        raise AssertionError(f"alu_roof: {differ} values differ from the plain version")
    out["alu_roof"] = rec

    pts, words, tmeta = wire_to_device((w["pts"], w["words"], w["tmeta"]), dev)
    cases = {"f32": (pts, words, tmeta)}
    deltas, dwords, anchors, meta = pack_points_delta(group, arena_tag="_k9")
    d, dw, a, m = wire_to_device((deltas, dwords, anchors, meta), dev)
    cases["i8"] = (sdf_torch.dequantize(sdf_torch.reconstruct_delta(d, a)), dw,
                   sdf_torch.derive_tmeta(m, TP, tile_starts(meta, len(group), TP)[1]))
    wd = roofline.group_work(degenerate_preps(), arena_tag="_k9d")
    cases["degenerate"] = wire_to_device((wd["pts"], wd["words"], wd["tmeta"]), dev)
    cases = {key: (*c, TP) for key, c in cases.items()} | tile_kernel_edge_cases(group, dev)
    max_err = 0
    for key, (p, pw, tm, tp) in cases.items():
        got = sdf_cuda.render_bitmaps_cuda_pts_acc(p, pw, tm, tp)
        plain = sdf_torch.render_tiles_pts(p, pw, tm, tp)
        prod = sdf_cuda.render_bitmaps_cuda_pts(p, pw, tm, tp)
        torch.cuda.synchronize()
        if got.shape != plain.shape or got.dtype != torch.uint8:
            raise AssertionError(f"sdf_tiles_pts_acc {key}: {tuple(got.shape)} {got.dtype}")
        err = (got.int() - plain.int()).abs()
        vs_plain, vs_prod = int((err > 0).sum()), int((got != prod).sum())
        max_err = max(max_err, int(err.max()) if err.numel() else 0)
        emit({"phase": "kernel", "kernel": "sdf_tiles_pts_acc", "case": key,
              "split": sdf_cuda.ACC_SPLIT, "tiles": int(got.shape[0]), "TP": tp,
              "mismatches": vs_plain, "bytes_differ_from_sdf_tiles_pts": vs_prod,
              "nonzero_bytes": int((got > 0).sum())})
        if vs_plain or vs_prod:
            raise AssertionError(f"sdf_tiles_pts_acc {key}: {vs_plain} bytes differ from the plain "
                                 f"version, {vs_prod} from the tile kernel")
    rec = {"phase": "kernel", "kernel": "sdf_tiles_pts_acc", "case": "f32",
           "ms": time_ms(lambda: sdf_cuda.launch_tiles_pts_acc(pts, words, tmeta, TP), 50),
           "graph_ms": graph_ms(lambda: sdf_cuda.launch_tiles_pts_acc(pts, words, tmeta, TP), 50),
           "call_ms": time_ms(lambda: sdf_cuda.render_bitmaps_cuda_pts_acc(pts, words, tmeta, TP), 50),
           "plain_ms": time_ms(lambda: sdf_torch.render_tiles_pts(pts, words, tmeta, TP), 3),
           "max_abs_err": max_err, **row_shared_bound_of(w)}
    emit(rec)
    out["sdf_tiles_pts_acc"] = rec
    return out


def phase_tools() -> dict:
    """The measurement tools through their entry points on the text
    font, with the counts reset just before. Returns the launches per
    kernel of the roofline and the split-variant tools, and the
    measured un-fused ALU roof in f32 operations a second."""
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.tools import kernel_ab, roofline

    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    roof = roofline.main(["--font", "synth_text"])
    ab = kernel_ab.main(["--font", "synth_text"])
    launches = dict(sdf_cuda.LAUNCHES)
    emit({"phase": "tools", "seconds": time.perf_counter() - t0, "launches": launches,
          "kernel_share_of_roof": roof["alu_roof"]["kernel_share_of_roof"],
          "roof_f32_Tops_per_s": roof["alu_roof"]["f32_Tops_per_s"],
          "variant_speedup": ab["variant_speedup"]})
    for name in ("sdf_tiles_pts", "alu_roof", "sdf_tiles_pts_acc"):
        if not launches[name]:
            raise AssertionError(f"the tools never launched {name}: {launches}")
    if not ab["byte_equal"] or roof["alu_roof"]["bits_differ_from_plain"]:
        raise AssertionError("a tool's kernel disagrees with what it is held against")
    return launches, 1e12 * roof["alu_roof"]["f32_Tops_per_s"]


def phase_profile() -> None:
    """`tools.profile --quick` through its entry point: the render's
    stages, the manager against the device-only render, cProfile's
    frames and the four fit steps under `torch.profiler`. Raises unless
    every part reported what it measures: the device times of the
    render's stages, a finite paired ratio, top frames, device events in
    every fit step and the port's kernels launched as many times a step
    as each step runs them."""
    from versatiles_glyphs_tpu_torch.tools import profile

    t0 = time.perf_counter()
    res = profile.main(["--quick"])
    fit = res["fit"]
    emit({"phase": "profile", "seconds": time.perf_counter() - t0,
          "e2e_paired_ratio": res["e2e"]["paired_ratio"],
          "e2e_file_paired_ratio": res["e2e_file"]["paired_ratio"],
          "e2e_file_s_a_font": res["e2e_file"]["e2e_s_a_font"],
          "cpuprof_file_wall_s_a_font": res["cpuprof_file"]["wall_s_a_font"],
          **{f"{k}_{v}": fit[k][v] for k in fit
             for v in ("wall_ms_a_step", "device_busy_share", "device_busy_ms_a_step",
                       "device_busy_ms_over_unprofiled_wall", "device_events_a_step",
                       "kernel_launches_a_step")}})
    # The port's kernels a step of each fit variant (counted by their
    # wrappers; a graph's once a replay): the flat step's six a shard,
    # kernels 2 and 3 and the fused loss's four. The tool's own table
    # (`tools.profile.expected_launches`) has to agree with this one.
    flat = ("flat_chain_fwd", "sdf_min_field_pts", "flat_loss_fwd", "flat_loss_bwd",
            "sdf_min_field_bwd", "flat_chain_bwd")
    padded = ("sdf_min_field_padded", "sdf_min_field_padded_bwd")
    # Adam: one launch a step of every variant (whole on the first device).
    adam = {"adam_flat": 1.0}
    want = {"graphed_one_device": {**dict.fromkeys(flat, 1.0), **adam},
            "graphed_sharded": {**dict.fromkeys(flat, 2.0), **adam},
            "eager_sharded": {**dict.fromkeys(flat, 2.0), **adam},
            "padded_eager": {**dict.fromkeys(padded, 1.0), **adam}}
    bad = [r["stage"] for r in res["render"] if r["device_ms_median"] is None]
    bad += [k for k, r in fit.items()
            if not r["device_events_a_step"] or r["kernel_launches_a_step"] != want[k]
            or r["kernel_launches_a_step_expected"] != want[k]]
    for src in ("", "_file"):
        if not (np.isfinite(res["e2e" + src]["paired_ratio"]).all()
                and res["cpuprof" + src]["top_frames"]):
            bad.append("e2e/cpuprof" + src)
    if bad:
        raise AssertionError(f"tools.profile: nothing or the wrong launches measured for {bad}")


def render_font(name, preps, renderer, out_dir):
    """The atlas pipeline below the font parser: blocks of 256
    codepoints through one render session, the fused native PBF encode
    and the directory writer. Returns (seconds, groups)."""
    from versatiles_glyphs_tpu_torch.font.index_files import build_index_json
    from versatiles_glyphs_tpu_torch.proto import native
    from versatiles_glyphs_tpu_torch.writer import Writer

    blocks: dict[int, list] = {}
    for p in preps:
        blocks.setdefault(p.codepoint >> 8, []).append(p)
    t0 = time.perf_counter()
    writer = Writer.new_file(out_dir)
    writer.write_directory(f"{name}/")
    with renderer.start_session() as session:
        for bp in blocks.values():
            session.add([p for p in bp if not p.empty])
        bm_iter = session.results()
        for b, bp in blocks.items():
            rng = f"{b * 256}-{b * 256 + 255}"
            writer.write_file(f"{name}/{rng}.pbf",
                              native.encode_block_from_preps(name, rng, bp, bm_iter))
    writer.write_file("index.json", build_index_json([name]))
    writer.finish()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, session.groups


def session_threads() -> list:
    """Threads of the package's render session alive (named ``vg``...):
    the session dispatches on the caller's thread and starts none."""
    return [t.name for t in threading.enumerate() if t.name.startswith("vg")]


def warm_render_profile(name, preps, renderer, out_dir) -> dict:
    """One warm render under `torch.profiler` (`tools.session_turns.busy_share`):
    the share of its wall time in which the card ran a kernel or a copy,
    the copies' own times, the session's `WIRE_STATS` with the rates
    they imply, and no session thread left after it."""
    from versatiles_glyphs_tpu_torch.render import driver
    from versatiles_glyphs_tpu_torch.tools.session_turns import busy_share

    driver.reset_wire_stats()
    groups = []

    def render():
        secs, n = render_font(name, preps, renderer, out_dir)
        groups.append(n)
        return secs

    rec = busy_share(render)
    wire = dict(driver.WIRE_STATS)
    left = session_threads()
    if left:
        raise AssertionError(f"{name}: session threads left after the render: {left}")
    if wire["groups"] != groups[0]:
        raise AssertionError(f"{name}: WIRE_STATS counts {wire['groups']} groups of {groups[0]}")
    secs = rec["seconds_profiled"]
    rec = {"phase": "warm_render", "font": name, "groups": groups[0], **rec, "wire_stats": wire,
           "upload_GB_per_s_of_wall": wire["upload_bytes"] / secs / 1e9,
           "fetch_GB_per_s_of_wall": wire["fetch_bytes"] / secs / 1e9,
           "session_threads_after": len(left)}
    if rec["device_events"]:
        rec["upload_GB_per_s_of_copy"] = (wire["upload_bytes"] / (rec["htod_ms"] * 1e6)
                                          if rec["htod_ms"] else None)
        rec["fetch_GB_per_s_of_copy"] = (wire["fetch_bytes"] / (rec["dtoh_ms"] * 1e6)
                                         if rec["dtoh_ms"] else None)
    else:
        rec["device_busy_share"] = "not measured: the profiler saw no device event"
    emit(rec)
    return rec


def compare_trees(name, got_dir, want_dir):
    """Per-PBF comparison against the exact renderer; returns
    (files, glyphs, pixels, differing pixels, max |Δ|)."""
    from versatiles_glyphs_tpu_torch.proto.pbf import decode_glyphs

    files = sorted(os.listdir(os.path.join(want_dir, name)))
    if sorted(os.listdir(os.path.join(got_dir, name))) != files:
        raise AssertionError(f"{name}: file sets differ")
    n_glyphs = n_pix = n_diff = max_d = 0
    for fn in files:
        with open(os.path.join(got_dir, name, fn), "rb") as f:
            got = decode_glyphs(f.read())
        with open(os.path.join(want_dir, name, fn), "rb") as f:
            want = decode_glyphs(f.read())
        if len(got) != len(want):
            raise AssertionError(f"{name}/{fn}: {len(got)} glyphs vs {len(want)}")
        for g, e in zip(got, want):
            if (g.id, g.width, g.height, g.left, g.top, g.advance) != (
                    e.id, e.width, e.height, e.left, e.top, e.advance):
                raise AssertionError(f"{name}/{fn}: metrics of glyph {e.id} differ")
            if (g.bitmap is None) != (e.bitmap is None):
                raise AssertionError(f"{name}/{fn}: bitmap presence of glyph {e.id} differs")
            if e.bitmap is None:
                continue
            a = np.frombuffer(g.bitmap, np.uint8).astype(np.int32)
            b = np.frombuffer(e.bitmap, np.uint8).astype(np.int32)
            if a.shape != b.shape:
                raise AssertionError(f"{name}/{fn}: bitmap size of glyph {e.id} differs")
            dlt = np.abs(a - b)
            n_pix += dlt.size
            n_diff += int((dlt > 0).sum())
            max_d = max(max_d, int(dlt.max(initial=0)))
            n_glyphs += 1
    return len(files), n_glyphs, n_pix, n_diff, max_d


def compare_bytes(name, got_dir, want_dir) -> list:
    """The files of fontstack ``name`` whose bytes differ between two
    trees, or that only one of them has."""
    a = sorted(os.listdir(os.path.join(got_dir, name)))
    b = sorted(os.listdir(os.path.join(want_dir, name)))
    differ = sorted(set(a) ^ set(b))
    for fn in set(a) & set(b):
        with open(os.path.join(got_dir, name, fn), "rb") as f1, \
                open(os.path.join(want_dir, name, fn), "rb") as f2:
            if f1.read() != f2.read():
                differ.append(fn)
    return differ


def debug_rows(name, out_dir):
    """The ``debug`` command's rows (codepoint, width, height, left, top,
    advance, bitmap size) of a rendered fontstack, BMP blocks only."""
    from versatiles_glyphs_tpu_torch.proto.pbf import decode_glyphs

    rows = []
    for i in range(256):
        path = os.path.join(out_dir, name, f"{i * 256}-{i * 256 + 255}.pbf")
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            for g in sorted(decode_glyphs(f.read()), key=lambda g: g.id):
                rows.append((g.id, g.width, g.height, g.left, g.top, g.advance,
                             len(g.bitmap) if g.bitmap is not None else 0))
    return rows


def phase_slice(font_list, work) -> int:
    from versatiles_glyphs_tpu_torch.proto import native
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.parallel import mesh
    from versatiles_glyphs_tpu_torch.render.driver import Renderer

    native.require()
    cuda_r, exact_r, torch_r = Renderer("cuda"), Renderer("exact"), Renderer("torch")
    launches = 0
    for name, preps in font_list:
        got_dir = os.path.join(work, "cuda")
        sdf_cuda.reset_launches()
        secs, groups = render_font(name, preps, cuda_r, got_dir)
        n_launch = sdf_cuda.LAUNCHES["sdf_tiles_pts"]
        if not (n_launch > 0 and n_launch == groups):
            raise AssertionError(f"{name}: {n_launch} kernel launches for {groups} groups")
        launches += n_launch
        # The same font again in the same process: the steady state of a
        # run over many fonts (the first render pays one-time costs); the
        # median of five, since one render on a shared host varies by tens
        # of percent.
        warm = []
        for k in range(5):
            warm.append(render_font(name, preps, cuda_r, os.path.join(work, "cuda_warm"))[0])
            shutil.rmtree(os.path.join(work, "cuda_warm"))
        warm_s = statistics.median(warm)
        warm_render_profile(name, preps, cuda_r, os.path.join(work, "cuda_prof"))

        # The several-device path (`Renderer._render_devices`, the bins of
        # `_lpt_rounds`) with the one card listed twice as the local
        # devices: two lanes, each with its own streams. Its tree must be
        # the one-device tree.
        dev = torch.device("cuda", 0)
        two_dir = os.path.join(work, "cuda_two")
        sdf_cuda.reset_launches()
        real_devices = mesh.data_devices
        mesh.data_devices = lambda *a, **kw: [dev, dev]
        try:
            two_s, two_groups = render_font(name, preps, cuda_r, two_dir)
        finally:
            mesh.data_devices = real_devices
        two_launch = sdf_cuda.LAUNCHES["sdf_tiles_pts"]
        if not (two_launch == two_groups >= 2):
            raise AssertionError(f"{name}: {two_launch} launches for {two_groups} groups "
                                 "on two lanes")
        if compare_bytes(name, two_dir, got_dir):
            raise AssertionError(f"{name}: the two-lane tree differs from the one-device tree")

        want_dir = os.path.join(work, "exact")
        exact_s, _ = render_font(name, preps, exact_r, want_dir)
        files, n_glyphs, n_pix, n_diff, max_d = compare_trees(name, got_dir, want_dir)
        frac = n_diff / max(n_pix, 1)
        if max_d > 1 or frac > 0.05:
            raise AssertionError(f"{name}: max |Δ| {max_d} on {frac:.4%} of pixels")
        rows = debug_rows(name, got_dir)
        if rows != debug_rows(name, want_dir) or not rows:
            raise AssertionError(f"{name}: debug rows differ from the exact renderer's")

        # One full block against the torch backend on the CPU.
        b0 = preps[0].codepoint >> 8
        block = [p for p in preps if p.codepoint >> 8 == b0]
        cpu_dir = os.path.join(work, "torch")
        render_font(name, block, torch_r, cpu_dir)
        rng = f"{b0 * 256}-{b0 * 256 + 255}.pbf"
        with open(os.path.join(got_dir, name, rng), "rb") as f1, \
                open(os.path.join(cpu_dir, name, rng), "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{name}/{rng}: cuda and torch backends differ")

        emit({"phase": "slice", "font": name, "glyphs": len(preps),
              "blocks": files, "lanes": int(sum(p.npts for p in preps)),
              "tiles": int(sum(p.ntiles256 for p in preps if not p.empty)),
              "groups": groups, "launches": n_launch, "seconds": secs,
              "glyphs_per_s": len(preps) / secs, "seconds_warm": warm_s,
              "seconds_warm_each": warm,
              "two_lanes": {"groups": two_groups, "launches": two_launch, "seconds": two_s,
                            "tree_equal": True},
              "exact_seconds": exact_s,
              "pixels": n_pix, "pixels_off_by_1": n_diff, "frac_off": frac,
              "max_abs_diff": max_d, "debug_rows": len(rows),
              "torch_cpu_block_bytes_equal": True})
        for sub in ("cuda", "cuda_warm", "cuda_prof", "cuda_two", "exact", "torch"):
            shutil.rmtree(os.path.join(work, sub), ignore_errors=True)
    return launches


# The `cli` phase's fonts, written by `utils.synth_font.build_ttf_curved`:
# name -> (glyphs, first codepoint, seed, quads, family); the text and
# heavy fonts are phase 4's, and `recurse` reads eight text fonts of their
# own families and seeds.
CLI_FONTS = {"text": (1700, 32, 0, 8, "Synth Curved"), "heavy": (1150, 0x600, 1, 24, "Synth Curved")}
CLI_FAMILIES = ("Synth Alpha", "Synth Bravo", "Synth Charlie", "Synth Delta", "Synth Echo",
                "Synth Foxtrot", "Synth Golf", "Synth Hotel")
CLI_REFUSED = ("fontTools", "jax", "jaxlib", "versatiles_glyphs_tpu")
# ``python -m versatiles_glyphs_tpu_torch ARGS`` in an interpreter whose
# import system refuses CLI_REFUSED: the CLI must read and write fonts,
# and render and fit, with none of them.
CLI_WRAPPER = (
    "import importlib.abc, runpy, sys\n"
    f"REFUSED = {CLI_REFUSED!r}\n"
    "class Refuse(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in REFUSED:\n"
    "            raise ImportError('refused by chip_smoke: ' + name)\n"
    "sys.meta_path.insert(0, Refuse())\n"
    "sys.argv[0] = 'versatiles_glyphs_tpu_torch'\n"
    "runpy.run_module('versatiles_glyphs_tpu_torch', run_name='__main__', alter_sys=True)\n"
    "loaded = sorted(m for m in sys.modules if m.split('.')[0] in REFUSED)\n"
    "if loaded:\n"
    "    raise SystemExit(f'refused modules were loaded: {loaded}')\n"
)


def run_cli(argv, stdout_path=None) -> tuple[float, list]:
    """Run the port's CLI in a fresh interpreter that refuses
    `CLI_REFUSED`, its stdout into ``stdout_path`` (or nowhere): (its
    wall seconds, [(seconds since the start, line)] of its stderr, each
    line timed as it arrives). Raises on a non-zero exit, and leaves no
    process behind."""
    t0 = time.perf_counter()
    lines = []
    with open(stdout_path or os.devnull, "wb") as out:
        proc = subprocess.Popen([sys.executable, "-c", CLI_WRAPPER, *argv], cwd=ROOT,
                                stdout=out, stderr=subprocess.PIPE)
        try:
            for raw in proc.stderr:
                lines.append((time.perf_counter() - t0, raw.decode(errors="replace").rstrip()))
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        tail = "\n".join(line for _, line in lines[-20:])
        raise AssertionError(f"cli {argv[0]}: exit {rc}: {tail}")
    return time.perf_counter() - t0, lines


def line_at(lines, prefix: str):
    """When the first stderr line starting with ``prefix`` arrived."""
    return next((t for t, line in lines if line.startswith(prefix)), None)


def debug_text(stack_dir) -> str:
    """The port's ``debug`` command's CSV of a rendered fontstack."""
    import io

    from versatiles_glyphs_tpu_torch import cli

    out = io.StringIO()
    cli.main(["debug", stack_dir], stdout=out)
    return out.getvalue()


def only_stack(out_dir) -> str:
    stacks = [n for n in os.listdir(out_dir) if os.path.isdir(os.path.join(out_dir, n))]
    if len(stacks) != 1:
        raise AssertionError(f"{out_dir}: fontstacks {stacks}")
    return stacks[0]


def phase_cli(work) -> int:
    """The port's CLI as a user runs it, on font files the port writes.
    Returns kernel 1's launches in the in-process merges' first runs."""
    import io
    import tarfile

    from versatiles_glyphs_tpu_torch import cli
    from versatiles_glyphs_tpu_torch.models import fitting
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved

    d = os.path.join(work, "cli")
    many = os.path.join(d, "many")
    os.makedirs(many)
    t0 = time.perf_counter()
    paths = {}
    for name, (n, first_cp, seed, quads, family) in CLI_FONTS.items():
        paths[name] = os.path.join(d, f"{name}.ttf")
        with open(paths[name], "wb") as f:
            f.write(build_ttf_curved(n, first_cp, seed=seed, quads=quads, family=family))
    for i, family in enumerate(CLI_FAMILIES):
        with open(os.path.join(many, f"{i}.ttf"), "wb") as f:
            f.write(build_ttf_curved(1700, 32, seed=10 + i, quads=8, family=family))
    emit({"phase": "cli", "step": "write_fonts", "fonts": 2 + len(CLI_FAMILIES),
          "seconds": time.perf_counter() - t0,
          "bytes": {k: os.path.getsize(v) for k, v in paths.items()}})

    # merge (--renderer auto: kernel 1 on the i8 wire) against the same
    # CLI's exact f64 tree, and the debug rows of both.
    for name, path in paths.items():
        auto_dir, exact_dir = os.path.join(d, f"{name}_auto"), os.path.join(d, f"{name}_exact")
        wall, lines = run_cli(["merge", path, "-o", auto_dir])
        exact_wall, _ = run_cli(["merge", path, "-o", exact_dir, "--renderer", "exact"])
        stack = only_stack(auto_dir)
        if sorted(os.listdir(auto_dir)) != sorted(os.listdir(exact_dir)):
            raise AssertionError(f"cli merge {name}: the trees list other files")
        for fn in ("index.json", "font_families.json"):
            with open(os.path.join(auto_dir, fn), "rb") as a, \
                    open(os.path.join(exact_dir, fn), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"cli merge {name}: {fn} differs")
        files, n_glyphs, n_pix, n_diff, max_d = compare_trees(stack, auto_dir, exact_dir)
        frac = n_diff / max(n_pix, 1)
        if max_d > 1 or frac > 0.05 or n_glyphs != CLI_FONTS[name][0]:
            raise AssertionError(f"cli merge {name}: {n_glyphs} glyphs, max |Δ| {max_d} "
                                 f"on {frac:.4%} of pixels")
        rows, rows_exact = debug_text(os.path.join(auto_dir, stack)), debug_text(
            os.path.join(exact_dir, stack))
        if rows != rows_exact or len(rows.splitlines()) != n_glyphs + 1:
            raise AssertionError(f"cli debug {name}: the rows of the two trees differ")
        emit({"phase": "cli", "step": "merge", "font": name, "stack": stack, "blocks": files,
              "glyphs": n_glyphs, "process_wall_s": wall, "exact_process_wall_s": exact_wall,
              # The interpreter's start, its imports and the font's parse.
              "seconds_to_rendering": line_at(lines, "Rendering glyphs"), "pixels": n_pix, "pixels_off_by_1": n_diff,
              "frac_off": frac, "max_abs_diff": max_d, "debug_rows_equal": True})

    # recurse over eight fonts: a tar stream, and a directory to hold it against.
    tar_path, rdir = os.path.join(d, "many.tar"), os.path.join(d, "many_dir")
    tar_wall, _ = run_cli(["recurse", many, "--tar"], stdout_path=tar_path)
    dir_wall, _ = run_cli(["recurse", many, "-o", rdir])
    stacks = sorted(f.lower().replace(" ", "_") + "_regular" for f in CLI_FAMILIES)
    with tarfile.open(tar_path) as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar.getmembers() if m.isfile()}
    top = sorted({m.split("/")[0] for m in members})
    if top != sorted(stacks + ["font_families.json", "index.json"]):
        raise AssertionError(f"cli recurse --tar: entries {top}")
    pbfs = [m for m in members if m.endswith(".pbf")]
    for m in members:
        with open(os.path.join(rdir, m), "rb") as f:
            if f.read() != members[m]:
                raise AssertionError(f"cli recurse: {m} differs between the tar and the tree")
    if sorted(pbfs) != sorted(os.path.join(s, fn) for s in stacks
                              for fn in os.listdir(os.path.join(rdir, s))):
        raise AssertionError("cli recurse: the tar and the tree hold other PBFs")
    emit({"phase": "cli", "step": "recurse_tar", "fonts": len(CLI_FAMILIES),
          "fontstacks": len(stacks), "pbfs": len(pbfs), "tar_bytes": os.path.getsize(tar_path),
          "process_wall_s": tar_wall, "dir_process_wall_s": dir_wall,
          "pbfs_equal_to_tree": True})

    # fit of every glyph of the text font toward another font's bitmaps
    # (`--target-font`: a self-fit starts at its own optimum, where
    # Adam's first steps raise the loss), flat backend, with --render.
    n_text, cp0 = CLI_FONTS["text"][:2]
    fit_args = ["fit", paths["text"], "--target-font", os.path.join(many, "0.ttf"),
                "--backend", "flat", "--codepoints", f"{cp0}-{cp0 + n_text - 1}",
                "--steps", str(FIT_STEPS), "--render"]
    fit_dir = os.path.join(d, "fit")
    fit_wall, fit_lines = run_cli(fit_args + ["-o", fit_dir])
    with open(os.path.join(fit_dir, "history.json")) as f:
        losses = [h["loss"] for h in json.load(f)]
    if len(losses) != FIT_STEPS or not np.isfinite(losses).all() or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"cli fit: losses {losses}")
    gdir = os.path.join(fit_dir, "glyphs")
    fit_rows = debug_text(os.path.join(gdir, only_stack(gdir)))
    fitted = int(np.load(os.path.join(fit_dir, "fitted.npz"))["codepoints"].shape[0])
    if len(fit_rows.splitlines()) != fitted + 1 or fitted != n_text:
        raise AssertionError(f"cli fit: {len(fit_rows.splitlines()) - 1} debug rows, "
                             f"{fitted} fitted glyphs")
    emit({"phase": "cli", "step": "fit", "glyphs": fitted, "steps": FIT_STEPS,
          "loss_first": losses[0], "loss_min": min(losses), "loss_last": losses[-1],
          "process_wall_s": fit_wall, "debug_rows": fitted,
          # Where the process's wall goes, by the arrival of its status lines.
          "seconds_to_batch_made": line_at(fit_lines, "Fitting"),
          "seconds_to_step_0": line_at(fit_lines, "step 0:"),
          "seconds_to_last_step": line_at(fit_lines, f"step {FIT_STEPS - 1}:"),
          "seconds_to_written": line_at(fit_lines, "Wrote fitted"),
          "seconds_to_rendered": line_at(fit_lines, "Rendered")})

    # The same merges and fit in this process, timed, with the counts reset.
    first_launches = 0
    for name, path in paths.items():
        out = os.path.join(d, f"{name}_in_process")
        secs, counts = [], []
        for _ in range(4):
            sdf_cuda.reset_launches()
            t0 = time.perf_counter()
            cli.main(["merge", path, "-o", out], stdout=io.BytesIO())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(sdf_cuda.LAUNCHES["sdf_tiles_pts"])
        if compare_bytes(CLI_FONTS[name][4].lower().replace(" ", "_") + "_regular", out,
                         os.path.join(d, f"{name}_auto")):
            raise AssertionError(f"cli merge {name}: in-process tree differs from the subprocess's")
        if (name == "text" and counts != [2] * 4) or min(counts) < 1 or len(set(counts)) != 1:
            raise AssertionError(f"cli merge {name}: kernel 1 launches {counts}")
        first_launches += counts[0]
        emit({"phase": "cli", "step": "merge_in_process", "font": name,
              "glyphs": CLI_FONTS[name][0], "seconds_first": secs[0],
              "seconds_warm": statistics.median(secs[1:]), "seconds_each": secs,
              "launches_sdf_tiles_pts": counts})

    host_s, step_s = [], []
    real_batch, real_many = fitting.make_fit_batch, fitting.FontFitter.step_many

    def batch_timed(*a, **kw):
        t0 = time.perf_counter()
        got = real_batch(*a, **kw)
        host_s.append(time.perf_counter() - t0)
        return got

    def steps_timed(self, *a, **kw):
        t0 = time.perf_counter()
        got = real_many(self, *a, **kw)
        torch.cuda.synchronize()
        step_s.append((time.perf_counter() - t0) / (a[3] if len(a) > 3 else kw["k"]))
        return got

    fitting.make_fit_batch, fitting.FontFitter.step_many = batch_timed, steps_timed
    try:
        sdf_cuda.reset_launches()
        t0 = time.perf_counter()
        cli.main(fit_args + ["-o", os.path.join(d, "fit_in_process")], stdout=io.StringIO())
        fit_s = time.perf_counter() - t0
    finally:
        fitting.make_fit_batch, fitting.FontFitter.step_many = real_batch, real_many
    launches = dict(sdf_cuda.LAUNCHES)
    # Phase 5's count: 3 warm-up runs before the graph's capture, then
    # one launch a replay of each of the step's six kernels; the fitted
    # atlas launches kernel 1.
    from versatiles_glyphs_tpu_torch.ops.flat_loss import STEP_KERNELS

    want = FIT_STEPS + 3
    if not (all(launches[k] == want for k in STEP_KERNELS) and launches["sdf_tiles_pts"] >= 1):
        raise AssertionError(f"cli fit: launches {launches}")
    emit({"phase": "cli", "step": "fit_in_process", "glyphs": n_text, "seconds": fit_s,
          "make_fit_batch_host_s": host_s, "step_calls": len(step_s),
          "step_ms_first": 1e3 * step_s[0],
          "step_ms_warm": 1e3 * statistics.median(step_s[len(step_s) // 2:]),
          "step_ms_each": [1e3 * x for x in step_s],
          "launches": {k: v for k, v in launches.items() if v}})
    return first_launches + phase_cli_cjk(d)


# Phase 4b's OTFs: the CJK font (`utils.synth_font.build_otf_curved`,
# CID-keyed CFF over `CJK_RANGES`) and its CFF2 twin, seed 0; and two
# small TTFs whose only unicode cmap subtable is of format 13 and of
# format 2 (`cjk_cmap_fonts`).
CJK_GLYPHS = 27584
CJK_FAMILY = "Synth Ideo"


def cjk_cmap_fonts() -> dict:
    """name -> (bytes, glyphs): a 40-glyph TTF whose cmap is one format
    13 subtable (platform 3, encoding 10: 30 codepoints one a glyph and
    one range of 6 onto one glyph) and one whose cmap is one format 2
    subtable (platform 0, encoding 3: single-byte codes 0x41.. and
    two-byte codes 0x8100.. through a second subHeader)."""
    from versatiles_glyphs_tpu_torch.utils import synth_font as sf

    f13 = sf.with_cmap(sf.build_ttf_curved(40, 0x41, seed=21, family="Synth Thirteen"), [
        (3, 10, sf.cmap_format13([(0x41 + k, 0x41 + k, k + 1) for k in range(30)]
                                 + [(0x2000, 0x2005, 31)]))])
    f2 = sf.with_cmap(sf.build_ttf_curved(40, 0x41, seed=22, family="Synth Two Byte"), [
        (0, 3, sf.cmap_format2([(0x41, 26, 0, 0), (0, 14, 26, 0)], {0x81: 1},
                               list(range(1, 41))))])
    return {"cmap13": (f13, 36), "cmap2": (f2, 40)}


def phase_cli_cjk(d) -> int:
    """Phase 4b's OTFs through the CLI. Returns kernel 1's launches in
    the in-process CJK merge's first run."""
    import io

    from versatiles_glyphs_tpu_torch import cli
    from versatiles_glyphs_tpu_torch.font.entry import FontFileEntry
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.render import driver
    from versatiles_glyphs_tpu_torch.utils import synth_font as sf

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fonts = {"cjk": sf.build_otf_curved(CJK_GLYPHS, family=CJK_FAMILY)}
    write_s = {"cjk": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fonts["cjk_cff2"] = sf.build_otf2_curved(CJK_GLYPHS, family=CJK_FAMILY)
    write_s["cjk_cff2"] = time.perf_counter() - t0
    small = cjk_cmap_fonts()
    fonts.update({k: v[0] for k, v in small.items()})
    paths = {}
    for name, data in fonts.items():
        paths[name] = os.path.join(d, f"{name}.{'ttf' if name.startswith('cmap') else 'otf'}")
        with open(paths[name], "wb") as f:
            f.write(data)
    emit({"phase": "cli", "step": "write_otfs", "glyphs": CJK_GLYPHS, "writer_s": write_s,
          "bytes": {k: len(v) for k, v in fonts.items()}})

    # The CJK font through the CLI against its exact tree, and its CFF2
    # twin's tree against the CFF font's, byte for byte.
    auto_dir, exact_dir = os.path.join(d, "cjk_auto"), os.path.join(d, "cjk_exact")
    wall, lines = run_cli(["merge", paths["cjk"], "-o", auto_dir])
    exact_wall, _ = run_cli(["merge", paths["cjk"], "-o", exact_dir, "--renderer", "exact"])
    stack = only_stack(auto_dir)
    if sorted(os.listdir(auto_dir)) != sorted(os.listdir(exact_dir)):
        raise AssertionError("cli merge cjk: the trees list other files")
    files, n_glyphs, n_pix, n_diff, max_d = compare_trees(stack, auto_dir, exact_dir)
    frac = n_diff / max(n_pix, 1)
    n_blocks = len({cp >> 8 for cp in sf.cjk_codepoints(CJK_GLYPHS)})
    if max_d > 1 or frac > 0.05 or n_glyphs != CJK_GLYPHS or files != n_blocks:
        raise AssertionError(f"cli merge cjk: {files} blocks, {n_glyphs} glyphs, max |Δ| "
                             f"{max_d} on {frac:.4%} of pixels")
    twin_dir = os.path.join(d, "cjk_cff2_auto")
    twin_wall, _ = run_cli(["merge", paths["cjk_cff2"], "-o", twin_dir])
    if compare_bytes(stack, twin_dir, auto_dir):
        raise AssertionError("cli merge cjk_cff2: its tree differs from the CFF font's")
    for fn in ("index.json", "font_families.json"):
        with open(os.path.join(twin_dir, fn), "rb") as a, open(os.path.join(auto_dir, fn), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"cli merge cjk_cff2: {fn} differs")
    emit({"phase": "cli", "step": "merge", "font": "cjk", "stack": stack, "blocks": files,
          "glyphs": n_glyphs, "process_wall_s": wall, "exact_process_wall_s": exact_wall,
          "cff2_twin_process_wall_s": twin_wall, "cff2_twin_tree_equal": True,
          "seconds_to_rendering": line_at(lines, "Rendering glyphs"), "pixels": n_pix,
          "pixels_off_by_1": n_diff, "frac_off": frac, "max_abs_diff": max_d})

    # The two small fonts of one cmap subtable each, against their exact
    # trees (written in this process).
    for name, (_, n_cps) in small.items():
        a_dir, e_dir = os.path.join(d, f"{name}_auto"), os.path.join(d, f"{name}_exact")
        wall, _ = run_cli(["merge", paths[name], "-o", a_dir])
        cli.main(["merge", paths[name], "-o", e_dir, "--renderer", "exact"], stdout=io.BytesIO())
        st = only_stack(a_dir)
        files, n_glyphs, n_pix, n_diff, max_d = compare_trees(st, a_dir, e_dir)
        if max_d > 1 or n_diff / max(n_pix, 1) > 0.05 or n_glyphs != n_cps:
            raise AssertionError(f"cli merge {name}: {n_glyphs} glyphs, max |Δ| {max_d}")
        emit({"phase": "cli", "step": "merge", "font": name, "stack": st, "blocks": files,
              "glyphs": n_glyphs, "process_wall_s": wall, "max_abs_diff": max_d,
              "pixels_off_by_1": n_diff})

    # In this process: the host's parse and prep cores, the twin's curves
    # against the CFF font's, and the CJK merge timed with the counts reset.
    t0 = time.perf_counter()
    entry = FontFileEntry(fonts["cjk"])
    cores = entry.prep_cores
    host_s = time.perf_counter() - t0
    twin = FontFileEntry(fonts["cjk_cff2"])
    t0 = time.perf_counter()
    for cp in entry.metadata.codepoints:
        a = entry.outline_curves(entry.glyph_key(cp))
        b = twin.outline_curves(twin.glyph_key(cp))
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"cjk: the CFF2 twin's curves of U+{cp:04X} differ")
    curves_s = time.perf_counter() - t0
    preps = [cores[entry.glyph_key(cp)].make_prep(cp) for cp in entry.metadata.codepoints]
    n_pts = len(entry._flat[1])
    out = os.path.join(d, "cjk_in_process")
    secs, counts, groups = [], [], []
    for _ in range(4):
        sdf_cuda.reset_launches()
        driver.reset_wire_stats()
        t0 = time.perf_counter()
        cli.main(["merge", paths["cjk"], "-o", out], stdout=io.BytesIO())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(sdf_cuda.LAUNCHES["sdf_tiles_pts"])
        groups.append(driver.WIRE_STATS["groups"])
    if compare_bytes(stack, out, auto_dir):
        raise AssertionError("cli merge cjk: in-process tree differs from the subprocess's")
    if counts != groups or min(counts) < 1:
        raise AssertionError(f"cli merge cjk: kernel 1 launches {counts} for groups {groups}")
    n = len(preps)
    emit({"phase": "cli", "step": "merge_in_process", "font": "cjk", "glyphs": n,
          "seconds_first": secs[0], "seconds_warm": statistics.median(secs[1:]),
          "seconds_each": secs, "groups": groups, "launches_sdf_tiles_pts": counts,
          "host_parse_and_cores_s": host_s, "cff2_curves_equal_s": curves_s,
          "lanes_per_glyph": sum(p.npts for p in preps) / n,
          "tiles_per_glyph": sum(p.ntiles256 for p in preps if not p.empty) / n,
          "flattened_points_per_glyph": n_pts / n, "synth_text_lanes_per_glyph": 447,
          "phase_s": time.perf_counter() - t_phase})
    return counts[0]


def phase_flat_renders(font_list) -> dict:
    """Both fonts whole through kernel 6 (one tile table) and kernel 7
    (one padded grid at pack_flat's P_pad, TP = min(1024, P_pad)), one
    launch each a font, with the counts reset just before; every bitmap
    against the exact f64 renderer. Returns the launches per kernel."""
    from versatiles_glyphs_tpu_torch.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu_torch.proto import native
    from versatiles_glyphs_tpu_torch.ops import legacy, sdf_cuda

    dev = torch.device("cuda", 0)
    launches = {"sdf_tiles_flat": 0, "sdf_grid_flat": 0}
    for name, preps in font_list:
        gp = [p for p in preps if not p.empty]
        exact = native.render_sdf_batch(gp) or [
            render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0) for p in gp]
        f_d, m_d, tm_d, P, starts = flat_case(gp, dev)
        tp7 = min(1024, P)
        torch.cuda.synchronize()
        runs = {
            "sdf_tiles_flat": (TP, lambda: legacy.render_bitmaps_cuda_tiles(f_d, tm_d, TP)),
            "sdf_grid_flat": (tp7, lambda: legacy.render_bitmaps_cuda_grid(f_d, m_d, P, tp7)),
        }
        for kname, (tp, run) in runs.items():
            sdf_cuda.reset_launches()
            t0 = time.perf_counter()
            out = run().cpu().numpy()
            secs = time.perf_counter() - t0
            n_launch = sdf_cuda.LAUNCHES[kname]
            launches[kname] += n_launch
            n_pix = n_diff = max_d = 0
            for i, (p, want) in enumerate(zip(gp, exact)):
                n = p.width * p.height
                d = np.abs(glyph_bitmap(kname, out, starts, i)[:n].astype(np.int32)
                           - want.astype(np.int32))
                n_pix += n
                n_diff += int((d > 0).sum())
                max_d = max(max_d, int(d.max(initial=0)))
            frac = n_diff / max(n_pix, 1)
            emit({"phase": "flat_render", "font": name, "kernel": kname, "glyphs": len(gp),
                  "lanes": int(f_d.shape[1]), "P_pad": P, "TP": tp, "out_shape": list(out.shape),
                  "launches": n_launch, "seconds": secs, "pixels": n_pix,
                  "pixels_off_by_1": n_diff, "frac_off": frac, "max_abs_diff": max_d})
            if n_launch != 1:
                raise AssertionError(f"{name}: {n_launch} launches of {kname} for one font")
            if max_d > 1 or frac > 0.05:
                raise AssertionError(f"{name} via {kname}: max |Δ| {max_d} on {frac:.4%} of pixels")
    return launches


def phase_padded_render(font_list, work) -> None:
    """Both fonts through the ``padded`` renderer (the JAX ``jax``) on the
    card: the tree against the exact renderer's contract, seconds a
    font, glyphs/s and peak memory; each font's largest block at four
    chunk budgets (the same bytes at each); the heavy font's last block
    against the CPU padded path, byte for byte."""
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.ops.sdf_torch import _chunk_elems, render_bitmaps_padded
    from versatiles_glyphs_tpu_torch.render.batch import pack_block
    from versatiles_glyphs_tpu_torch.render.driver import Renderer

    dev = torch.device("cuda", 0)
    pad_r, exact_r = Renderer("padded"), Renderer("exact")
    if pad_r.device != dev:
        raise AssertionError(f"Renderer('padded') is on {pad_r.device}")
    for name, preps in font_list:
        got_dir = os.path.join(work, "padded")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sdf_cuda.reset_launches()
        secs, _ = render_font(name, preps, pad_r, got_dir)
        peak = torch.cuda.max_memory_allocated()
        kernel_launches = sum(sdf_cuda.LAUNCHES.values())
        warm = []
        for _ in range(3):
            warm.append(render_font(name, preps, pad_r, os.path.join(work, "padded_warm"))[0])
            shutil.rmtree(os.path.join(work, "padded_warm"))
        want_dir = os.path.join(work, "exact")
        render_font(name, preps, exact_r, want_dir)
        files, n_glyphs, n_pix, n_diff, max_d = compare_trees(name, got_dir, want_dir)
        frac = n_diff / max(n_pix, 1)
        rows = debug_rows(name, got_dir)

        # The largest block at four chunk budgets (pairs of the [glyphs,
        # P, S] temporaries): its time by CUDA events and its peak memory.
        blocks: dict[int, list] = {}
        for p in preps:
            if not p.empty:
                blocks.setdefault(p.codepoint >> 8, []).append(p)
        segs, meta, P = max((pack_block(bp) for bp in blocks.values()),
                            key=lambda t: t[0].shape[0] * t[0].shape[2] * t[2])
        segs_d, meta_d = torch.from_numpy(segs).to(dev), torch.from_numpy(meta).to(dev)
        G, _, S = segs.shape
        budgets, ref = {}, None
        for log2 in (24, 26, 28, 30):
            chunk = max(1, (1 << log2) // (P * S))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            got = render_bitmaps_padded(segs_d, meta_d, P, chunk)
            ref = got if ref is None else ref
            budgets[f"2^{log2}"] = {
                "glyphs_a_chunk": min(chunk, G), "bytes_equal": bool(torch.equal(got, ref)),
                "ms": time_ms(lambda: render_bitmaps_padded(segs_d, meta_d, P, chunk), 2),
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        rec = {"phase": "padded_render", "font": name, "glyphs": len(preps), "blocks": files,
               "pairs": int(sum(len(bp) * P * S for bp in blocks.values())),
               "seconds": secs, "glyphs_per_s": len(preps) / secs,
               "seconds_warm": statistics.median(warm), "seconds_warm_each": warm,
               "glyphs_per_s_warm": len(preps) / statistics.median(warm),
               "max_memory_allocated_bytes": peak, "chunk_budget_pairs": _chunk_elems(dev),
               "kernel_launches": kernel_launches, "pixels": n_pix, "pixels_off_by_1": n_diff,
               "frac_off": frac, "max_abs_diff": max_d,
               "largest_block": {"glyphs": G, "S": S, "P": P, "budgets": budgets}}
        failures = []
        if max_d > 1 or frac > 0.05:
            failures.append(f"max |Δ| {max_d} on {frac:.4%} of pixels")
        if rows != debug_rows(name, want_dir) or not rows:
            failures.append("debug rows differ from the exact renderer's")
        if not all(b["bytes_equal"] for b in budgets.values()):
            failures.append("chunk budgets give different bytes")
        if name == font_list[-1][0]:
            # Its last block on the CPU, byte for byte.
            last = max(blocks)
            cpu_dir = os.path.join(work, "padded_cpu")
            t0 = time.perf_counter()
            render_font(name, [p for p in preps if p.codepoint >> 8 == last],
                        Renderer("padded", device="cpu"), cpu_dir)
            rng = f"{last * 256}-{last * 256 + 255}.pbf"
            with open(os.path.join(got_dir, name, rng), "rb") as f1, \
                    open(os.path.join(cpu_dir, name, rng), "rb") as f2:
                same = f1.read() == f2.read()
            rec["cpu_block"] = {"block": rng, "glyphs": len(blocks[last]), "bytes_equal": same,
                                "cpu_seconds": time.perf_counter() - t0}
            if not same:
                failures.append(f"{rng}: the card's and the CPU's padded bytes differ")
        emit(rec)
        if failures:
            raise AssertionError(f"{name} via the padded renderer: " + "; ".join(failures))
        for sub in ("padded", "exact", "padded_cpu"):
            shutil.rmtree(os.path.join(work, sub), ignore_errors=True)


def grads_agree(gt, gf, loss_t, loss_f, name: str = "flat") -> dict:
    """The JAX package's check between its jnp and kernel backends (the
    kernel side's loss is reported as ``loss_<name>``): the
    loss within 1e-5 relative; the translate and gain gradients within
    1e-4·max|g|; curve gradients within 1e-3·max|g| on ≥ 85 % of
    elements (the torch backend splits exact distance ties evenly, the
    flat kernels give them to the first argmin) and per-glyph sums
    within 1e-4·max|g|."""
    res = {"loss_torch": loss_t, f"loss_{name}": loss_f,
           "loss_rel_diff": abs(loss_t - loss_f) / max(abs(loss_t), 1e-12)}
    ok = res["loss_rel_diff"] <= 1e-5
    for k in ("translate", "log_gain"):
        scale = max(float(gt[k].abs().max()), 1e-6)
        res[f"{k}_max_diff_rel"] = float((gt[k] - gf[k]).abs().max()) / scale
        ok &= res[f"{k}_max_diff_rel"] <= 1e-4
    scale = max(float(gt["curves"].abs().max()), 1e-6)
    delta = (gt["curves"] - gf["curves"]).abs()
    res["curves_frac_off"] = float((delta > 1e-3 * scale).float().mean())
    res["curves_glyph_sum_diff_rel"] = float(
        (gt["curves"].sum((1, 2)) - gf["curves"].sum((1, 2))).abs().max()) / scale
    ok &= res["curves_frac_off"] < 0.15 and res["curves_glyph_sum_diff_rel"] <= 1e-4
    res["agree"] = bool(ok)
    return res


def phase_fit(batch, work) -> dict:
    from versatiles_glyphs_tpu_torch.models.fitting import FontFitter, StepGraph, build_flat_plan
    from versatiles_glyphs_tpu_torch.models.render_fitted import fitted_preps, render_fitted_pbfs
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.ops.flat_loss import STEP_KERNELS
    from versatiles_glyphs_tpu_torch.render.driver import Renderer
    from versatiles_glyphs_tpu_torch.utils.synth_font import SynthEntry

    dev = torch.device("cuda", 0)
    plan = build_flat_plan(batch.curve_mask, batch.meta, FIT_DEPTH, batch.target.shape[1])
    emit({"phase": "fit", "step": "batch", "glyphs": int(batch.curves0.shape[0]),
          "curves": int(batch.curve_mask.sum()), "curves_max": int(batch.curves0.shape[1]),
          "depth": FIT_DEPTH, "lanes": plan.N, "tiles": plan.T,
          "pixels": int(batch.pix_mask.sum()), "pixels_padded": int(batch.pix_mask.size),
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "f32_matmul_precision": torch.get_float32_matmul_precision()})

    # step_many on the card: the first call captures the CUDA graph of the
    # forward and backward (StepGraph.WARMUP real runs on a side stream,
    # then a capture that runs nothing), every step replays it.
    fitter = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    params, opt, db = fitter.init(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    params, opt, losses = fitter.step_many(params, opt, db, FIT_STEPS)
    secs = time.perf_counter() - t0
    launches = dict(sdf_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    captured = {k: v for k, v in fitter._graph.launches.items() if v}
    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    params, opt, more = fitter.step_many(params, opt, db, 10)
    warm = (time.perf_counter() - t0) / 10
    replayed = dict(sdf_cuda.LAUNCHES)
    rec = {"phase": "fit", "step": "descend", "steps": FIT_STEPS, "seconds": secs,
           "seconds_per_step_warm": warm, "loss_first": float(losses[0]),
           "loss_min": float(losses.min()), "loss_last": float(losses[-1]),
           "loss_after_30": float(more[-1]), "launches": launches,
           "graph_warmup_runs": StepGraph.WARMUP, "launches_captured": captured,
           "launches_10_replays": {k: v for k, v in replayed.items() if v},
           "max_memory_allocated_bytes": peak}
    emit(rec)
    if not (np.isfinite(losses).all() and losses.min() < losses[0]):
        raise AssertionError(f"the fit did not descend: {losses.tolist()}")
    fit_kernels = STEP_KERNELS
    if captured != dict.fromkeys(fit_kernels, 1):
        raise AssertionError(f"the step's graph recorded {captured}")
    if not (all(launches[k] == FIT_STEPS + StepGraph.WARMUP and replayed[k] == 10
                for k in fit_kernels)
            and launches["adam_flat"] == FIT_STEPS and replayed["adam_flat"] == 10):
        raise AssertionError(f"{launches} kernel launches for {FIT_STEPS} steps and "
                             f"{StepGraph.WARMUP} warm-up runs; {replayed} for 10 replays "
                             "(Adam once a step)")
    adam = adam_kernel(dev)

    # Graphed steps against eager ones, bit for bit (parameters and
    # losses), for the flat backend at full size and the torch backend on
    # the first 256-codepoint block; each one's peak memory.
    block = first_block(batch)
    ft = FontFitter(depth=FIT_DEPTH, backend="torch", device=dev)
    for name, f, b in (("flat", fitter, batch), ("torch", ft, block)):
        pe, oe, de = f.init(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        le = eager_losses(f.loss, pe, oe, de, 10)
        peak_e = torch.cuda.max_memory_allocated()
        pg, og, dg = f.init(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, lg = f.step_many(pg, og, dg, 10)
        peak_g = torch.cuda.max_memory_allocated()
        diff = {k: int((pe[k] != pg[k]).sum()) for k in pe}
        equal = not any(diff.values()) and np.array_equal(le.view(np.int32), lg.view(np.int32))
        emit({"phase": "fit", "step": "graphed_vs_eager", "backend": name,
              "glyphs": int(b.curves0.shape[0]), "steps": 10, "bit_equal": equal,
              "params_differing_elements": diff, "loss_last": float(lg[-1]),
              "max_memory_allocated_bytes_eager": peak_e,
              "max_memory_allocated_bytes_graphed": peak_g})
        if not equal:
            raise AssertionError(f"{name}: 10 graphed steps differ from 10 eager steps: {diff}")

    # The warm flat step, graphed against eager, in turns (e, g, g, e, ...),
    # after one step that captures the graph of these tensors again.
    fitter.step_many(params, opt, db, 1)
    turns = {"eager": [], "graphed": []}
    runs = {"eager": lambda: eager_losses(fitter.loss, params, opt, db, 10),
            "graphed": lambda: fitter.step_many(params, opt, db, 10)}
    for name in ("eager", "graphed", "graphed", "eager") * 4:
        t0 = time.perf_counter()
        runs[name]()
        turns[name].append((time.perf_counter() - t0) / 10)
    emit({"phase": "fit", "step": "warm_in_turns", "steps_a_turn": 10,
          **{f"seconds_per_step_warm_{k}": statistics.median(v) for k, v in turns.items()},
          **{f"seconds_per_step_warm_{k}_each": v for k, v in turns.items()}})

    # 5 + 5 steps through a checkpoint against 10 steps: into a fresh
    # init (a new graph), and back into the same tensors (the same graph).
    p10, o10, d10 = fitter.init(batch)
    fitter.step_many(p10, o10, d10, 10)
    pa, oa, da = fitter.init(batch)
    fitter.step_many(pa, oa, da, 5)
    ckpt = os.path.join(work, "checkpoint")
    FontFitter.save_checkpoint(ckpt, pa, oa)
    graph = fitter._graph
    fitter.step_many(pa, oa, da, 3)
    FontFitter.restore_checkpoint(ckpt, like=(pa, oa))
    fitter.step_many(pa, oa, da, 5)
    kept = fitter._graph is graph
    pb, ob, db_ = fitter.init(batch)
    pb, ob = FontFitter.restore_checkpoint(ckpt, like=(pb, ob))
    fitter.step_many(pb, ob, db_, 5)
    delta = max(float((p10[k] - pb[k]).detach().abs().max()) for k in p10)
    delta_kept = max(float((p10[k] - pa[k]).detach().abs().max()) for k in p10)
    emit({"phase": "fit", "step": "resume", "max_abs_diff_5_5_vs_10": delta,
          "max_abs_diff_5_5_vs_10_same_graph": delta_kept, "graph_kept_by_restore": kept})
    if delta != 0.0 or delta_kept != 0.0 or not kept:
        raise AssertionError(f"5 + 5 resumed steps differ from 10 by {delta} / {delta_kept} "
                             f"(graph kept: {kept})")

    # The torch and flat backends on the first 256-codepoint block.
    ff = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    pt, _, dt = ft.init(block)
    pf, _, df = ff.init(block)
    lt, gt = ft.value_and_grad(pt, dt)
    lf, gf = ff.value_and_grad(pf, df)
    cmp = grads_agree(gt, gf, float(lt), float(lf))
    emit({"phase": "fit", "step": "backends", "glyphs": len(block.codepoints), **cmp})
    if not cmp["agree"]:
        raise AssertionError("torch and flat backends disagree")

    # The fitted atlas: cuda renderer against the exact one, on the f32
    # wire. Fitted curves no longer share end points, so every curve is
    # an open chain; on the q16 wires a pixel row through a chain end
    # within rounding of its center flips its winding (the JAX package
    # renders fitted atlases the same way). The atlas is the fit's own
    # f32 chain, which the f32 wire carries unrounded. Before it, the
    # open ends of the float64 chain that the crossing rule (y <= a row's
    # centre) decides one way in float64 and the other in f32: each
    # flips its row right of the end on the f32 wire.
    entry = SynthEntry(1700, 32, seed=0, quads=8)
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    n_open, apart = 0, []
    preps64 = fitted_preps(host, batch, entry, FIT_DEPTH)
    for p in preps64:
        for ring in p.rings_px:
            if np.array_equal(ring[0], ring[-1]):
                continue
            for x, y in (ring[0], ring[-1]):
                n_open += 1
                y32, centre = float(np.float32(y)), np.round(y - 0.5) + 0.5
                if (y <= centre) != (y32 <= centre):
                    apart.append({"codepoint": p.codepoint, "x": x, "y_f64": y, "y_f32": y32})
    emit({"phase": "fit", "step": "open_ends", "glyphs": len(preps64), "open_ends": n_open,
          "decided_apart_in_f32": len(apart), "first": apart[:8]})
    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    written = render_fitted_pbfs(host, batch, entry, FIT_DEPTH, os.path.join(work, "fit_cuda"),
                                 "synth_fit", renderer=Renderer("cuda", transport="f32"))
    render_s = time.perf_counter() - t0
    render_launches = sdf_cuda.LAUNCHES["sdf_tiles_pts"]
    render_fitted_pbfs(host, batch, entry, FIT_DEPTH, os.path.join(work, "fit_exact"),
                       "synth_fit", renderer=Renderer("exact"))
    files, n_glyphs, n_pix, n_diff, max_d = compare_trees(
        "synth_fit", os.path.join(work, "fit_cuda"), os.path.join(work, "fit_exact"))
    frac = n_diff / max(n_pix, 1)
    emit({"phase": "fit", "step": "render", "blocks": files, "written": len(written),
          "glyphs": n_glyphs, "seconds": render_s, "launches": render_launches,
          "pixels": n_pix, "pixels_off_by_1": n_diff, "frac_off": frac, "max_abs_diff": max_d})
    if max_d > 1 or frac > 0.05 or not render_launches or files != len(written):
        raise AssertionError(f"fitted atlas: max |Δ| {max_d} on {frac:.4%} of pixels")
    return launches, adam


def phase_padded_fit(batch) -> dict:
    """20 Adam steps of `batch_loss_kernel` (the padded kernel pair, on
    its own batch) from the fit phase's start, with the counts reset just
    before; then its loss and gradients against the torch backend's on
    the first 256-codepoint block. Returns the launches per kernel."""
    from versatiles_glyphs_tpu_torch.models.fitting import (
        PARAM_KEYS, FontFitter, batch_loss_kernel, padded_batch)
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda

    dev = torch.device("cuda", 0)
    fitter = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    steps = functools.partial(eager_losses, functools.partial(batch_loss_kernel, depth=FIT_DEPTH))

    params, opt = fitter.init(batch)[:2]
    db = padded_batch(batch, dev)
    torch.cuda.synchronize()
    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    losses = steps(params, opt, db, FIT_STEPS)
    secs = time.perf_counter() - t0
    launches = dict(sdf_cuda.LAUNCHES)
    t0 = time.perf_counter()
    more = steps(params, opt, db, 10)
    warm = (time.perf_counter() - t0) / 10
    emit({"phase": "padded_fit", "step": "descend", "steps": FIT_STEPS, "seconds": secs,
          "seconds_per_step_warm": warm, "loss_first": float(losses[0]),
          "loss_min": float(losses.min()), "loss_last": float(losses[-1]),
          "loss_after_30": float(more[-1]), "launches": launches})
    if not (np.isfinite(losses).all() and losses.min() < losses[0]):
        raise AssertionError(f"the padded fit did not descend: {losses.tolist()}")
    if not (launches["sdf_min_field_padded"] == launches["sdf_min_field_padded_bwd"]
            == launches["adam_flat"] == FIT_STEPS):
        raise AssertionError(f"{launches} kernel launches for {FIT_STEPS} padded steps")

    block = first_block(batch)
    ft = FontFitter(depth=FIT_DEPTH, backend="torch", device=dev)
    pt, _, dt = ft.init(block)
    pk = fitter.init(block)[0]
    lt, gt = ft.value_and_grad(pt, dt)
    lk = batch_loss_kernel(pk, padded_batch(block, dev), FIT_DEPTH)
    gk = dict(zip(PARAM_KEYS, torch.autograd.grad(lk, [pk[k] for k in PARAM_KEYS])))
    cmp = grads_agree(gt, gk, float(lt), float(lk.detach()), name="padded")
    emit({"phase": "padded_fit", "step": "backends", "glyphs": len(block.codepoints), **cmp})
    if not cmp["agree"]:
        raise AssertionError("torch backend and batch_loss_kernel disagree")
    return launches


def one_device_agree(loss, grads, loss1, grads1, B: int) -> dict:
    """A sharded fitter's loss and gradients against the one-device
    fitter's on the same batch: the loss within 1e-6 relative, each
    gradient (its first B rows) within 1e-5·max|g| (the shards' sums are
    added in another order than one mean), rows past B exactly 0."""
    res = {"loss_sharded": float(loss), "loss_one_device": float(loss1),
           "loss_rel_diff": abs(float(loss) - float(loss1)) / max(abs(float(loss1)), 1e-12)}
    ok = res["loss_rel_diff"] <= 1e-6
    for k, g1 in grads1.items():
        g = grads[k]
        if g.dim():
            ok &= not bool(g[B:].any())
            g = g[:B]
        scale = max(float(g1.abs().max()), 1e-12)
        res[f"{k}_max_diff_rel"] = float((g - g1).abs().max()) / scale
        ok &= res[f"{k}_max_diff_rel"] <= 1e-5
    res["agree"] = bool(ok)
    return res


def steps_in_turns(runs: dict, k: int = 10) -> dict:
    """Warm seconds a step of each ``runs[name]()`` (``k`` steps, ending
    in the losses' fetch), in turns a, b, c, c, b, a, four times: the
    median, and every turn's."""
    names = list(runs)
    secs = {name: [] for name in names}
    for _ in range(4):
        for name in names + names[::-1]:
            t0 = time.perf_counter()
            runs[name]()
            secs[name].append((time.perf_counter() - t0) / k)
    return {**{f"seconds_per_step_warm_{n}": statistics.median(v) for n, v in secs.items()},
            **{f"seconds_per_step_warm_{n}_each": v for n, v in secs.items()}}


def sharded_graphed_vs_eager(fitter, batch, name: str) -> dict:
    """10 steps of a sharded fitter through `step_many` (the graph a
    shard, captured in the first call) against 10 eager `step` calls,
    each from a fresh `init`: bit-equality of the parameters and the
    losses, and each one's peak memory from `init` on, above what was
    allocated before it."""
    def fresh():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated(), *fitter.init(batch)

    held, pe, oe, se = fresh()
    le = eager_losses(fitter.loss, pe, oe, se, 10)
    peak_e = torch.cuda.max_memory_allocated() - held
    held, pg, og, sg = fresh()
    lg = fitter.step_many(pg, og, sg, 10)[2]
    peak_g = torch.cuda.max_memory_allocated() - held
    diff = {k: int((pe[k] != pg[k]).sum()) for k in pe}
    return {"phase": "sharded_fit", "backend": name, "step": "graphed_vs_eager",
            "glyphs": int(batch.curves0.shape[0]), "shards": len(sg), "steps": 10,
            "bit_equal": not any(diff.values()) and np.array_equal(le.view(np.int32),
                                                                   lg.view(np.int32)),
            "params_differing_elements": diff, "loss_last": float(lg[-1]),
            "peak_memory_above_start_bytes_eager": peak_e,
            "peak_memory_above_start_bytes_graphed": peak_g}


def phase_sharded_fit(batch, work) -> dict:
    """The fit of phase 5 sharded over the card listed twice, for the
    flat backend (graphed, `ShardedStepGraph`) and for
    `make_sharded_kernel_loss`, the torch backend's graphed sharded step
    on block 0, then the graft entry's two functions; see the module
    docstring. Returns the launches per kernel of each loss's 20-step
    run and of the 10 steps after it."""
    import __graft_entry_torch__ as graft
    from versatiles_glyphs_tpu_torch.models.fitting import (
        PARAM_KEYS, FontFitter, StepGraph, batch_loss_kernel, make_sharded_kernel_loss,
        padded_batch, split_batch)
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
    from versatiles_glyphs_tpu_torch.ops.flat_loss import STEP_KERNELS

    dev = torch.device("cuda", 0)
    devices = [dev, dev]
    B = batch.curves0.shape[0]
    sh = FontFitter(depth=FIT_DEPTH, backend="flat", devices=devices)
    one = FontFitter(depth=FIT_DEPTH, backend="flat", device=dev)
    padded = make_sharded_kernel_loss(devices, FIT_DEPTH, B)

    def grads_of(loss, params):
        return dict(zip(PARAM_KEYS, torch.autograd.grad(loss, [params[k] for k in PARAM_KEYS])))

    one_padded = functools.partial(batch_loss_kernel, depth=FIT_DEPTH)

    def eager_steps(loss_fn):
        return functools.partial(eager_losses, loss_fn)

    # The padded pair's own batches: one device's, and a shard's each (the sharded fitter's rows).
    pad1 = padded_batch(batch, dev)
    pads = [padded_batch(part, d) for part, d in zip(split_batch(batch, 2)[1], devices)]

    launches = {}
    failures = []
    # name -> (sharded loss, one-device loss, k sharded steps, k one-device steps, k eager
    # sharded steps where the sharded steps are graphed, sharded init, one-device init)
    for name, (sharded_loss, one_loss, run, run_one, run_eager, init_sh, init_one) in {
        "flat": (sh.loss, one.loss, lambda *a: sh.step_many(*a)[2],
                 lambda *a: one.step_many(*a)[2], eager_steps(sh.loss), sh.init, one.init),
        "padded": (padded, one_padded, eager_steps(padded), eager_steps(one_padded), None,
                   lambda b: (*sh.init(b)[:2], pads), lambda b: (*one.init(b)[:2], pad1)),
    }.items():
        ps, os_, ss = init_sh(batch)
        p1, o1, d1 = init_one(batch)
        ls = sharded_loss(ps, ss)
        l1 = one_loss(p1, d1)
        g1 = grads_of(l1, p1)
        cmp = one_device_agree(ls.detach(), grads_of(ls, ps), l1.detach(), g1, B)
        emit({"phase": "sharded_fit", "loss": name, "step": "one_device", "glyphs": B,
              "shards": len(ss),  # a glyph table a shard: the plan's, or the padded metas
              "glyphs_a_shard": [len(s.get("glyph_rows", s.get("meta"))) for s in ss], **cmp})
        if not cmp["agree"]:
            failures.append(f"{name}: the sharded loss or gradients disagree with one device")

        # 20 steps (for the flat loss the first captures a graph a shard:
        # WARMUP runs a shard, then a replay a shard and step), then 10.
        torch.cuda.synchronize()
        sdf_cuda.reset_launches()
        t0 = time.perf_counter()
        losses = run(ps, os_, ss, FIT_STEPS)
        secs = time.perf_counter() - t0
        first = dict(sdf_cuda.LAUNCHES)
        sdf_cuda.reset_launches()
        run(ps, os_, ss, 10)
        launches[name] = {"steps_20": first, "steps_10": dict(sdf_cuda.LAUNCHES)}
        # One step first, so that the one-device fitter's graph is captured
        # before the turns time it.
        run_one(p1, o1, d1, 1)
        turns = {"one_device": lambda: run_one(p1, o1, d1, 10),
                 "sharded": lambda: run(ps, os_, ss, 10)}
        if run_eager is not None:
            turns["sharded_eager"] = lambda: run_eager(ps, os_, ss, 10)
        warm = steps_in_turns(turns)
        kernels = (STEP_KERNELS if name == "flat"
                   else ("sdf_min_field_padded", "sdf_min_field_padded_bwd"))
        warmup = StepGraph.WARMUP if name == "flat" else 0

        graphed = {}
        if name == "flat":
            # The graph a shard of a fresh init, replayed once, against one
            # device at the same parameters; what each capture recorded.
            pg, _, sg = sh.init(batch)
            graph = sh._step_graph(pg, sg)
            lg, gg = graph.replay()
            graphed = one_device_agree(lg, dict(zip(PARAM_KEYS, gg)), l1.detach(), g1, B)
            graphed["launches_captured_a_shard"] = [
                {k: v for k, v in g.launches.items() if v} for g in graph.shards]
            if not graphed["agree"] or graphed["launches_captured_a_shard"] != [
                    dict.fromkeys(kernels, 1)] * len(devices):
                failures.append(f"graphed sharded step against one device: {graphed}")

        # 10 sharded steps against 10 on one device, from the start.
        pa, oa, sa = init_sh(batch)
        pb, ob, db = init_one(batch)
        la, lb = run(pa, oa, sa, 10), run_one(pb, ob, db, 10)
        diff10 = {k: float((pa[k][:B] if pa[k].dim() else pa[k]).sub(pb[k]).detach().abs().max())
                  for k in PARAM_KEYS}
        loss10 = float(np.abs(la - lb).max() / np.abs(lb).max())

        # 5 + 5 sharded steps through a checkpoint against 10: into a
        # fresh init, and back into the same tensors (the graph kept).
        p10, o10, s10 = init_sh(batch)
        run(p10, o10, s10, 10)
        pc, oc, sc = init_sh(batch)
        run(pc, oc, sc, 5)
        ckpt = os.path.join(work, f"checkpoint_sharded_{name}")
        FontFitter.save_checkpoint(ckpt, pc, oc)
        kept_graph = sh._graph
        run(pc, oc, sc, 3)
        FontFitter.restore_checkpoint(ckpt, like=(pc, oc))
        run(pc, oc, sc, 5)
        kept = sh._graph is kept_graph
        pd, od, sd = init_sh(batch)
        pd, od = FontFitter.restore_checkpoint(ckpt, like=(pd, od))
        run(pd, od, sd, 5)
        delta = max(float((p10[k] - pd[k]).detach().abs().max()) for k in PARAM_KEYS)
        delta_kept = max(float((p10[k] - pc[k]).detach().abs().max()) for k in PARAM_KEYS)

        rec = {"phase": "sharded_fit", "loss": name, "step": "descend", "steps": FIT_STEPS,
               "devices": [str(d) for d in devices], "seconds": secs, **warm,
               "loss_first": float(losses[0]), "loss_min": float(losses.min()),
               "loss_last": float(losses[-1]), "launches": first,
               "launches_10_steps": launches[name]["steps_10"], "graph_warmup_runs": warmup,
               "graphed_replay_vs_one_device": graphed,
               "ten_steps_vs_one_device": {"loss_max_rel_diff": loss10,
                                           "param_max_abs_diff": diff10},
               "max_abs_diff_5_5_vs_10": delta,
               "max_abs_diff_5_5_vs_10_same_tensors": delta_kept}
        emit(rec)
        if not (np.isfinite(losses).all() and losses.min() < losses[0]):
            failures.append(f"{name}: the sharded fit did not descend: {losses.tolist()}")
        # The step's kernels once a shard, Adam once a step (on the first device).
        if not (all(first[k] == 2 * (FIT_STEPS + warmup)
                    and launches[name]["steps_10"][k] == 2 * 10 for k in kernels)
                and first["adam_flat"] == FIT_STEPS
                and launches[name]["steps_10"]["adam_flat"] == 10):
            failures.append(f"{name}: {launches[name]} launches for {FIT_STEPS} then 10 steps "
                            f"on 2 shards ({warmup} warm-up runs a shard)")
        if loss10 > 1e-5 or max(diff10.values()) > 1e-3:
            failures.append(f"{name}: 10 sharded steps differ from 10 on one device: "
                            f"{loss10}, {diff10}")
        if delta != 0.0 or delta_kept != 0.0:
            failures.append(f"{name}: 5 + 5 resumed sharded steps differ from 10 by {delta} / "
                            f"{delta_kept}")
        if name == "flat" and not kept:
            failures.append("restore_checkpoint dropped the sharded graph")

    # Graphed sharded steps against eager sharded ones, bit for bit: the
    # flat backend at full size, the torch backend on block 0.
    block = first_block(batch)
    st = FontFitter(depth=FIT_DEPTH, backend="torch", devices=devices)
    for name, fitter, b in (("flat", sh, batch), ("torch", st, block)):
        rec = sharded_graphed_vs_eager(fitter, b, name)
        emit(rec)
        if not rec["bit_equal"]:
            failures.append(f"{name}: 10 graphed sharded steps differ from 10 eager ones: "
                            f"{rec['params_differing_elements']}")

    # The graft entry: entry() on the card, then the dry run over the
    # card listed twice.
    sdf_cuda.reset_launches()
    fn, args = graft.entry()
    out = fn(*args).cpu()
    torch.cuda.synchronize()
    entry_launches = sdf_cuda.LAUNCHES["sdf_tiles_pts"]
    deltas, words, anchors, meta = (a.cpu() for a in args)
    plain = sdf_torch.render_tiles_pts(
        sdf_torch.dequantize(sdf_torch.reconstruct_delta(deltas, anchors)), words,
        sdf_torch.derive_tmeta(meta, 256, 256), 256)
    entry_equal = torch.equal(out, plain)
    sdf_cuda.reset_launches()
    t0 = time.perf_counter()
    dry = graft.dryrun_multichip(2)
    dry_s = time.perf_counter() - t0
    dry_launches = dict(sdf_cuda.LAUNCHES)
    emit({"phase": "sharded_fit", "step": "graft_entry", "entry_launches": entry_launches,
          "entry_shape": list(out.shape), "entry_bytes_equal_plain": entry_equal,
          "entry_nonzero_bytes": int((out > 0).sum()), "dryrun": dry, "dryrun_seconds": dry_s,
          "dryrun_launches": dry_launches})
    if entry_launches != 1 or not entry_equal or not out.any():
        failures.append(f"entry(): {entry_launches} launches, bytes equal {entry_equal}")
    if not (dry_launches["sdf_min_field_pts"] == dry_launches["sdf_min_field_bwd"] == 2
            and dry_launches["sdf_tiles_pts"] >= 2):
        failures.append(f"dryrun_multichip(2): launches {dry_launches}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def main() -> None:
    # Both checks come before any output: without a card, or outside a
    # checkout of the repo, the script prints no result.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import versatiles_glyphs_tpu_torch.ops.sdf_cuda  # noqa: F401

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return got

    sms, sm_clock = timed("device", phase_device)
    timed("build", phase_build)
    font_list = timed("host_prep", fonts)
    batch = timed("host_prep", fit_batch)
    heavy_batch = timed("host_prep", heavy_fit_batch)
    k = timed("kernel_render", phase_kernel, font_list[0][1], font_list[1][1])
    kf = timed("kernel_fit", phase_fit_kernels, batch, heavy_batch, font_list[0][1])
    kfl = timed("kernel_fused_loss", phase_fused_loss_kernels, batch)
    kl = timed("kernel_flat", phase_flat_kernels, font_list[0][1], font_list[1][1])
    kp = timed("kernel_padded", phase_padded_kernels, batch, heavy_batch)
    kt = timed("kernel_tools", phase_tool_kernels, font_list[0][1])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        launches = timed("slice", phase_slice, font_list, work)
        flat_launches = timed("flat_renders", phase_flat_renders, font_list)
        timed("padded_render", phase_padded_render, font_list, work)
        launches += timed("cli", phase_cli, work)
        fit_launches, ka = timed("fit", phase_fit, batch, work)
        pad_launches = timed("padded_fit", phase_padded_fit, batch)
        sharded_launches = timed("sharded_fit", phase_sharded_fit, batch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tool_launches, roof_ops_per_s = timed("tools", phase_tools)
    timed("profile", phase_profile)
    # The roof is the best rate the roof kernel reached in this run,
    # in the tool or in phase 3.
    roof_ops_per_s = max(roof_ops_per_s, kt["alu_roof"]["f32_ops"] / (kt["alu_roof"]["ms"] * 1e-3))
    emit({"phase": "seconds", "since_start": time.perf_counter() - T_START, **seconds})

    def row(name, replaces, n_launch, err, ms, plain_ms, bound, **more):
        # No single PyTorch call computes any of these functions but
        # Adam's update (its row passes library_ms). Beside
        # the contract's keys: "graph_ms", the same launches replayed from a
        # CUDA graph (the card's time where the host's enqueue of a launch
        # takes longer than the kernel); the share of the bound the launch reaches,
        # and its f32 rate over the un-fused ALU roof that the roofline
        # tool measured in this run. The counts the bound comes from are
        # on each kernel's own `phase: kernel` record. alu_roof's bound
        # counts the operations it executes, decoy chains included (the
        # stored value needs one chain of four), so its shares say how
        # near the launch comes to the peak and are not comparable with
        # the other rows'. The render and min-field rows count their
        # function by its least known operations
        # (`tools.work.row_shared_work`: the crossing tested once a
        # bitmap row and segment), whichever kernel computes it.
        return {"name": name, "route": "cuda",
                "source": f"versatiles_glyphs_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": None,
                "share_of_bound": bound["bound_ms"] / ms,
                "share_of_alu_roof": bound["f32_ops"] / (ms * 1e-3) / roof_ops_per_s, **more}

    def sharded(loss, name):
        # Phase 6's sharded steps: the launches of the first 20 (graph
        # warm-up runs included) and a step of the 10 after.
        n = sharded_launches[loss]
        return {"launches_sharded": n["steps_20"][name],
                "launches_sharded_step": n["steps_10"][name] / 10}

    from versatiles_glyphs_tpu_torch.tools.work import share_of_issue_rate

    jax_ops = "versatiles_glyphs_tpu/ops/"
    k8, k9 = kt["alu_roof"], kt["sdf_tiles_pts_acc"]
    emit({"kernels": [
        row("sdf_tiles_pts", jax_ops + "sdf_pallas.py:61", launches, k["max_abs_err"],
            k["ms"], k["plain_ms"], k, graph_ms=k["graph_ms"],
            ms_synth_heavy=k["ms_synth_heavy"]),
        row("sdf_min_field_pts", jax_ops + "sdf_pallas.py:339", fit_launches["sdf_min_field_pts"],
            kf["min_err"], kf["min_ms"], kf["min_plain_ms"], kf["min_bound"],
            graph_ms=kf["min_graph_ms"], **sharded("flat", "sdf_min_field_pts")),
        row("sdf_min_field_bwd", jax_ops + "sdf_grad.py:492", fit_launches["sdf_min_field_bwd"],
            kf["bwd_err"], kf["bwd_ms"], kf["bwd_plain_ms"], kf["bwd_bound"],
            graph_ms=kf["bwd_graph_ms"], ms_synth_heavy=kf["bwd_ms_fit_heavy"],
            graph_ms_synth_heavy=kf["bwd_graph_ms_fit_heavy"],
            ms_one_lane_wins_all=kf["bwd_ms_one_wins"],
            graph_ms_one_lane_wins_all=kf["bwd_graph_ms_one_wins"],
            **sharded("flat", "sdf_min_field_bwd")),
        row("sdf_min_field_padded", jax_ops + "sdf_grad.py:111",
            pad_launches["sdf_min_field_padded"], kp["pad_err"], kp["pad_ms"],
            kp["pad_plain_ms"], kp["pad_bound"], graph_ms=kp["pad_graph_ms"],
            **sharded("padded", "sdf_min_field_padded")),
        row("sdf_min_field_padded_bwd", jax_ops + "sdf_grad.py:169",
            pad_launches["sdf_min_field_padded_bwd"], kp["pad_bwd_err"], kp["pad_bwd_ms"],
            kp["pad_bwd_plain_ms"], kp["pad_bwd_bound"], graph_ms=kp["pad_bwd_graph_ms"],
            ms_synth_heavy=kp["pad_bwd_ms_heavy"],
            ms_one_segment_wins_all=kp["pad_bwd_ms_one_wins"],
            **sharded("padded", "sdf_min_field_padded_bwd")),
        row("sdf_tiles_flat", jax_ops + "legacy.py:147", flat_launches["sdf_tiles_flat"],
            kl["sdf_tiles_flat_err"], kl["sdf_tiles_flat_ms"], kl["sdf_tiles_flat_plain_ms"],
            kl["sdf_tiles_flat_bound"], graph_ms=kl["sdf_tiles_flat_graph_ms"],
            ms_synth_heavy=kl["sdf_tiles_flat_ms_synth_heavy"]),
        row("sdf_grid_flat", jax_ops + "legacy.py:40", flat_launches["sdf_grid_flat"],
            kl["sdf_grid_flat_err"], kl["sdf_grid_flat_ms"], kl["sdf_grid_flat_plain_ms"],
            kl["sdf_grid_flat_bound"], graph_ms=kl["sdf_grid_flat_graph_ms"],
            ms_synth_heavy=kl["sdf_grid_flat_ms_synth_heavy"]),
        # The roof kernel's executed f32 instructions (un-fused) over the
        # most the card's SMs issue at their top clock.
        row("alu_roof", "scripts/roofline.py:190", tool_launches["alu_roof"],
            k8["max_abs_err"], k8["ms"], k8["plain_ms"], k8, graph_ms=k8["graph_ms"],
            share_of_issue_rate=share_of_issue_rate(k8["f32_ops"], k8["ms"], sms, sm_clock),
            sms=sms, sm_clock_max_mhz=sm_clock),
        row("sdf_tiles_pts_acc", "scripts/kernel_ab.py:69", tool_launches["sdf_tiles_pts_acc"],
            k9["max_abs_err"], k9["ms"], k9["plain_ms"], k9, graph_ms=k9["graph_ms"]),
        # Replaces no Pallas kernel (optax's update is XLA's): its ms is the
        # card's time queued behind a sleep, and library_ms is
        # torch.optim.Adam's foreach step on the same leaves, which the port
        # no longer calls.
        row("adam_flat", None, fit_launches["adam_flat"], ka["max_abs_err"], ka["ms"],
            ka["plain_ms"], ka, graph_ms=ka["graph_ms"], library_ms=ka["library_ms"],
            host_us_a_step=ka["host_us_a_step"],
            library_host_us_a_step=ka["library_host_us_a_step"], **sharded("flat", "adam_flat")),
        # The fused flat-fit loss (no Pallas kernel: XLA's ops around the
        # min-field pair in the JAX package).
        *(row(name, None, fit_launches[name], kfl[name]["err"], kfl[name]["ms"],
              kfl[name]["plain_ms"], kfl[name]["bound"], graph_ms=kfl[name]["graph_ms"],
              **sharded("flat", name)) for name in kfl),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
