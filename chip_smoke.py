#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's atlas render path once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device (built
for Hopper, sm_90a). It imports the port (`versatiles_glyphs_tpu_torch`),
its host modules from `versatiles_glyphs_tpu`, torch and numpy, and
never JAX. Phases, each printing one JSON line:

1. device — the card's name and power limit (nvidia-smi).
2. build  — nvcc builds every kernel of the path from ``csrc/``.
3. kernel — each kernel against its plain PyTorch version on the card,
   at the render path's shapes (group 0 of the first font, i8 and f32
   wires) and on degenerate segments; bytes must be equal. Times both.
4. slice  — two synthesized fonts at real sizes (a text font of 1,700
   glyphs over 7 blocks, a heavy one of 1,150 glyphs of ~1,000 points)
   through the port's renderer, render session, native PBF encode and
   writer, with the launch counts reset just before. Every PBF is held
   against the exact f64 renderer (integer metrics equal, bitmaps
   within 1 on at most 5 % of pixels) and one block against the
   ``torch`` backend on the CPU byte for byte.

The slice enters at the renderer, below the font parser, so that it
needs no fontTools: its outlines are synthesized and flattened by
`ops.flatten` (the CLI over the same outlines as a TTF is held against
the JAX CLI by the CPU tests). Then a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TP = 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from versatiles_glyphs_tpu_torch.ops import _build, sdf_cuda

    t0 = time.perf_counter()
    _build.load(sdf_cuda.KERNEL)
    so, nvcc_s = _build.BUILDS[sdf_cuda.KERNEL]
    emit({"phase": "build", "kernel": sdf_cuda.KERNEL, "arch": "sm_90a",
          "so": os.path.relpath(so, ROOT), "nvcc_s": nvcc_s,
          "load_s": time.perf_counter() - t0})


def fonts():
    """(name, preps) of the two synthesized fonts: host prep done once,
    outside every timed region."""
    from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

    return [
        ("synth_text", curved_preps(1700, 32, seed=0, quads=8)),
        ("synth_heavy", curved_preps(1150, 0x600, seed=1, quads=24)),
    ]


def first_group(preps):
    """The glyphs the render session dispatches as its first group."""
    from versatiles_glyphs_tpu_torch.render.driver import Renderer

    lanes = tiles = 0
    out = []
    for p in preps:
        if out and (lanes + p.npts > Renderer._LANES_SOFT
                    or tiles + p.ntiles256 > Renderer._TILES_SOFT):
            break
        out.append(p)
        lanes += p.npts
        tiles += p.ntiles256
    return out


def degenerate_preps():
    from versatiles_glyphs_tpu.render.metrics import GlyphPrep

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


def phase_kernel(preps) -> dict:
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
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
    for key, gp in (("f32", group), ("degenerate", degenerate_preps())):
        pts, pw, pm = pack_points(gp, dtype=np.float32, arena_tag=key)
        tm = plan_tiles(gp, pm, TP, T_pad=tile_starts(pm, len(gp), TP)[1])[0]
        p_d, pw_d, tm_d = wire_to_device((pts, pw, tm.T), dev)
        cases[key] = (
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d: sdf_cuda.render_bitmaps_cuda_pts(p_d, pw_d, tm_d, TP),
            lambda p_d=p_d, pw_d=pw_d, tm_d=tm_d: sdf_torch.render_tiles_pts(p_d, pw_d, tm_d, TP),
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
        rec = {"phase": "kernel", "case": key, "tiles": int(got.shape[0]),
               "mismatches": mismatches, "max_abs_err": int(err.max()) if err.numel() else 0,
               "nonzero_bytes": int((got > 0).sum())}
        if key != "degenerate":
            rec["glyphs"] = G
            rec["lanes"] = int(sum(p.npts for p in group))
            rec["kernel_ms"] = time_ms(kern, 20)
            rec["plain_ms"] = time_ms(plain, 3)
        emit(rec)
        if mismatches:
            raise AssertionError(f"{key}: kernel and plain version differ on {mismatches} bytes")

    # The tile kernel alone, on the f32 wire: the numbers of the kernels line.
    kern, plain = cases["f32"]
    return {"max_abs_err": max_err, "ms": time_ms(kern, 50), "plain_ms": time_ms(plain, 3)}


def render_font(name, preps, renderer, out_dir):
    """The atlas pipeline below the font parser: blocks of 256
    codepoints through one render session, the fused native PBF
    encode and the directory writer. Returns (seconds, groups)."""
    from versatiles_glyphs_tpu.font.index_files import build_index_json
    from versatiles_glyphs_tpu.proto import native
    from versatiles_glyphs_tpu.writer import Writer

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


def compare_trees(name, got_dir, want_dir):
    """Per-PBF comparison against the exact renderer; returns
    (files, glyphs, pixels, differing pixels, max |Δ|)."""
    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs

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


def debug_rows(name, out_dir):
    """The ``debug`` command's rows (codepoint, width, height, left, top,
    advance, bitmap size) of a rendered fontstack, BMP blocks only."""
    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs

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
    from versatiles_glyphs_tpu.proto import native
    from versatiles_glyphs_tpu_torch.ops import sdf_cuda
    from versatiles_glyphs_tpu_torch.render.driver import Renderer

    if not native.available():
        raise RuntimeError("the native host library did not build (csrc/vg_native.cpp)")
    cuda_r, exact_r, torch_r = Renderer("cuda"), Renderer("exact"), Renderer("torch")
    launches = 0
    for name, preps in font_list:
        got_dir = os.path.join(work, "cuda")
        sdf_cuda.reset_launches()
        secs, groups = render_font(name, preps, cuda_r, got_dir)
        n_launch = sdf_cuda.LAUNCHES
        if not (n_launch > 0 and n_launch == groups):
            raise AssertionError(f"{name}: {n_launch} kernel launches for {groups} groups")
        launches += n_launch
        # The same font again in the same process: the steady state of a
        # run over many fonts (the first render pays one-time costs).
        warm_s, _ = render_font(name, preps, cuda_r, os.path.join(work, "cuda_warm"))

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
              "exact_seconds": exact_s,
              "pixels": n_pix, "pixels_off_by_1": n_diff, "frac_off": frac,
              "max_abs_diff": max_d, "debug_rows": len(rows),
              "torch_cpu_block_bytes_equal": True})
        for sub in ("cuda", "cuda_warm", "exact", "torch"):
            shutil.rmtree(os.path.join(work, sub), ignore_errors=True)
    return launches


def main() -> None:
    # Both checks come before any output: without a card, or outside a
    # checkout of the repo, the script prints no result.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import versatiles_glyphs_tpu_torch.ops.sdf_cuda  # noqa: F401

    phase_device()
    phase_build()
    font_list = fonts()
    k = phase_kernel(font_list[0][1])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        launches = phase_slice(font_list, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"kernels": [{
        "name": "sdf_tiles_pts", "route": "cuda",
        "source": "versatiles_glyphs_tpu_torch/csrc/sdf_tiles_pts.cu",
        "replaces": "versatiles_glyphs_tpu/ops/sdf_pallas.py:61",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
