"""Roofline of the render tile kernel (``csrc/sdf_tiles_pts.cu``) on the
card (counterpart of the JAX package's ``scripts/roofline.py``).

    python -m versatiles_glyphs_tpu_torch.tools.roofline [--font synth_heavy]

With the inputs resident on the device it measures, each printed as a
JSON line:

1. the work of one launch: live (pixel, segment) pairs and f32
   operations by the least count known for the function
   (`tools.work.row_shared_work`), bytes, and the bound at the published
   peaks;
2. the tile kernel alone (CUDA events over many launches): Mpix/s,
   pairs/s, f32 op/s;
3. the measured ALU roof: ``csrc/alu_roof.cu`` on the same grid with as
   many 30-operation steps a thread as a tile has live segments, the
   un-fused roof of the instruction mix the port's kernels are compiled
   to (``--fmad=false``), the tile kernel's share of it, and beside it
   the same recurrence with fused multiply-adds; with ``cuobjdump`` at
   hand, the FMUL/FADD/FMNMX/FFMA instructions the un-fused kernel was
   compiled to;
4. a device-memory copy roof (`torch.Tensor.copy_` of a buffer larger
   than the L2 cache);
5. the prepass costs of the q16 wires: the i16 dequantize and the i8
   decode (`ops.sdf_torch.reconstruct_delta`);
6. upload and fetch rates from pageable host memory (the blocking
   copies of `render.batch.wire_to_device`, as the render session
   uploads), and the fetch into pinned memory on a copy stream, as the
   session fetches (`batch.DeviceLane.fetch_to_host`).

The glyphs are a synthesized font's first render group
(`utils.synth_font.curved_preps`), packed as the session packs them. It
runs on the first CUDA device and raises without one. `main` returns
the measurements as a dictionary.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from ..device import cuda_device
from . import work

TP = 256
REPS = 50  # launches per timing
COPY_BYTES = 256 << 20  # the copy roof's buffer: several times the 50 MB L2 cache
# name -> (glyphs, first codepoint, seed, quads) of `curved_preps`
FONTS = {
    "synth_text": (1700, 32, 0, 8),
    "synth_heavy": (1150, 0x600, 1, 24),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def font_preps(name: str):
    """The non-empty preps of synthesized font ``name``."""
    from ..utils.synth_font import curved_preps

    n, first_cp, seed, quads = FONTS[name]
    return [p for p in curved_preps(n, first_cp, seed=seed, quads=quads) if not p.empty]


def first_group(preps):
    """The glyphs the render session dispatches as its first group."""
    from ..render.driver import Renderer

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


def group_work(group, dtype=np.float32, arena_tag: str = "_tool") -> dict:
    """Pack ``group`` on the point-chain wire and count the tile
    kernel's work: the numpy arrays under ``pts``, ``words``, ``tmeta``
    ([8, T]) and `work.row_shared_work`'s counts, with ``glyphs`` and
    ``npix`` (bitmap pixels, the padding of each glyph's last tile left
    out)."""
    from ..render.batch import pack_points, plan_tiles, tile_starts
    from ..render.metrics import Q16_SCALE

    pts, words, meta = pack_points(group, dtype=dtype, arena_tag=arena_tag)
    T = tile_starts(meta, len(group), TP)[1]
    tmeta = np.ascontiguousarray(plan_tiles(group, meta, TP, T_pad=T)[0].T)
    pixels = pts if pts.dtype == np.float32 else pts.astype(np.float32) / Q16_SCALE
    counts = work.row_shared_work(pixels, tmeta, TP, words)
    return {"pts": pts, "words": words, "tmeta": tmeta, "glyphs": len(group),
            "lanes": int(pts.shape[1]), "npix": int(sum(p.width * p.height for p in group)),
            **counts}


def roof_chunks(w: dict) -> int:
    """Chunks of the ALU roof that give a thread as many 30-operation
    steps as a live tile has live segments on average, over the
    kernel's independent chains."""
    from ..ops.sdf_cuda import ALU_ROOF_CHAINS

    mean_segs = w["pairs"] / max(w["pixels"], 1)
    return max(1, round(mean_segs / ALU_ROOF_CHAINS))


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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card with the host out of the
    way: ``reps`` calls captured once into a CUDA graph (their outputs
    allocated from the graph's pool), replayed once to warm up, then one
    replay timed by CUDA events. Where a launch takes the host longer to
    enqueue than the card to run (kernels of a few tens of microseconds),
    `time_ms` measures the host and this the card. ``fn`` must only
    enqueue work on the current stream (no host sync)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 5) -> float:
    """Best host-clock milliseconds of ``fn()`` followed by a device
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_counts(so_path: str) -> tuple[dict | None, str | None]:
    """(counts, None): the FMUL, FADD, FMNMX and FFMA instructions of
    each kernel in a built library, by ``cuobjdump -sass``; or (None,
    reason) where the tool is missing or fails."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None, "cuobjdump not found"
    proc = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"cuobjdump exited {proc.returncode}: {proc.stderr.strip()[-200:]}"
    out: dict = {}
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(("FMUL", "FADD", "FMNMX", "FFMA"), 0)
            continue
        m = re.search(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9]+)", line)
        if m and name and m.group(1) in out[name]:
            out[name][m.group(1)] += 1
    return out, None


def sass_loops(so_path: str, min_f32: int = 40) -> tuple[dict | None, str | None]:
    """(loops, None): for each kernel of a built library, its loops
    without a barrier that hold at least ``min_f32`` f32 instructions
    (the loops over staged segments), each as ``{"instructions": n,
    "mix": {opcode: count}}`` with modifiers and predicates stripped; a
    loop is the span from a backward branch's target to the branch, by
    ``cuobjdump -sass``. Or (None, reason) as `sass_counts`."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None, "cuobjdump not found"
    proc = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None, f"cuobjdump exited {proc.returncode}: {proc.stderr.strip()[-200:]}"
    code: dict = {}
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.search(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9]+)[^;]*", line)
        if m and name:
            target = re.search(r"\bBRA\b.*?\b0x([0-9a-f]+)", m.group(0))
            code[name].append((int(m.group(1), 16), m.group(2), int(target.group(1), 16) if target else None))
    out: dict = {}
    for name, ins in code.items():
        out[name] = []
        for addr, _, target in ins:
            if target is None or target >= addr:
                continue
            mix: dict = {}
            for a, op, _ in ins:
                if target <= a <= addr:
                    mix[op] = mix.get(op, 0) + 1
            f32 = sum(mix.get(k, 0) for k in ("FMUL", "FADD", "FMNMX", "FFMA"))
            if "BAR" not in mix and f32 >= min_f32:
                out[name].append({"instructions": sum(mix.values()), "mix": mix})
    return out, None


def check_roof_sass(sass: dict, chains: int) -> None:
    """Raise unless the un-fused roof kernel of a `sass_counts` listing
    kept all its work: ten FMUL, FADD and FMNMX for each of ``chains``
    chains, and no FFMA. The compiler merging chains or contracting the
    recurrence would make the measured roof a fraction of what
    `sdf_cuda.alu_roof_ops` counts."""
    unfused = [c for k, c in sass.items() if "alu_roof_kernel" in k and "Lb0" in k]
    if len(unfused) != 1:
        raise AssertionError(f"alu_roof: no un-fused kernel among {sorted(sass)}")
    c = unfused[0]
    if c["FFMA"] or min(c["FMUL"], c["FADD"], c["FMNMX"]) < 10 * chains:
        raise AssertionError(f"alu_roof: the un-fused kernel was compiled to {c}, "
                             f"want no FFMA and at least {10 * chains} of each other")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.roofline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--font", choices=sorted(FONTS), default="synth_text")
    args = ap.parse_args(argv)

    dev = cuda_device()
    from ..ops import _build, sdf_cuda, sdf_torch
    from ..render.batch import DeviceLane, pack_points_delta, wire_to_device

    res: dict = {"font": args.font, "device": torch.cuda.get_device_name(dev),
                 "nvidia_smi": nvidia_smi_line()}
    emit({"tool": "roofline", "step": "device", **res})

    group = first_group(font_preps(args.font))
    w = group_work(group)
    host = (w.pop("pts"), w.pop("words"), w.pop("tmeta"))
    bound_ms, bound_by = work.bound(w["f32_ops"], w["bytes"])
    w.update(f32_ops_a_pair=w["f32_ops"] / max(w["pairs"], 1), bound_ms=bound_ms, bound_by=bound_by,
             bound_ms_at_22_ops_a_pair=work.bound(w["f32_ops_per_pair_test"], w["bytes"])[0])
    emit({"tool": "roofline", "step": "work", **w})
    res["work"] = w

    # Upload and fetch: pageable blocking copies, then the session's
    # fetch into pinned memory on its fetch stream.
    nbytes = sum(a.nbytes for a in host)
    up_ms = host_ms(lambda: wire_to_device(host, dev))
    pts, words, tmeta = wire_to_device(host, dev)
    out = sdf_cuda.render_bitmaps_cuda_pts(pts, words, tmeta, TP)
    fetch_ms = host_ms(lambda: out.cpu())
    lane = DeviceLane(dev)
    torch.cuda.synchronize()
    pin_fetch_ms = host_ms(lambda: lane.fetch_to_host(out, None)[1].synchronize())
    res["transfer"] = {"upload_bytes": nbytes, "upload_ms": up_ms,
                       "upload_GBps": nbytes / up_ms / 1e6,
                       "fetch_bytes": out.numel(), "fetch_ms": fetch_ms,
                       "fetch_GBps": out.numel() / fetch_ms / 1e6,
                       "pinned_fetch_ms": pin_fetch_ms,
                       "pinned_fetch_GBps": out.numel() / pin_fetch_ms / 1e6}
    emit({"tool": "roofline", "step": "transfer", "wire": "f32", **res["transfer"]})

    # The tile kernel alone.
    k_ms = time_ms(lambda: sdf_cuda.launch_tiles_pts(pts, words, tmeta, TP), REPS)
    k_ops = w["f32_ops"] / (k_ms * 1e-3)
    res["kernel"] = {"ms": k_ms, "Mpix_per_s": w["npix"] / k_ms / 1e3,
                     "pairs_per_s": w["pairs"] / (k_ms * 1e-3), "f32_Tops_per_s": k_ops / 1e12,
                     "share_of_bound": bound_ms / k_ms}
    emit({"tool": "roofline", "step": "kernel", "kernel": "sdf_tiles_pts", **res["kernel"]})

    # The measured ALU roof on the same grid.
    T, n_chunk = w["tiles"], roof_chunks(w)
    got = sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev)
    want = sdf_torch.alu_roof(T, TP, n_chunk, dev)
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if differ:
        raise AssertionError(f"alu_roof: {differ} values differ from the plain version")
    roof_ops = sdf_cuda.alu_roof_ops(T, TP, n_chunk)
    r_ms = time_ms(lambda: sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev), REPS)
    f_ms = time_ms(lambda: sdf_cuda.alu_roof_cuda(T, TP, n_chunk, dev, fused=True), REPS)
    roof_rate = roof_ops / (r_ms * 1e-3)
    sass, sass_missing = sass_counts(_build.BUILDS["alu_roof"][0])
    if sass is not None:
        check_roof_sass(sass, sdf_cuda.ALU_ROOF_CHAINS)
    res["alu_roof"] = {
        "tiles": T, "n_chunk": n_chunk, "chains": sdf_cuda.ALU_ROOF_CHAINS,
        "executed_f32_ops": roof_ops, "bits_differ_from_plain": differ,
        "ms": r_ms, "f32_Tops_per_s": roof_rate / 1e12,
        "share_of_published_peak": roof_rate / work.PEAK_F32_OPS_PER_S,
        "fused_ms": f_ms, "fused_f32_Tops_per_s": roof_ops / (f_ms * 1e-3) / 1e12,
        "kernel_share_of_roof": k_ops / roof_rate, "sass": sass,
        "sass_missing": sass_missing,
    }
    emit({"tool": "roofline", "step": "alu_roof", **res["alu_roof"]})

    # The device-memory copy roof: read and write, larger than the L2.
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    c_ms = time_ms(lambda: dst.copy_(src), 20)
    res["copy"] = {"buffer_bytes": src.numel(), "ms": c_ms,
                   "GBps_read_plus_write": 2 * src.numel() / c_ms / 1e6,
                   "kernel_bytes": w["bytes"], "kernel_GBps": w["bytes"] / k_ms / 1e6}
    emit({"tool": "roofline", "step": "copy_roof", **res["copy"]})
    del src, dst

    # Prepass of the q16 wires on this group.
    if all(p.q16_ok for p in group):
        w16 = group_work(group, dtype=np.int16, arena_tag="_tool16")
        p16 = torch.from_numpy(w16["pts"]).to(dev, copy=True)
        dq_ms = time_ms(lambda: sdf_torch.dequantize(p16), REPS)
        d8, a8 = wire_to_device(pack_points_delta(group, arena_tag="_tool8")[0:3:2], dev)
        rc_ms = time_ms(lambda: sdf_torch.reconstruct_delta(d8, a8), REPS)
        n_live = sum(p.npts for p in group)  # lanes past the glyphs' runs are stale
        same = bool(torch.equal(
            sdf_torch.reconstruct_delta(d8, a8)[:, :n_live].to(torch.int16), p16[:, :n_live]))
        res["prepass"] = {"dequantize_ms": dq_ms, "i8_decode_ms": rc_ms,
                          "anchors": int(a8.shape[1]), "i8_decodes_to_i16": same}
        emit({"tool": "roofline", "step": "prepass", **res["prepass"]})
    return res


if __name__ == "__main__":
    main()
