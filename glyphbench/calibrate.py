"""Readings that a cell's limits are set from, many seeds in one
process, on the card:

    python3 glyphbench/calibrate.py --workload <cell> --seeds 11,12,... [--control 3] [--faults 3]

For each seed, the cell's set-up (its fonts, its warm-up request or
first steps) and the comparison of what that produced with the plain
reference: the sound readings, whose largest is a limit's lower end.
``--control N``: on the first N seeds, the reference itself in the
precision below the configuration's stated one, put in the program's
place (a render in bfloat16; the fit in float32 with a TF32 Bernstein
product), read by the same numbers: the upper end. ``--faults N``: on
the first N seeds, the faults the cell can have, planted (a render: half
of each block's glyphs left out, one bitmap altered where it is
produced; the fit, in the reference put in the program's place: half of
the batch left out, the mean over the rest; the parameters left
unchanged; and a call of ``steps_per_call`` steps that takes one). One JSON line a reading on standard output. Not run by
`run.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from glyphbench import harness  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def render_control(drv) -> dict:
    import torch

    exp = drv.expected()
    ref, _ = exp.render(drv.ctx.device)
    low, _ = exp.render(drv.ctx.device, dtype=torch.bfloat16)
    d = np.abs(low.astype(np.int16) - ref.astype(np.int16))
    return {"max_abs_byte_diff": int(d.max()), "pct_pixels_off": 100.0 * np.count_nonzero(d) / d.size}


def render_fault(drv, kind: str) -> dict:
    """One request with a fault planted in the program's encode, and
    its numbers."""
    from versatiles_glyphs_tpu_torch.proto import native

    orig = native.encode_block_from_preps

    def drop_half(name, rng, preps, bm_iter):
        h = len(preps) // 2
        data = orig(name, rng, preps[:h], bm_iter)
        for p in preps[h:]:
            if not p.empty:
                next(bm_iter)
        return data

    def alter(name, rng, preps, bm_iter):
        first = [True]

        def it():
            for b in bm_iter:
                if first[0]:
                    b = np.array(b, copy=True)
                    b[len(b) // 2] ^= 0x80
                    first[0] = False
                yield b

        return orig(name, rng, preps, it())

    native.encode_block_from_preps = {"drop_half": drop_half, "alter_bitmap": alter}[kind]
    try:
        drv.run_request()
    finally:
        native.encode_block_from_preps = orig
    files = drv.read_output()
    exp = drv.expected()
    ref, starts = exp.render(drv.ctx.device)
    return drv.compare(files, exp, ref, starts)


def fit_readings(ref, prog) -> dict:
    from glyphbench.reference import fit as rf

    got = rf.readings(prog, ref)
    del got["skipped"]
    return got


def fit_other(drv, steps: int, **kw) -> dict:
    """The reference's first ``steps`` steps run another way, as the
    program's readings (``prog`` of `fit_readings`), the losses padded
    with the last to the set-up's 1 + ``steps_per_call``."""
    from glyphbench.reference import fit as rf

    b = drv.reference_batch()
    r = rf.run_steps(b, steps, drv.depth, drv.lr, drv.ctx.device, **kw)
    losses = np.concatenate([r["losses"], np.repeat(r["losses"][-1:], 1 + drv.k - steps)])
    return {"losses": losses, "grad1": r["grad1"],
            "delta": {k: r["params"][k] - r["params0"][k] for k in rf.LEAVES}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--defs", default=BENCH_DIR, help="where the cells are defined (a test's)")
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at a test's size")
    args = p.parse_args(argv)
    import torch

    from glyphbench.reference import fit as rf

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    defs = harness.Definitions(args.defs)
    cell = defs.cell(args.workload)
    config = defs.config(cell["config"])
    mod = defs.driver(cell["traffic"])
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="glyphbench-cal-")
        try:
            ctx = harness.Context(cell, config, seed, work, device, harness.Spans(), {})
            drv = mod.Driver(ctx)
            t = time.perf_counter()
            drv.setup()
            setup = time.perf_counter() - t
            if cell["traffic"] == "fit_steps":
                prog = drv.first
                drv.release()
                steps = 1 + drv.k
                t = time.perf_counter()
                ref = rf.run_steps(drv.reference_batch(), steps, drv.depth, drv.lr, device)
                emit({"seed": seed, "kind": "sound", "setup_s": setup,
                      "reference_s": time.perf_counter() - t, **fit_readings(ref, prog)})
                if n < args.control:
                    emit({"seed": seed, "kind": "control",
                          **fit_readings(ref, fit_other(drv, steps, control=True))})
                if n < args.faults:
                    B = len(drv.reference_batch().ncurves)
                    emit({"seed": seed, "kind": "fault_half_batch",
                          **fit_readings(ref, fit_other(drv, steps, keep=B // 2))})
                    # The call of steps_per_call steps takes one: two steps in all.
                    emit({"seed": seed, "kind": "fault_call_takes_one_step",
                          **fit_readings(ref, fit_other(drv, 2))})
                    # No step taken: Adam holds no gradient, the parameters stay.
                    still = {"losses": np.repeat(ref["losses"][:1], steps),
                             "grad1": {k: np.zeros_like(v) for k, v in ref["grad1"].items()},
                             "delta": {k: np.zeros_like(v) for k, v in ref["params0"].items()}}
                    emit({"seed": seed, "kind": "fault_unchanged_state", **fit_readings(ref, still)})
            else:
                nums = {k: v["value"] for k, v in drv.check([]).items()}
                emit({"seed": seed, "kind": "sound", "setup_s": setup, **nums})
                if n < args.control:
                    emit({"seed": seed, "kind": "control", **render_control(drv)})
                if n < args.faults:
                    for kind in ("drop_half", "alter_bitmap"):
                        emit({"seed": seed, "kind": f"fault_{kind}", **render_fault(drv, kind)})
            drv.release()
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
