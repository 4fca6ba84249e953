"""Run one cell of the benchmark once, on the card.

    python3 glyphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, traced also ``breakdown``, and last ``checks``, each number
compared beside its limit); standard error carries the set-up's phases
and, as its last lines, the same numbers and limits. Exits 2 without a
result where there is no CUDA device (or fewer than the cell asks for),
and 3 where JAX or the JAX package is loaded once the window has
closed. The cells are ``glyphbench/workloads/*.json``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds into ``build/kernels`` and ``build/native`` there
    by itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CHECKOUT, "build", sub)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
        return lines[0] if lines else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, CHECKOUT)
    from glyphbench import harness

    defs = harness.Definitions()
    cell = defs.cell(args.workload)
    chips = int(cell.get("chips", 1))
    _cache_dirs()
    phases: dict = {}
    t = time.perf_counter()
    import torch

    phases["import_torch"] = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"glyphbench: the cell {args.workload!r} needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    phases["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    import versatiles_glyphs_tpu_torch.cli  # noqa: F401  (the program's imports)
    from versatiles_glyphs_tpu_torch.ops import _build
    from versatiles_glyphs_tpu_torch.proto import native

    phases["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    native.available()  # builds the native host library with g++ where it is not built
    phases["native_library"] = time.perf_counter() - t
    try:
        t_start = harness.process_start_time()
    except (OSError, ValueError, StopIteration):
        t_start = time.time() - (time.perf_counter() - T0)
    card = _card()
    workdir = tempfile.mkdtemp(prefix="glyphbench-")
    try:
        result = harness.run_cell(defs, args.workload, args.seed, args.seconds, bool(args.trace),
                                  device, t_start, phases, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"setup_phases_s": phases,
                      "nvcc_s": {k: v[1] for k, v in _build.BUILDS.items()},
                      "native_loaded": native.available(), "native_so": native.library_path(),
                      "card": card}), file=sys.stderr, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"glyphbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
