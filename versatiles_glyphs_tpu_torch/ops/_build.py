"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout, where the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale library is never loaded. A
failed build raises with nvcc's output. `build_all` runs one nvcc per
kernel, all at once. ptxas reports each kernel's registers, spills and
shared memory (``-Xptxas -v``); the report is kept beside the library
(`ptxas_report`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# --fmad=false keeps every multiply and add separately rounded, which
# the byte parity with the plain PyTorch versions needs.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> (library path, seconds spent in nvcc; 0.0 when it was cached)
BUILDS: dict[str, tuple[str, float]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
        )
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` lives for its current
    source, headers and flags."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))
    for path in [os.path.join(SRC_DIR, f"{name}.cu"), *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the
    library path."""
    so = library_path(name)
    if os.path.exists(so):
        BUILDS.setdefault(name, (so, 0.0))
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    with trace.span("ops.build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    with open(so + ".ptxas.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, so)
    BUILDS[name] = (so, time.perf_counter() - t0)
    return so


def ptxas_report(so: str) -> list[dict]:
    """What ptxas said of each kernel in library ``so`` when it was
    built: ``{"kernel", "registers", "spill_stores", "spill_loads",
    "smem"}`` (bytes; mangled kernel names)."""
    with open(so + ".ptxas.txt") as f:
        text = f.read()
    rows = []
    for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", text, re.S,
    ):
        rows.append({"kernel": m[1], "registers": int(m[4]), "spill_stores": int(m[2]),
                     "spill_loads": int(m[3]), "smem": int(m[5] or 0)})
    return rows


def build_all(names) -> list[str]:
    """`build` every kernel of ``names`` with one nvcc each, all running
    at once; returns their library paths."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
        return lib
