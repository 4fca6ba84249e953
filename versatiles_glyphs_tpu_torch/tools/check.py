"""Lint and compile check of the port (the counterpart of the JAX
package's ``scripts/lint.py`` and ``scripts/check.sh``, over the port's
files).

    python -m versatiles_glyphs_tpu_torch.tools.check

1. lint: this module's own copy of ``scripts/lint.py``'s checks (syntax,
   unused imports, duplicate top-level definitions; ``# noqa`` skips a
   line) over the package, ``tests/test_torch_*.py``, ``chip_smoke.py``
   and ``__graft_entry_torch__.py``;
2. the same files byte-compiled in memory (nothing is written);
3. ``csrc/vg_native.cpp`` built with g++ and the native library's flags
   plus ``-Wall -Wextra``, into a temporary directory (warnings are
   printed, an error fails);
4. every ``csrc/*.cu`` compiled for ``sm_90a`` with the kernels' nvcc
   flags, one nvcc each, all at once, where nvcc is found; elsewhere the
   output says that they were not compiled.

Prints each finding and a summary line a step; exits 1 on any finding.
"""

from __future__ import annotations

import argparse
import ast
import glob
import os
import subprocess
import sys
import tempfile

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def targets() -> list[str]:
    """The port's Python files: the package, its CPU tests, the chip
    smoke and the graft entry."""
    files = []
    for dirpath, dirs, names in os.walk(PKG):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        files += [os.path.join(dirpath, f) for f in sorted(names) if f.endswith(".py")]
    files += sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    files += [os.path.join(ROOT, f) for f in ("chip_smoke.py", "__graft_entry_torch__.py")]
    return [f for f in files if os.path.isfile(f)]


def check_file(path: str) -> list[str]:
    """``scripts/lint.py``'s findings in one file."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    rel = os.path.relpath(path, ROOT)
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]
    noqa = {i + 1 for i, line in enumerate(src.splitlines()) if "# noqa" in line}
    problems: list[str] = []

    # Unused imports: a name is used where any Name node carries it.
    used = {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}
    is_init = rel.endswith("__init__.py")
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)) or node.lineno in noqa or is_init:
            continue
        for alias in node.names:
            if alias.name == "*":
                continue
            name = (alias.asname or alias.name).split(".")[0]
            if name in used:
                continue
            if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                continue
            # Referenced only inside a string (a doctest, say)?
            if f"{name}." in src or f"{name}(" in src or f"[{name}" in src:
                continue
            problems.append(f"{rel}:{node.lineno}: unused import {name!r}")

    # Duplicate top-level definitions.
    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name in seen and node.lineno not in noqa:
                problems.append(f"{rel}:{node.lineno}: duplicate definition of "
                                f"{node.name!r} (first at line {seen[node.name]})")
            seen.setdefault(node.name, node.lineno)
    return problems


def lint(files) -> list[str]:
    return [p for f in files for p in check_file(f)]


def byte_compile(files) -> list[str]:
    problems = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            compile(src, os.path.relpath(path, ROOT), "exec")
        except SyntaxError as e:
            problems.append(f"{os.path.relpath(path, ROOT)}:{e.lineno}: {e.msg}")
    return problems


def build_native(out_dir: str) -> tuple[list[str], str]:
    """(errors, the count of warnings) of the native library built with
    ``-Wall -Wextra``; g++'s output goes to stderr."""
    from ..proto import native

    src = os.path.join(PKG, "csrc", "vg_native.cpp")
    cmd = ["g++", *native._GXX_FLAGS, "-Wall", "-Wextra", "-o",
           os.path.join(out_dir, "vg_native.so"), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stderr + proc.stdout
    if out:
        print(out, end="", file=sys.stderr)
    errors = [f"g++ exited {proc.returncode}: {' '.join(cmd)}"] if proc.returncode else []
    return errors, f"{out.count('warning:')} warning(s)"


def compile_kernels(out_dir: str) -> tuple[list[str], str]:
    """(errors, what was done) of every ``csrc/*.cu`` compiled for
    ``sm_90a`` with the kernels' flags, one nvcc each, all at once; no
    error and a note where nvcc is not found."""
    from ..ops import _build

    sources = sorted(glob.glob(os.path.join(PKG, "csrc", "*.cu")))
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        return [], f"{len(sources)} kernels not compiled: {e}"
    procs = []
    for src in sources:
        so = os.path.join(out_dir, os.path.basename(src)[:-3] + ".so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", so, src]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            errors.append(f"nvcc failed on {os.path.relpath(src, ROOT)} "
                          f"(exit {proc.returncode}):\n{out}")
    return errors, f"{len(sources)} kernels compiled for sm_90a with {nvcc}"


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="versatiles_glyphs_tpu_torch.tools.check",
                            description=__doc__.split("\n\n")[0]).parse_args(argv)
    files = targets()
    found = []
    steps = [("lint", lambda: (lint(files), f"{len(files)} files")),
             ("byte-compile", lambda: (byte_compile(files), f"{len(files)} files"))]
    with tempfile.TemporaryDirectory(prefix="vg_check_") as tmp:
        steps += [("g++ -Wall -Wextra csrc/vg_native.cpp", lambda: build_native(tmp)),
                  ("nvcc csrc/*.cu", lambda: compile_kernels(tmp))]
        for name, step in steps:
            problems, note = step()
            for p in problems:
                print(p)
            print(f"check: {name}: {len(problems)} problem(s); {note}", file=sys.stderr)
            found += problems
    print(f"check: {'FAILED' if found else 'OK'}", file=sys.stderr)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
