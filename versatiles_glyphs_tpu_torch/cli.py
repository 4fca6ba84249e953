"""Command-line interface of the port: recurse / merge / debug / fit.

The same commands and flags as `versatiles_glyphs_tpu.cli`, except
``--renderer {auto,cuda,torch,padded,exact,zeros}`` (``padded`` is the
JAX ``jax``: the padded-layout render, on ``--device``) and, for
``fit``, ``--backend {torch,flat}`` (the JAX ``jnp``/``pallas``) and
``--device`` (default: the first CUDA device; the CPU only by name).
``recurse|merge --device`` is the ``padded`` renderer's device and is
refused with the other renderers, whose devices are fixed;
``fit --render --render-backend padded`` renders on the fit's
``--device``.
``fit --mesh N`` shards the batch over the first N devices of
``--device``'s kind (`parallel.mesh.local_devices`; on the CPU, N
stand-ins of the one CPU device). ``--renderer auto`` (the default) is the card and raises
without one; ``torch``, ``exact`` and ``zeros`` run on the CPU by name.
stdout carries the payload (tar stream, debug CSV); status goes to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from .font.manager import FontManager
from .proto.pbf import decode_glyphs
from .render.driver import BACKENDS, TRANSPORTS, Renderer
from .utils import trace
from .utils.output_dir import prepare_output_directory
from .writer import Writer


def _add_output_flags(p: argparse.ArgumentParser) -> None:
    group = p.add_mutually_exclusive_group()
    group.add_argument("-o", "--output-directory", default=None)
    group.add_argument("-t", "--tar", action="store_true")
    p.add_argument("--no-families", action="store_true")
    p.add_argument("--no-index", action="store_true")
    p.add_argument("--dummy", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--single-thread", action="store_true", help=argparse.SUPPRESS)
    p.add_argument(
        "--renderer",
        choices=BACKENDS,
        default="auto",
        help="SDF backend (default: the CUDA kernel, which needs a GPU; on the "
        "CPU by name: torch, the kernel's plain version, or exact, f64; padded: "
        "the JAX package's 'jax' renderer, the padded-layout render, on --device)",
    )
    p.add_argument(
        "--device",
        default=None,
        help="torch device of --renderer padded (default: the first CUDA "
        "device; 'cpu' by name); the other renderers' devices are fixed",
    )
    p.add_argument(
        "--transport",
        choices=TRANSPORTS,
        default="auto",
        help="device point transport: i8 delta wire (default), i16 "
        "fixed point (same bytes as i8), or f32",
    )
    _add_trace_flag(p)


def _add_trace_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--trace",
        default=None,
        metavar="FILE",
        help="run under torch.profiler and write its Chrome trace to FILE: the "
        "port's spans beside the kernels and copies, on one clock",
    )


def _request(args, stdout) -> None:
    with trace.span("cli.request"):
        args.func(args, stdout)


def _run_traced(args, stdout, path: str) -> None:
    """`_request` under `torch.profiler` (CPU activity, and CUDA where a
    card is present), its Chrome trace written to ``path``. The port's
    spans of every thread are added from `utils.trace`, placed by the
    clock of a marker range; the main thread's on the marker's row."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    main_thread = threading.get_ident()
    with profile(activities=activities) as prof:
        with record_function("vg.trace.mark"):
            mark = time.perf_counter()
        _request(args, stdout)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marker = next(e for e in events if e.get("name") == "vg.trace.mark")
    for r in trace.records():
        if r.start >= mark:
            tid = marker["tid"] if r.thread == main_thread else r.thread
            events.append({"ph": "X", "cat": "user_annotation", "name": r.name,
                           "pid": marker["pid"], "tid": tid,
                           "ts": marker["ts"] + (r.start - mark) * 1e6,
                           "dur": (r.end - r.start) * 1e6})
    with open(path, "w") as f:
        json.dump(doc, f)


def _run_pipeline(args, manager: FontManager, stdout) -> None:
    if args.tar:
        print("Rendering glyphs as tar to stdout.", file=sys.stderr)
        writer = Writer.new_tar(stdout)
    else:
        out_dir = prepare_output_directory(args.output_directory or "output")
        print(f"Rendering glyphs to directory: {out_dir!r}", file=sys.stderr)
        writer = Writer.new_file(os.path.abspath(out_dir))

    renderer = Renderer("zeros" if args.dummy else args.renderer, transport=args.transport,
                        device=args.device)
    manager.render_glyphs(writer, renderer)
    if not args.no_index:
        manager.write_index_json(writer)
    if not args.no_families:
        manager.write_families_json(writer)
    writer.finish()


def scan(path: str, manager: FontManager) -> None:
    """Recursive scan (`recurse.rs:104-133`): font files are added
    directly; a dir with fonts.json is configured by it (no recursion
    past it); other dirs recurse."""
    if os.path.isfile(path):
        ext = os.path.splitext(path)[1].lower().lstrip(".")
        if ext in ("ttf", "otf"):
            manager.add_path(path)
    elif os.path.isdir(path):
        fonts_json = os.path.join(path, "fonts.json")
        if os.path.exists(fonts_json):
            with open(fonts_json, "rb") as f:
                configs = json.load(f)
            for c in configs:
                manager.add_font_with_name(
                    c["name"], [os.path.join(path, src) for src in c["sources"]]
                )
        else:
            for entry in sorted(os.listdir(path)):
                scan(os.path.join(path, entry), manager)


def cmd_recurse(args, stdout) -> None:
    manager = FontManager(parallel=not args.single_thread)
    for d in args.input_directories:
        canonical = os.path.realpath(os.path.abspath(d))
        print(f"Scanning directory: {canonical!r}", file=sys.stderr)
        scan(canonical, manager)
    _run_pipeline(args, manager, stdout)


def cmd_merge(args, stdout) -> None:
    manager = FontManager(parallel=not args.single_thread)
    manager.add_paths([os.path.realpath(os.path.abspath(p)) for p in args.input_files])
    _run_pipeline(args, manager, stdout)


def cmd_debug(args, stdout) -> None:
    d = args.glyph_directory
    if not os.path.exists(d):
        raise SystemExit(f"Directory does not exist: {d!r}")
    sep = "," if args.format == "csv" else "\t"
    out = stdout
    out.write(
        sep.join(
            ["codepoint", "width", "height", "left", "top", "advance", "bitmap_size"]
        )
        + "\n"
    )
    # BMP only: blocks 0..256 (`debug.rs:66-69`).
    for i in range(256):
        start = i * 256
        path = os.path.join(d, f"{start}-{start + 255}.pbf")
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            continue
        try:
            glyphs = decode_glyphs(buf)
        except (ValueError, IndexError) as e:
            raise SystemExit(f"Failed to decode {path!r}: {e}")
        glyphs.sort(key=lambda g: g.id)
        for g in glyphs:
            out.write(
                sep.join(
                    str(v)
                    for v in [
                        g.id,
                        g.width,
                        g.height,
                        g.left,
                        g.top,
                        g.advance,
                        len(g.bitmap) if g.bitmap is not None else 0,
                    ]
                )
                + "\n"
            )


def _parse_codepoints(spec: str) -> list[int]:
    """``"65-90,97,0x100-0x17F"`` → sorted codepoint list."""
    out: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo, 0), int(hi, 0) + 1))
        else:
            out.add(int(part, 0))
    return sorted(out)


def cmd_fit(args, stdout) -> None:
    """Fit a font's outlines to another font's SDF bitmaps by gradient
    descent on control points. Writes ``fitted.npz`` (the JAX CLI's keys
    and row mapping), ``checkpoint`` (`FontFitter.save_checkpoint`) and
    ``history.json``; ``--render`` adds the fitted atlas under
    ``glyphs/``."""
    import numpy as np
    import torch

    from .font.entry import FontFileEntry
    from .models.fitting import FontFitter, make_fit_batch
    from .parallel.mesh import local_devices

    with open(args.font, "rb") as f:
        entry = FontFileEntry(f.read())
    target_entry = entry
    if args.target_font:
        with open(args.target_font, "rb") as f:
            target_entry = FontFileEntry(f.read())

    devices = local_devices(args.mesh, torch.device(args.device).type) if args.mesh else None
    fitter = FontFitter(
        depth=args.depth, learning_rate=args.lr, sharpness=args.sharpness,
        backend=args.backend, device=None if devices else args.device, devices=devices,
    )
    batch = make_fit_batch(entry, _parse_codepoints(args.codepoints), depth=args.depth,
                           target_entry=target_entry)
    where = f"{len(devices)} devices ({devices[0]})" if devices else str(fitter.device)
    print(
        f"Fitting {batch.curves0.shape[0]} glyphs ({batch.curves0.shape[1]} curves max, "
        f"depth {args.depth}) for {args.steps} steps on {where}",
        file=sys.stderr,
    )
    params, opt, dev_batch = fitter.init(batch)
    if args.resume:
        params, opt = FontFitter.restore_checkpoint(args.resume, like=(params, opt))
        print(f"Resumed from checkpoint {args.resume!r}", file=sys.stderr)

    # The losses come back to the host once per chunk of steps.
    log_every = max(1, args.steps // 20)
    chunk = min(FontFitter.CHUNK, log_every)
    history = []
    done = 0
    while done < args.steps:
        k = min(chunk, args.steps - done)
        params, opt, losses = fitter.step_many(params, opt, dev_batch, k)
        for j in range(k):
            i = done + j
            if i % log_every == 0 or i == args.steps - 1:
                history.append((i, float(losses[j])))
                print(f"step {i}: loss {float(losses[j]):.6f}", file=sys.stderr)
        done += k

    out = os.path.abspath(args.output)
    os.makedirs(out, exist_ok=True)
    # A sharded fit pads the batch to a multiple of the device count:
    # the real rows come first, and only they are kept.
    B_real = batch.curves0.shape[0]
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    host["curves"], host["translate"] = host["curves"][:B_real], host["translate"][:B_real]
    np.savez(
        os.path.join(out, "fitted.npz"),
        curves=host["curves"],
        translate=host["translate"],
        log_gain=host["log_gain"],
        curve_mask=batch.curve_mask,
        # The FITTED codepoints: rows map to these, not to the request.
        codepoints=np.asarray(batch.codepoints),
    )
    FontFitter.save_checkpoint(os.path.join(out, "checkpoint"), params, opt)
    with open(os.path.join(out, "history.json"), "w") as f:
        json.dump([{"step": s, "loss": v} for s, v in history], f, indent=2)
    print(f"Wrote fitted parameters to {out!r}", file=sys.stderr)

    if args.render:
        from .font.names import name_to_id
        from .models.render_fitted import render_fitted_pbfs

        glyph_dir = os.path.join(out, "glyphs")
        written = render_fitted_pbfs(
            host, batch, entry, args.depth, glyph_dir,
            name_to_id(entry.metadata.generate_name()),
            renderer=Renderer(args.render_backend,
                              device=args.device if args.render_backend == "padded" else None),
        )
        print(f"Rendered {len(written)} fitted glyph block(s) to {glyph_dir!r}", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="versatiles_glyphs_tpu_torch",
        description="SDF glyph atlas generator on PyTorch and CUDA "
        "(maplibre/mapbox PBF glyphs from TrueType/OpenType fonts)",
    )
    parser.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("recurse", help="recursively scan directories for fonts")
    p.add_argument("input_directories", nargs="+")
    _add_output_flags(p)
    p.set_defaults(func=cmd_recurse)

    p = sub.add_parser("merge", help="merge font files into one glyph set")
    p.add_argument("input_files", nargs="+")
    _add_output_flags(p)
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("debug", help="print glyph metrics of a rendered directory")
    p.add_argument("glyph_directory")
    p.add_argument("--format", "-f", choices=("csv", "tsv"), default="csv")
    p.set_defaults(func=cmd_debug)

    p = sub.add_parser("fit", help="fit outlines to target SDFs by gradient descent")
    p.add_argument("font", help="font whose outlines are optimized")
    p.add_argument("--target-font", default=None,
                   help="font providing target SDF bitmaps (default: self)")
    p.add_argument("--codepoints", default="65-90", help="e.g. '65-90,97,0x100-0x17F'")
    p.add_argument("-o", "--output", default="fit_output")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--depth", type=int, default=3, help="fixed Bezier subdivision depth")
    p.add_argument("--sharpness", type=float, default=None,
                   help="softmin sharpness (default: hard min; torch backend only)")
    p.add_argument("--backend", choices=("torch", "flat"), default="torch",
                   help="gradient backend: autograd of the pair-tensor model, or "
                   "the flat min-field kernel pair (hard min only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the first CUDA device; 'cpu' runs "
                   "the kernels' plain versions)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the batch over this many devices of --device's kind")
    p.add_argument("--render", action="store_true",
                   help="after fitting, render the fitted outlines into "
                   "{output}/glyphs/ (readable by `debug`)")
    p.add_argument("--resume", default=None, metavar="CHECKPOINT",
                   help="resume from a previous run's {output}/checkpoint file")
    p.add_argument("--render-backend", choices=BACKENDS, default="auto",
                   help=argparse.SUPPRESS)
    _add_trace_flag(p)
    p.set_defaults(func=cmd_fit)
    return parser


def main(argv=None, stdout=None) -> None:
    args = build_parser().parse_args(argv)
    own_stdout = stdout is None
    if own_stdout:
        stdout = sys.stdout.buffer if args.command in ("recurse", "merge") else sys.stdout
    try:
        if getattr(args, "trace", None):
            _run_traced(args, stdout, args.trace)
        else:
            _request(args, stdout)
    except BrokenPipeError:
        # Downstream pipe closed early (`debug ... | head`): exit quietly.
        if not own_stdout:
            raise
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        os._exit(0)
    except (ValueError, OSError) as e:
        # One-line errors for bad font bytes, unreadable files and the like.
        if not own_stdout:
            raise
        raise SystemExit(f"error: {e}")


if __name__ == "__main__":
    main()
