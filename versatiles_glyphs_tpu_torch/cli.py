"""Command-line interface of the port: recurse / merge / debug.

The same commands and flags as `versatiles_glyphs_tpu.cli`, except
``--renderer {auto,cuda,torch,exact,zeros}``. ``fit`` comes with the
fitting slice. The directory scan and ``debug`` are the JAX package's
own functions. stdout carries the payload (tar stream, debug CSV);
status goes to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys

from versatiles_glyphs_tpu.cli import cmd_debug, scan
from versatiles_glyphs_tpu.utils.output_dir import prepare_output_directory
from versatiles_glyphs_tpu.writer import Writer

from .font.manager import FontManager
from .render.driver import BACKENDS, TRANSPORTS, Renderer


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
        help="SDF backend (default: the CUDA kernel when a GPU is present, "
        "exact f64 elsewhere; torch: the kernel's plain version on the CPU)",
    )
    p.add_argument(
        "--transport",
        choices=TRANSPORTS,
        default="auto",
        help="device point transport: i8 delta wire (default), i16 "
        "fixed point (same bytes as i8), or f32",
    )


def _run_pipeline(args, manager: FontManager, stdout) -> None:
    if args.tar:
        print("Rendering glyphs as tar to stdout.", file=sys.stderr)
        writer = Writer.new_tar(stdout)
    else:
        out_dir = prepare_output_directory(args.output_directory or "output")
        print(f"Rendering glyphs to directory: {out_dir!r}", file=sys.stderr)
        writer = Writer.new_file(os.path.abspath(out_dir))

    renderer = Renderer("zeros" if args.dummy else args.renderer, transport=args.transport)
    manager.render_glyphs(writer, renderer)
    if not args.no_index:
        manager.write_index_json(writer)
    if not args.no_families:
        manager.write_families_json(writer)
    writer.finish()


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
    return parser


def main(argv=None, stdout=None) -> None:
    args = build_parser().parse_args(argv)
    own_stdout = stdout is None
    if own_stdout:
        stdout = sys.stdout.buffer if args.command in ("recurse", "merge") else sys.stdout
    try:
        args.func(args, stdout)
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
