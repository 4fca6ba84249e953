"""The plain reference: what it imports, its decoders against the port's
writers, and its fit step against the port's on the CPU."""

import ast
import glob
import io
import os

import numpy as np
import pytest

from glyphbench.reference import decode

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("sub", ["reference", "frozen"])
def test_the_yardstick_imports_nothing_of_the_program_or_jax(sub):
    for path in glob.glob(os.path.join(BENCH, sub, "*.py")):
        found = _imports(path) & {"jax", "jaxlib", "flax", "versatiles_glyphs_tpu",
                                  "versatiles_glyphs_tpu_torch"}
        assert not found, (path, found)


def test_nothing_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "versatiles_glyphs_tpu"}, path


def test_tar_reader_reads_the_ports_tar():
    from versatiles_glyphs_tpu_torch.writer.tar import TarWriter

    buf = io.BytesIO()
    w = TarWriter(buf)
    w.write_directory("a/")
    w.write_file("a/0-255.pbf", b"x" * 700)
    w.write_file("index.json", b"[]")
    w.finish()
    assert decode.read_tar(buf.getvalue()) == {"a/0-255.pbf": b"x" * 700, "index.json": b"[]"}
    bad = bytearray(buf.getvalue())
    bad[10] ^= 1
    with pytest.raises(ValueError):
        decode.read_tar(bytes(bad))


def test_pbf_reader_reads_the_ports_encoding():
    from versatiles_glyphs_tpu_torch.proto.pbf import PbfGlyph, encode_glyphs

    glyphs = [PbfGlyph(id=65, bitmap=bytes(range(20)), width=2, height=4, left=-3, top=-17,
                       advance=12), PbfGlyph.empty(32, 6)]
    stacks = decode.read_pbf(encode_glyphs("some_font", "0-255", glyphs))
    assert stacks == [("some_font", "0-255", [(65, 2, 4, -3, -17, 12, bytes(range(20))),
                                              (32, 0, 0, 0, 0, 6, None)])]


def test_reference_fit_follows_the_ports_step_on_the_cpu():
    from versatiles_glyphs_tpu_torch.font.entry import FontFileEntry
    from versatiles_glyphs_tpu_torch.models.fitting import PARAM_KEYS, FontFitter, make_fit_batch

    from glyphbench.frozen import synth_font
    from glyphbench.reference import fit as rf

    n, cps = 12, list(range(65, 77))
    reg = FontFileEntry(synth_font.build_ttf(cps, seed=5))
    bold = FontFileEntry(synth_font.build_ttf(cps, seed=6))
    batch = make_fit_batch(reg, cps, depth=3, target_entry=bold)
    fitter = FontFitter(depth=3, learning_rate=0.01, backend="flat", device="cpu")
    params, opt, db = fitter.init(batch)
    losses = [float(fitter.step_many(params, opt, db, 1)[2][0]) for _ in range(3)]
    ref = rf.run_steps(rf.build_batch(5, 6, n, 8, "cpu"), 3, 3, 0.01, "cpu")
    assert abs(losses[0] - ref["losses"][0]) <= 1e-6 * ref["losses"][0]
    assert np.max(np.abs(np.asarray(losses) - ref["losses"]) / ref["losses"]) < 1e-3
    assert sorted(ref["grad1"]) == sorted(PARAM_KEYS)


def test_leaf_gap_leaves_out_leaves_that_do_not_move():
    from glyphbench.reference import fit as rf

    ref = {"curves": np.ones(4), "translate": np.ones(4) * 2, "log_gain": np.array(1e-9)}
    prog = {"curves": np.ones(4) * 1.1, "translate": np.ones(4) * 2, "log_gain": np.array(5.0)}
    gap, skipped = rf.worst_leaf_gap(prog, ref)
    assert skipped == ["log_gain"]
    assert gap == pytest.approx(0.1)  # |2.2 - 2| over the median leaf's norm, 2
