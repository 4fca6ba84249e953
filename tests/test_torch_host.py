"""The port's host modules against the JAX package's, on the CPU.

`versatiles_glyphs_tpu_torch` keeps its own copy of every host module
it uses (f64 metrics and q16 chains, PBF and tar encoders, the native
C++ runtime, the font parser, the exact renderer, the writers). Each
case sends the same inputs, made from a seed with numpy or synthesized
as a font file, through the JAX package's function and the port's.
Tolerance: none. These are integer, byte and f64 op-order contracts, so
every output is compared exactly.
"""

import io
import json
import os
import tarfile
import types

import numpy as np
import pytest

import versatiles_glyphs_tpu as jx_pkg
import versatiles_glyphs_tpu.cli as jx_cli
import versatiles_glyphs_tpu.constants as jx_constants
import versatiles_glyphs_tpu.font.block as jx_block
import versatiles_glyphs_tpu.font.entry as jx_entry
import versatiles_glyphs_tpu.font.index_files as jx_index
import versatiles_glyphs_tpu.font.manager as jx_manager
import versatiles_glyphs_tpu.font.names as jx_names
import versatiles_glyphs_tpu.font.wrapper as jx_wrapper
import versatiles_glyphs_tpu.models.render_fitted as jx_fitted
import versatiles_glyphs_tpu.ops.flatten as jx_flatten
import versatiles_glyphs_tpu.ops.geometry as jx_geometry
import versatiles_glyphs_tpu.ops.sdf_ref as jx_ref
import versatiles_glyphs_tpu.parallel.mesh as jx_mesh
import versatiles_glyphs_tpu.proto.native as jx_native
import versatiles_glyphs_tpu.proto.pbf as jx_pbf
import versatiles_glyphs_tpu.render.driver as jx_driver
import versatiles_glyphs_tpu.render.metrics as jx_metrics
import versatiles_glyphs_tpu.utils.arena as jx_arena
import versatiles_glyphs_tpu.utils.bitmap_art as jx_art
import versatiles_glyphs_tpu.utils.output_dir as jx_output_dir
import versatiles_glyphs_tpu.utils.progress as jx_progress
import versatiles_glyphs_tpu.writer as jx_writer
import versatiles_glyphs_tpu.writer.tar as jx_tar
import versatiles_glyphs_tpu_torch as pt_pkg
import versatiles_glyphs_tpu_torch.cli as pt_cli
import versatiles_glyphs_tpu_torch.constants as pt_constants
import versatiles_glyphs_tpu_torch.font.block as pt_block
import versatiles_glyphs_tpu_torch.font.entry as pt_entry
import versatiles_glyphs_tpu_torch.font.index_files as pt_index
import versatiles_glyphs_tpu_torch.font.manager as pt_manager
import versatiles_glyphs_tpu_torch.font.names as pt_names
import versatiles_glyphs_tpu_torch.font.wrapper as pt_wrapper
import versatiles_glyphs_tpu_torch.models.render_fitted as pt_fitted
import versatiles_glyphs_tpu_torch.ops.flatten as pt_flatten
import versatiles_glyphs_tpu_torch.ops.geometry as pt_geometry
import versatiles_glyphs_tpu_torch.ops.sdf_ref as pt_ref
import versatiles_glyphs_tpu_torch.parallel.mesh as pt_mesh
import versatiles_glyphs_tpu_torch.proto.native as pt_native
import versatiles_glyphs_tpu_torch.proto.pbf as pt_pbf
import versatiles_glyphs_tpu_torch.render.driver as pt_driver
import versatiles_glyphs_tpu_torch.render.metrics as pt_metrics
import versatiles_glyphs_tpu_torch.utils.arena as pt_arena
import versatiles_glyphs_tpu_torch.utils.bitmap_art as pt_art
import versatiles_glyphs_tpu_torch.utils.output_dir as pt_output_dir
import versatiles_glyphs_tpu_torch.utils.progress as pt_progress
import versatiles_glyphs_tpu_torch.writer as pt_writer
import versatiles_glyphs_tpu_torch.writer.tar as pt_tar
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf, build_ttf_split_cmap
from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved

FONTS = {
    "ttf": lambda: build_ttf(24),
    "otf": lambda: build_otf(24),
    "split_cmap": lambda: build_ttf_split_cmap()[0],
    "curved": lambda: build_ttf_curved(20, 0xF0, seed=3),
}

PREP_FIELDS = ("codepoint", "advance", "dx", "empty", "width", "height", "x0", "y0", "x1", "y1",
               "npts", "q16_ok", "ntiles256", "pbf_width", "pbf_height", "pbf_left", "pbf_top")
PREP_ARRAYS = ("segments", "chain32", "chain16", "valid8")


def _same(a, b, what=""):
    """Exact equality of two nested results (arrays by dtype, shape and
    bits; floats by bits, so -0.0 and NaN count)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes(), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _same_prep(a, b):
    for f in PREP_FIELDS:
        _same(getattr(a, f), getattr(b, f), f)
    if a.empty:
        return
    _same(list(a.rings_px), list(b.rings_px), "rings_px")
    for f in PREP_ARRAYS:
        _same(getattr(a, f), getattr(b, f), f)
    _same(tuple(a.delta_cache), tuple(b.delta_cache), "delta_cache")


def _rings(seed: int, n_rings: int = 3):
    """Closed rings in font units, made from a seed: jittered polygons,
    the first counter-clockwise and large, the others inside it."""
    rng = np.random.default_rng(seed)
    rings = []
    for r in range(n_rings):
        k = int(rng.integers(5, 40))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        if r % 2:
            ang = ang[::-1]
        rad = (420.0 if r == 0 else 120.0) * rng.uniform(0.7, 1.0, k)
        c = np.array([500.0, 350.0]) + (0 if r == 0 else rng.uniform(-150, 150, 2))
        ring = c + rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
        rings.append(np.concatenate([ring, ring[:1]], axis=0))
    return rings


def _both_native():
    assert jx_native.available() and pt_native.available()


def test_the_port_has_its_own_modules():
    """Every module compared here is a file of the port, not a re-export
    of the JAX package's."""
    here = os.path.dirname(pt_pkg.__file__)
    assert here != os.path.dirname(jx_pkg.__file__)
    for name, obj in globals().items():
        if name.startswith("pt_") and isinstance(obj, types.ModuleType):
            assert os.path.dirname(obj.__file__).startswith(here), name
    assert pt_metrics.GlyphPrep is not jx_metrics.GlyphPrep


def test_constants_equal():
    names = sorted(n for n in vars(jx_constants) if n.isupper())
    assert names and names == sorted(n for n in vars(pt_constants) if n.isupper())
    for n in names:
        _same(getattr(pt_constants, n), getattr(jx_constants, n), n)
    assert pt_metrics.Q16_SCALE == jx_metrics.Q16_SCALE


@pytest.mark.parametrize("x", [-2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.5, 1e6 + 0.5, 7.25])
def test_round_half_away(x):
    assert pt_metrics._round_half_away(x) == jx_metrics._round_half_away(x)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prepare_glyph(seed):
    rings = _rings(seed, n_rings=1 + seed)
    upem, adv = (1000, 612) if seed % 2 else (2048, 1130)
    _same_prep(pt_metrics.prepare_glyph(65 + seed, rings, upem, adv),
               jx_metrics.prepare_glyph(65 + seed, rings, upem, adv))


@pytest.mark.parametrize("rings", [[], [np.array([[3.0, 4.0], [3.0, 4.0]])]], ids=["none", "point"])
def test_prepare_glyph_empty(rings):
    a = pt_metrics.prepare_glyph(32, rings, 1000, 250)
    b = jx_metrics.prepare_glyph(32, rings, 1000, 250)
    assert a.empty and b.empty
    _same_prep(a, b)


def test_prep_from_a_segment_soup():
    segs = np.random.default_rng(5).uniform(0, 20, (9, 4))
    kw = dict(codepoint=7, advance=12, dx=0.25, empty=False, width=26, height=26,
              x0=-3, y0=-3, x1=23, y1=23, segments=segs)
    _same_prep(pt_metrics.GlyphPrep(**kw), jx_metrics.GlyphPrep(**kw))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_build_cores(monkeypatch, native):
    """The font-level vectorized prep: one glyph rejected (-1), one with
    no ring, the rest made from seeds."""
    if native:
        _both_native()
    else:
        monkeypatch.setattr(jx_native, "prep_cores_batch", lambda *a: None)
        monkeypatch.setattr(pt_native, "prep_cores_batch", lambda *a: None)
    per_glyph = [_rings(10 + g, n_rings=1 + g % 3) for g in range(6)]
    nrings = np.array([len(r) for r in per_glyph[:3]] + [-1, 0] + [len(r) for r in per_glyph[3:]],
                      dtype=np.int32)
    flat = [r for rings in per_glyph for r in rings]
    pts = np.concatenate(flat, axis=0)
    ring_lens = np.array([len(r) for r in flat], dtype=np.int32)
    names = [f"g{i}" for i in range(len(nrings))]
    adv = np.random.default_rng(3).integers(200, 900, len(nrings)).astype(np.float64)
    got = pt_metrics.build_cores(names, adv, 1000, pts, ring_lens, nrings)
    want = jx_metrics.build_cores(names, adv, 1000, pts, ring_lens, nrings)
    assert list(got) == list(want) == names
    n_cores = 0
    for n in names:
        assert (got[n] is None) == (want[n] is None), n
        if want[n] is not None:
            n_cores += 1
            _same_prep(got[n].make_prep(66), want[n].make_prep(66))
    assert n_cores >= 6


def _glyphs(mod, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        if i % 4 == 3:
            out.append(mod.PbfGlyph.empty(300 + i, int(rng.integers(0, 30))))
            continue
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        out.append(mod.PbfGlyph(
            id=300 + i, bitmap=rng.integers(0, 256, (w + 6) * (h + 6), dtype=np.uint8).tobytes(),
            width=w, height=h, left=int(rng.integers(-9, 9)), top=int(rng.integers(-30, 5)),
            advance=int(rng.integers(0, 40))))
    return out


@pytest.mark.parametrize("path", ["python", "native", "default"])
def test_pbf_encode_and_decode(path):
    if path == "native":
        _both_native()
        enc_pt, enc_jx = pt_native.encode_glyph_block, jx_native.encode_glyph_block
    elif path == "python":
        enc_pt, enc_jx = pt_pbf.encode_glyphs_py, jx_pbf.encode_glyphs_py
    else:
        enc_pt, enc_jx = pt_pbf.encode_glyphs, jx_pbf.encode_glyphs
    got = enc_pt("Synth Sans Regular", "256-511", _glyphs(pt_pbf, 4))
    want = enc_jx("Synth Sans Regular", "256-511", _glyphs(jx_pbf, 4))
    assert got == want and len(want) > 1000
    a, b = pt_pbf.decode_glyphs(want), jx_pbf.decode_glyphs(want)
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert (x.id, x.bitmap, x.width, x.height, x.left, x.top, x.advance) == (
            y.id, y.bitmap, y.width, y.height, y.left, y.top, y.advance)


@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2**31 - 1, 2**32 - 1])
def test_varint_and_zigzag(v):
    a, b = bytearray(), bytearray()
    pt_pbf.encode_varint(v, a)
    jx_pbf.encode_varint(v, b)
    assert a == b
    s = v - 2**31
    assert pt_pbf.zigzag32(s) == jx_pbf.zigzag32(s)
    assert pt_pbf.unzigzag32(pt_pbf.zigzag32(s)) == jx_pbf.unzigzag32(jx_pbf.zigzag32(s)) == s


def test_native_encode_block_from_preps():
    _both_native()
    rng = np.random.default_rng(8)
    preps_pt, preps_jx, bms = [], [], []
    for i in range(5):
        rings = _rings(20 + i) if i != 2 else []
        preps_pt.append(pt_metrics.prepare_glyph(65 + i, rings, 1000, 600))
        preps_jx.append(jx_metrics.prepare_glyph(65 + i, rings, 1000, 600))
        if rings:
            p = preps_jx[-1]
            bms.append(rng.integers(0, 256, p.width * p.height, dtype=np.uint8))
    got = pt_native.encode_block_from_preps("f", "0-255", preps_pt, iter(bms))
    want = jx_native.encode_block_from_preps("f", "0-255", preps_jx, iter(bms))
    assert got == want
    glyphs = pt_driver.Renderer.assemble_glyphs(preps_pt, iter(bms))
    assert pt_pbf.encode_glyphs_py("f", "0-255", glyphs) == want


@pytest.mark.parametrize(
    "name,size,mode,flag",
    [("a/0-255.pbf", 80022, 0o644, ord("0")), ("font_x/", 0, 0o755, ord("5")),
     ("x" * 100, 2**33, 0o600, ord("0")), ("index.json", 1, 0o644, ord("0"))],
)
def test_tar_header(name, size, mode, flag):
    _both_native()
    want = jx_tar.build_header(name, size, mode, flag, mtime=1_700_000_000)
    assert pt_tar.build_header(name, size, mode, flag, mtime=1_700_000_000) == want
    assert pt_native.tar_header(name, size, mode, flag, 1_700_000_000) == want
    assert jx_native.tar_header(name, size, mode, flag, 1_700_000_000) == want
    assert len(want) == 512


def test_tar_header_refuses_long_name():
    for mod in (pt_native, jx_native):
        with pytest.raises(ValueError):
            mod.tar_header("y" * 101, 1, 0o644, ord("0"), 0)


def _write_tree(writer, seed: int):
    rng = np.random.default_rng(seed)
    writer.write_directory("synth_a/")
    for i in range(3):
        writer.write_file(f"synth_a/{256 * i}-{256 * i + 255}.pbf",
                          rng.integers(0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes())
    writer.write_file("index.json", b'["synth_a"]')
    writer.finish()


def test_writer_tar_stream(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.0)
    a, b = io.BytesIO(), io.BytesIO()
    _write_tree(pt_writer.Writer.new_tar(a), 1)
    _write_tree(jx_writer.Writer.new_tar(b), 1)
    assert a.getvalue() == b.getvalue() and len(b.getvalue()) % 512 == 0
    with tarfile.open(fileobj=io.BytesIO(a.getvalue())) as tf:
        assert [m.name for m in tf.getmembers()] == [
            "synth_a", "synth_a/0-255.pbf", "synth_a/256-511.pbf", "synth_a/512-767.pbf",
            "index.json"]


def test_writer_directory_and_dummy(tmp_path):
    _write_tree(pt_writer.Writer.new_file(str(tmp_path / "pt")), 2)
    _write_tree(jx_writer.Writer.new_file(str(tmp_path / "jx")), 2)
    trees = []
    for root in ("pt", "jx"):
        tree = {}
        for d, _, files in os.walk(tmp_path / root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    tree[os.path.relpath(os.path.join(d, f), tmp_path / root)] = fh.read()
        trees.append(tree)
    assert trees[0] == trees[1] and len(trees[0]) == 4
    a, b = pt_writer.Writer.new_dummy(), jx_writer.Writer.new_dummy()
    _write_tree(a, 2)
    _write_tree(b, 2)
    assert a.get_inner() == b.get_inner()


def test_output_directory(tmp_path):
    for mod, name in ((pt_output_dir, "pt"), (jx_output_dir, "jx")):
        root = tmp_path / name
        (root / "old").mkdir(parents=True)
        (root / "old" / "stale.pbf").write_bytes(b"x")
        out = mod.prepare_output_directory(str(root))
        assert os.path.isdir(out) and os.listdir(out) == []


def test_arena_and_progress():
    for mod in (pt_arena, jx_arena):
        a = mod.get_array("host_test", (4, 8), np.int16)
        assert a.shape == (4, 8) and a.dtype == np.int16 and not a.any()
        assert mod.get_array("host_test", (4, 8), np.int16) is a
        assert mod.get_array("host_test", (4, 9), np.int16) is not a
        mod.clear()
    assert pt_arena._CACHE is not jx_arena._CACHE
    state = []
    for mod in (pt_progress, jx_progress):
        with mod.progress_bar(10) as bar:
            bar.update(4)
            bar.update(6)
        state.append((bar.total, bar.pos, bar.enabled))
    assert state[0] == state[1] == (10, 10, False)


@pytest.mark.parametrize("seed", range(4))
def test_partition_tasks(seed):
    """The process partition: the same share for every rank and process
    count, with and without weights (ties and zeros included)."""
    rng = np.random.default_rng(seed)
    tasks = [(f"font{i % 5}", list(range(int(rng.integers(0, 40)))))
             for i in range(int(rng.integers(1, 30)))]
    weights = rng.integers(0, 6, len(tasks)).tolist() if seed % 2 else None
    for P in (1, 2, 3, 4, 7):
        got = [pt_mesh.partition_tasks(tasks, r, P, weights) for r in range(P)]
        assert got == [jx_mesh.partition_tasks(tasks, r, P, weights) for r in range(P)]
        assert sorted(id(t) for part in got for t in part) == sorted(map(id, tasks))


@pytest.mark.parametrize("shape,multiple,axis", [((5, 3), 4, 0), ((8, 3), 4, 0), ((2, 7), 3, 1),
                                                 ((0, 2), 5, 0), ((3, 2, 5), 2, 2)])
def test_pad_to_multiple(shape, multiple, axis):
    arr = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape) + 1
    got = pt_mesh.pad_to_multiple(arr, multiple, axis)
    want = jx_mesh.pad_to_multiple(arr, multiple, axis)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _same_code(ca, cb, what):
    """Two code objects compiled to the same bytes: instructions,
    constants (nested code objects by the same rule) and names."""
    assert ca.co_code == cb.co_code and ca.co_names == cb.co_names, what
    assert ca.co_varnames == cb.co_varnames and len(ca.co_consts) == len(cb.co_consts), what
    for x, y in zip(ca.co_consts, cb.co_consts):
        if isinstance(x, types.CodeType):
            _same_code(x, y, what)
        else:
            assert type(x) is type(y) and x == y, what


GEOMETRY = sorted(jx_geometry.__all__)


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_copy(name):
    """`ops.geometry` is a copy: each public name compiles to the same
    bytes, and gives the same bits on seeded rings, points and boxes."""
    assert sorted(pt_geometry.__all__) == GEOMETRY
    a, b = getattr(pt_geometry, name), getattr(jx_geometry, name)
    if name == "EMPTY_BBOX":
        _same(a, b, name)
        return
    _same_code(a.__code__, b.__code__, name)
    rng = np.random.default_rng(len(name))
    ring = _rings(len(name))[0]
    pts = rng.uniform(0, 1000, (7, 2))
    box = np.sort(rng.uniform(-40, 40, (2, 2)), axis=0) + 0.5
    args = {
        "midpoint": (pts[:3], pts[3:6]),
        "squared_distance": (pts[:3], pts[3:6]),
        "project_point_on_segment": (pts[:3], np.vstack([pts[3:5], pts[3]]), pts[4:7]),
        "segment_squared_distance_to_point": (pts[:3], pts[3:6], pts[4:7]),
        "cross_product": (pts[:3], pts[3:6], pts[4:7]),
        "ring_winding_number": (ring, [500.0, 350.0]),
        "rings_contain_point": (_rings(5), [500.0, 350.0]),
        "bbox_of": (pts,),
        "bbox_include": (box, pts[:2]),
        "bbox_is_empty": (box,),
        "bbox_round": (box,),
    }[name]
    _same(a(*args), b(*args), name)


@pytest.mark.parametrize("art", ["bitmap_as_digit_art", "bitmap_as_ascii_art"])
def test_bitmap_art_copy(art):
    """`utils.bitmap_art` is a copy: the same bytes compiled, and the
    same lines for an exact SDF bitmap and for every byte value."""
    a, b = getattr(pt_art, art), getattr(jx_art, art)
    _same_code(a.__code__, b.__code__, art)
    assert [n for n in dir(pt_art) if not n.startswith("__")] == \
        [n for n in dir(jx_art) if not n.startswith("__")]
    p = pt_metrics.prepare_glyph(65, _rings(3), 1000, 600)
    bitmap = pt_ref.render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0)
    lines = a(bitmap, p.width)
    assert len(lines) == p.height and lines == b(bitmap, p.width)
    every = np.arange(256, dtype=np.uint8)
    assert a(every, 16) == b(every, 16)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_render_sdf_exact(native):
    preps_pt = [pt_metrics.prepare_glyph(65 + i, _rings(30 + i), 1000, 600) for i in range(3)]
    preps_jx = [jx_metrics.prepare_glyph(65 + i, _rings(30 + i), 1000, 600) for i in range(3)]
    if native:
        _both_native()
        got = pt_native.render_sdf_batch(preps_pt, n_threads=2)
        want = jx_native.render_sdf_batch(preps_jx, n_threads=2)
    else:
        got = [pt_ref.render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0) for p in preps_pt]
        want = [jx_ref.render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0) for p in preps_jx]
    _same([np.asarray(g) for g in got], [np.asarray(w) for w in want])
    assert all(0 < int((np.asarray(w) > 0).sum()) for w in want)


def test_sdf_ref_pieces():
    rng = np.random.default_rng(11)
    segs = rng.uniform(0, 30, (17, 4))
    px, py = rng.uniform(0, 30, 50), rng.uniform(0, 30, 50)
    _same(pt_ref.segment_min_dist_sq(px, py, segs), jx_ref.segment_min_dist_sq(px, py, segs))
    _same(pt_ref.winding_inside(px, py, segs), jx_ref.winding_inside(px, py, segs))


def _draw(acc, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        x, y = rng.uniform(0, 1000, 2)
        acc.move_to(x, y)
        for k in range(8):
            p = rng.uniform(0, 1000, 6)
            if k % 3 == 0:
                acc.line_to(p[0], p[1])
            elif k % 3 == 1:
                acc.quad_to(p[0], p[1], p[2], p[3])
            else:
                acc.cubic_to(*p)
        acc.close_path()
    return acc.finish()


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_accumulator(seed):
    got, want = _draw(pt_flatten.RingAccumulator(), seed), _draw(jx_flatten.RingAccumulator(), seed)
    _same(got, want)
    assert len(want) == 3 and all(len(r) > 9 for r in want)
    _same(pt_flatten.rings_to_segments(got), jx_flatten.rings_to_segments(want))
    _same(tuple(pt_flatten.rings_bbox(got)), tuple(jx_flatten.rings_bbox(want)))


NAMES = [("Fira Sans", "FiraSans-BoldItalic"), ("Noto Sans Arabic", "NotoSansArabic-Regular"),
         ("Open Sans Condensed Light", "OpenSans-CondLight"), ("Foo 300", "Foo-Thin"),
         ("Synth Curved", "SynthCurved-Regular"), ("Bar Extra Bold Oblique", "Bar-ExtraBoldOblique"),
         ("", ""), ("Übung Größe", "Uebung-Black")]


@pytest.mark.parametrize("family,ps", NAMES)
def test_font_names(family, ps):
    got, want = pt_names.parse_font_name(family, ps), jx_names.parse_font_name(family, ps)
    assert got == want
    name = jx_names.generate_name(*want)
    assert pt_names.generate_name(*got) == name
    assert pt_names.name_to_id(name) == jx_names.name_to_id(name)
    assert pt_names.find_weight(ps) == jx_names.find_weight(ps)


@pytest.mark.parametrize("kind", sorted(FONTS))
def test_font_entry(kind):
    """The font parser on a synthesized font file, codepoint by
    codepoint: metadata, units, the key (None exactly where the JAX
    entry has no glyph), the advance, the prep of the glyph's core, its
    rings and its curves. The port keys glyphs by glyph id and reads the
    file without fontTools; the JAX entry keys them by name where it
    falls back to fontTools, so keys are compared by what they give."""
    data = FONTS[kind]()
    a, b = pt_entry.FontFileEntry(data), jx_entry.FontFileEntry(data)
    for f in ("name", "family", "style", "weight", "width", "codepoints"):
        _same(getattr(a.metadata, f), getattr(b.metadata, f), f)
    assert a.metadata.generate_name() == b.metadata.generate_name()
    assert repr(a.metadata) == repr(b.metadata)
    assert a.units_per_em == b.units_per_em
    cps = b.metadata.codepoints
    assert len(cps) >= 6
    ca, cb = a.prep_cores, b.prep_cores
    for cp in cps + [0x10FFFE]:
        key, name = a.glyph_key(cp), b.glyph_name(cp)
        assert (key is None) == (name is None) == (b.glyph_key(cp) is None)
        if name is None:
            continue
        assert isinstance(key, int)
        _same(a.hor_advance(key), b.hor_advance(name), "advance")
        assert (ca[key] is None) == (cb[b.glyph_key(cp)] is None)
        if ca[key] is not None:
            _same_prep(ca[key].make_prep(cp), cb[b.glyph_key(cp)].make_prep(cp))
        _same(list(a.outline_rings(key)), list(b.outline_rings(name)), "rings")
        _same(a.outline_curves(key), b.outline_curves(name), "curves")


@pytest.mark.parametrize("kind", sorted(FONTS))
def test_renderer_prep_block(kind):
    """`Renderer.prep_block` and `prep_glyph`, which the port copied into
    its own render module: surrogates, unmapped and out-of-range codepoints
    included."""
    data = FONTS[kind]()
    ea, eb = pt_entry.FontFileEntry(data), jx_entry.FontFileEntry(data)
    cps = [0xD800, 0x110000, 5] + eb.metadata.codepoints
    got = pt_driver.Renderer("exact").prep_block([(cp, ea) for cp in cps])
    want = jx_driver.Renderer("exact").prep_block([(cp, eb) for cp in cps])
    assert len(got) == len(want) == len(eb.metadata.codepoints)
    for x, y in zip(got, want):
        _same_prep(x, y)
    one = pt_driver.Renderer("zeros").prep_glyph(ea, cps[5])
    _same_prep(one, jx_driver.Renderer("zeros").prep_glyph(eb, cps[5]))
    assert pt_driver.Renderer("zeros").prep_glyph(ea, 0xDFFF) is None


def test_render_block_glyphs():
    data = FONTS["curved"]()
    ea, eb = pt_entry.FontFileEntry(data), jx_entry.FontFileEntry(data)
    cps = eb.metadata.codepoints[:6]
    got = pt_driver.Renderer("exact").render_block_glyphs([(cp, ea) for cp in cps])
    want = jx_driver.Renderer("exact").render_block_glyphs([(cp, eb) for cp in cps])
    assert pt_pbf.encode_glyphs("n", "0-255", got) == jx_pbf.encode_glyphs("n", "0-255", want)
    assert len(got) == 6 and all(g.bitmap for g in got)


def _stack(wrapper_mod, entry_mod):
    w = wrapper_mod.FontWrapper()
    w.add_file(entry_mod.FontFileEntry(build_ttf(24, first_cp=250)))
    w.add_file(entry_mod.FontFileEntry(build_ttf_curved(20, 0x1F0, seed=1)))
    return w


def test_font_wrapper_and_blocks():
    a, b = _stack(pt_wrapper, pt_entry), _stack(jx_wrapper, jx_entry)
    ba, bb = a.get_blocks(), b.get_blocks()
    assert [(x.range(), x.filename(), len(x)) for x in ba] == [
        (y.range(), y.filename(), len(y)) for y in bb]
    assert len(bb) >= 2
    for x, y in zip(ba, bb):
        assert [cp for cp, _ in x.glyph_sources()] == [cp for cp, _ in y.glyph_sources()]
        assert x.render("stack", pt_driver.Renderer("exact")) == y.render(
            "stack", jx_driver.Renderer("exact"))
    ma, mb = a.get_metadata(), b.get_metadata()
    assert (ma.family, ma.style, ma.weight, ma.width, ma.codepoints) == (
        mb.family, mb.style, mb.weight, mb.width, mb.codepoints)
    assert isinstance(ba[0], pt_block.GlyphBlock) and isinstance(bb[0], jx_block.GlyphBlock)


def test_index_files_json():
    a, b = _stack(pt_wrapper, pt_entry), _stack(jx_wrapper, jx_entry)
    ids = ["synth_sans_regular", "a_b", "Z"]
    assert pt_index.build_index_json(ids) == jx_index.build_index_json(ids)
    got = pt_index.build_font_families_json([("synth_sans_regular", a)])
    want = jx_index.build_font_families_json([("synth_sans_regular", b)])
    assert got == want and json.loads(want)[0]["faces"][0]["codeblocks"]
    for cps in ([], [0], [15, 16, 17, 48, 0x1F600], list(range(0, 4096, 7))):
        assert pt_index.encode_codeblocks(cps) == jx_index.encode_codeblocks(cps)


@pytest.mark.parametrize("tar", [False, True], ids=["dir", "tar"])
def test_font_manager_tree(tmp_path, tar, monkeypatch):
    """The port's full `FontManager` class against the JAX package's,
    one process: ingestion by path and by name, the task list, the
    rendered blocks and both index files."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_456.0)
    paths = []
    for name, data in (("a.ttf", build_ttf(24)), ("b.otf", build_otf(24)),
                       ("c.ttf", build_ttf_curved(12, 0x2F8, seed=5))):
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    outs = []
    for mgr_mod, drv, wr in ((pt_manager, pt_driver, pt_writer), (jx_manager, jx_driver, jx_writer)):
        m = mgr_mod.FontManager(parallel=False)
        m.add_paths(paths[:2])
        m.add_font_with_name("Named Stack", paths[1:])
        tasks = m.collect_tasks()
        buf = io.BytesIO()
        w = wr.Writer.new_tar(buf) if tar else wr.Writer.new_dummy()
        m.render_glyphs(w, drv.Renderer("exact"))
        m.write_index_json(w)
        m.write_families_json(w)
        w.finish()
        outs.append(([(n, b.range()) for n, b in tasks], buf.getvalue() if tar else w.get_inner()))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) >= 4
    with pytest.raises(ValueError, match="failed to parse font file"):
        (tmp_path / "bad.ttf").write_bytes(b"not a font")
        pt_manager.FontManager().add_path(str(tmp_path / "bad.ttf"))


class _Batch:
    def __init__(self, curve_mask, codepoints):
        self.curve_mask, self.codepoints = curve_mask, codepoints


@pytest.mark.parametrize("depth", [2, 3])
def test_fitted_preps(depth):
    rng = np.random.default_rng(21)
    B, C = 5, 7
    curves = rng.uniform(2, 22, (B, C, 4, 2))
    curves[:, 1:, 0] = curves[:, :-1, 3]  # consecutive curves join
    curves[2, 4, 0] += 0.5                # one chain opens
    mask = rng.uniform(size=(B, C)) < 0.8
    mask[3] = False                        # a padding row
    params = {"curves": curves, "translate": rng.normal(0, 0.3, (B, 2))}
    data = build_ttf(24)
    cps = np.arange(65, 65 + B)
    got = pt_fitted.fitted_preps(params, _Batch(mask, cps), pt_entry.FontFileEntry(data), depth)
    want = jx_fitted.fitted_preps(params, _Batch(mask, cps), jx_entry.FontFileEntry(data), depth)
    assert len(got) == len(want) == B - 1
    for x, y in zip(got, want):
        _same_prep(x, y)
    _same(pt_fitted._bernstein_f64(depth), jx_fitted._bernstein_f64(depth))
    e = pt_fitted.fitted_prep(9, np.zeros((0, 4, 2)), np.zeros(2), depth, 500, 1000)
    assert e.empty and e.advance == jx_fitted.fitted_prep(
        9, np.zeros((0, 4, 2)), np.zeros(2), depth, 500, 1000).advance


@pytest.mark.parametrize(
    "spec", ["65-90,97,0x100-0x17F", "32", " 48-57 , 65 ,", "0x41-0x43,0x42", "", "7-7"])
def test_parse_codepoints(spec):
    assert pt_cli._parse_codepoints(spec) == jx_cli._parse_codepoints(spec)


@pytest.mark.parametrize("fmt", ["csv", "tsv"])
def test_cmd_debug(tmp_path, fmt):
    """`debug` on one rendered block, and on a directory that is not
    there."""
    entry = jx_entry.FontFileEntry(build_ttf_curved(9, 0x130, seed=6))
    glyphs = jx_driver.Renderer("exact").render_block_glyphs(
        [(cp, entry) for cp in entry.metadata.codepoints])
    d = tmp_path / "font"
    d.mkdir()
    (d / "256-511.pbf").write_bytes(jx_pbf.encode_glyphs("font", "256-511", glyphs))
    args = types.SimpleNamespace(glyph_directory=str(d), format=fmt)
    a, b = io.StringIO(), io.StringIO()
    pt_cli.cmd_debug(args, a)
    jx_cli.cmd_debug(args, b)
    assert a.getvalue() == b.getvalue() and len(b.getvalue().splitlines()) == 10
    args.glyph_directory = str(tmp_path / "absent")
    with pytest.raises(SystemExit):
        pt_cli.cmd_debug(args, io.StringIO())


def test_scan(tmp_path):
    """The directory scan: font files, a directory configured by
    fonts.json (no recursion past it) and nested directories."""
    (tmp_path / "x" / "deep").mkdir(parents=True)
    (tmp_path / "named").mkdir()
    (tmp_path / "x" / "a.ttf").write_bytes(build_ttf(24))
    (tmp_path / "x" / "deep" / "b.OTF").write_bytes(build_otf(24))
    (tmp_path / "x" / "notes.txt").write_bytes(b"no font")
    (tmp_path / "named" / "c.ttf").write_bytes(build_ttf_curved(8, 65, seed=2))
    (tmp_path / "named" / "fonts.json").write_text(
        json.dumps([{"name": "My Stack", "sources": ["c.ttf"]}]))
    a, b = pt_manager.FontManager(), jx_manager.FontManager()
    pt_cli.scan(str(tmp_path), a)
    jx_cli.scan(str(tmp_path), b)
    assert sorted(a.fonts) == sorted(b.fonts) and len(b.fonts) == 3 and "my_stack" in a.fonts


def test_native_library_is_the_ports_own():
    """The port builds `csrc/vg_native.cpp` of its own package into
    build/native/ and loads nothing else."""
    pt_native.require()
    so = pt_native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(pt_pkg.__file__)))
    assert os.path.dirname(so) == os.path.join(root, "build", "native") and os.path.exists(so)
    assert pt_native._SRC == os.path.join(os.path.dirname(pt_pkg.__file__), "csrc", "vg_native.cpp")
    assert pt_native._LIB._name == so
    assert jx_native._LIB is None or jx_native._LIB._name != so


def test_native_require_reports_a_failed_build(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pt_native, "_SRC", str(bad))
    monkeypatch.setattr(pt_native, "_BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(pt_native, "_LIB", None)
    monkeypatch.setattr(pt_native, "_TRIED", False)
    monkeypatch.setattr(pt_native, "_ERROR", "")
    assert not pt_native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pt_native.require()
    assert os.listdir(tmp_path / "native") == [] or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "native"))
