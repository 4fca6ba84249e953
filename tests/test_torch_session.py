"""The port's render session against the JAX package's, on the CPU.

The ``torch`` backend runs the same dispatch and ordering code as the
card, with no streams. Every
case holds bitmaps byte for byte (tolerance: none) against the JAX
session on the same preps: the pipelined one-device session, the
several-device path (CPU stand-ins for the devices, against the JAX
mesh on 8 virtual devices, as `tests/test_mesh_render.py` runs it) and
a run of two gloo processes (the union of their trees against one
process). The JAX sessions run in one subprocess with XLA's CPU backend
capped below FMA (``--xla_cpu_max_isa=AVX``): jitted XLA code on the
CPU contracts multiply-adds, which moves a pixel by 1 now and then; the
port and the TPU round each one. The bins of
`_lpt_rounds` and the process partition are held exactly against the
JAX package's. The session dispatches on the caller's thread: no thread
of it (named ``vg``...) may be alive after it.
"""

import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.render.driver import Renderer as JaxRenderer
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf
from versatiles_glyphs_tpu_torch.ops import sdf_cuda
from versatiles_glyphs_tpu_torch.parallel import mesh
from versatiles_glyphs_tpu_torch.render import batch as tbatch
from versatiles_glyphs_tpu_torch.render import driver as tdriver
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.render.metrics import prepare_glyph
from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved, curved_preps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOW_CAPS = {"_LANES_SOFT": 1200, "_TILES_SOFT": 6}  # several groups a session
MESH_PREPS = (18, 9)  # _mixed(18, seed=9): 19 items, one outside the q16 range


def _outlier(cp=9999):
    ring = np.array([(0.0, 0.0), (6000.0, 0.0), (6000.0, 6000.0), (0.0, 6000.0), (0.0, 0.0)])
    p = prepare_glyph(cp, [ring], 1000, 6000)
    assert not p.q16_ok
    return p


def _mixed(n=14, seed=6):
    preps = curved_preps(n, 65, seed=seed)
    return preps[:5] + [_outlier()] + preps[5:]


def _vg_threads():
    return {t for t in threading.enumerate() if t.name.startswith("vg") and t.is_alive()}


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


_JAX_SIDE = r"""
import os, sys
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import test_torch_session as t
from versatiles_glyphs_tpu.parallel.mesh import data_mesh
from versatiles_glyphs_tpu.render.driver import Renderer

out = {}
saved = {k: getattr(Renderer, k) for k in t.LOW_CAPS}
for k, v in t.LOW_CAPS.items():
    setattr(Renderer, k, v)
for wire in ("i8", "i16", "f32"):
    bms = Renderer("tpu", transport=wire).render_bitmaps(t._mixed(), parallel=False)
    out.update({f"session_{wire}_{i}": np.asarray(b) for i, b in enumerate(bms)})
for k, v in saved.items():
    setattr(Renderer, k, v)
assert data_mesh().devices.size == 8
for wire in ("i8", "f32"):
    bms = Renderer("tpu", transport=wire).render_bitmaps(t._mixed(*t.MESH_PREPS), parallel=True)
    out.update({f"mesh_{wire}_{i}": np.asarray(b) for i, b in enumerate(bms)})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX sessions' bitmaps: ``jax_side(kind, wire)`` lists them."""
    tmp = tmp_path_factory.mktemp("jax_side")
    env = dict(os.environ, JAX_PLATFORMS="cpu", VG_JAX_CACHE_DIR=str(tmp / "jax_cache"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "out.npz")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = dict(np.load(tmp / "out.npz"))

    def lookup(kind, wire):
        n = sum(1 for k in got if k.startswith(f"{kind}_{wire}_"))
        return [got[f"{kind}_{wire}_{i}"] for i in range(n)]

    return lookup


@pytest.fixture
def low_caps(monkeypatch):
    for k, v in LOW_CAPS.items():
        monkeypatch.setattr(Renderer, k, v)


@pytest.fixture
def dispatches(monkeypatch):
    """Record the thread and lane of every group dispatched."""
    seen = []
    real = Renderer._dispatch_group

    def spy(self, gitems, wire, TP, lane):
        seen.append((threading.current_thread().name, lane, wire, len(gitems)))
        return real(self, gitems, wire, TP, lane)

    monkeypatch.setattr(Renderer, "_dispatch_group", spy)
    return seen


@pytest.mark.parametrize("transport", ["i8", "i16", "f32"])
def test_pipelined_session_matches_jax(jax_side, low_caps, dispatches, transport):
    mixed = _mixed()
    want = jax_side("session", transport)
    before = _vg_threads()
    s = Renderer("torch", transport=transport).start_session(parallel=False)
    for i in range(0, len(mixed), 3):
        s.add(mixed[i : i + 3])
    got = list(s.results())
    _same(got, want)
    assert s.groups > 3
    assert len(dispatches) == s.groups
    assert all(name == threading.current_thread().name for name, *_ in dispatches)
    assert {w for *_, w, _ in dispatches} == {transport, "f32"}  # the outlier's aux group
    assert _vg_threads() <= before


def test_wire_stats_count_the_packed_arrays(low_caps, monkeypatch):
    packed = []
    real = tbatch.pack_points_delta

    def spy(preps, *a, **kw):
        out = real(preps, *a, **kw)
        packed.append(sum(x.nbytes for x in out))
        return out

    monkeypatch.setattr(tbatch, "pack_points_delta", spy)
    preps = curved_preps(12, 65, seed=2)
    tdriver.reset_wire_stats()
    s = Renderer("torch").start_session(parallel=False)
    s.add(preps)
    got = list(s.results())
    assert len(got) == 12 and s.groups == len(packed) >= 2
    assert tdriver.WIRE_STATS == {
        "upload_bytes": sum(packed),
        "fetch_bytes": 256 * sum(p.ntiles256 for p in preps),
        "groups": s.groups,
        "glyphs": 12,
        "tiles": sum(p.ntiles256 for p in preps),
        "pixels": sum(p.width * p.height for p in preps),
    }
    tdriver.reset_wire_stats()
    assert tdriver.WIRE_STATS == {"upload_bytes": 0, "fetch_bytes": 0, "groups": 0, "glyphs": 0,
                                  "tiles": 0, "pixels": 0}


@pytest.mark.parametrize("wire", ["i8", "f32"])
def test_bad_plan_is_refused_before_upload(monkeypatch, wire):
    """The session checks each group's lane runs on its host arrays; a
    bad plan raises from `results` and nothing is uploaded."""
    if wire == "i8":
        real = tbatch.pack_points_delta

        def bad(preps, *a, **kw):
            d, w, anc, meta = real(preps, *a, **kw)
            meta = meta.copy()
            meta[0, 4] = d.shape[1] + 1
            return d, w, anc, meta

        monkeypatch.setattr(tbatch, "pack_points_delta", bad)
    else:
        real = tbatch.plan_tiles

        def bad(*a, **kw):
            tmeta, starts, T = real(*a, **kw)
            tmeta = tmeta.copy()
            tmeta[0, 5] = -32
            return tmeta, starts, T

        monkeypatch.setattr(tbatch, "plan_tiles", bad)
    uploads = []
    monkeypatch.setattr(tbatch, "wire_to_device", lambda *a: uploads.append(a))
    tdriver.reset_wire_stats()
    before = _vg_threads()
    s = Renderer("torch", transport=wire).start_session(parallel=False)
    s.add(curved_preps(3, 65, seed=1))
    with pytest.raises(ValueError, match="outside"):
        list(s.results())
    assert not uploads and tdriver.WIRE_STATS["upload_bytes"] == 0
    assert _vg_threads() <= before


def test_check_lane_runs_matches_the_device_check():
    """`check_lane_runs` on host arrays refuses what the wrappers' device
    check refuses, and the anchors' lanes too."""
    rng = np.random.default_rng(3)
    N = 4096
    for _ in range(200):
        tm = np.zeros((8, 9), np.int32)
        tm[4] = rng.integers(-2, 900, 9)
        tm[5] = rng.integers(-2, N, 9)
        want = bool(sdf_cuda._lanes_out_of_bounds(torch.from_numpy(tm), N).any())
        try:
            sdf_cuda.check_lane_runs(N, tm[4], tm[5])
            got = False
        except ValueError:
            got = True
        assert got == want
    sdf_cuda.check_lane_runs(N, [3], [N - 3], anchor_lanes=[0, N - 1])
    for lanes in ([N], [-1]):
        with pytest.raises(ValueError, match="anchors"):
            sdf_cuda.check_lane_runs(N, [3], [0], anchor_lanes=lanes)


def test_session_renders_through_the_checked_wrappers(monkeypatch):
    calls = []
    for name in ("render_bitmaps_cuda_delta", "render_bitmaps_cuda_pts"):
        real = getattr(sdf_cuda, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("checked")))
            return _real(*a, **kw)

        monkeypatch.setattr(sdf_cuda, name, spy)
    Renderer("torch").render_bitmaps(_mixed(4), parallel=False)
    assert ("render_bitmaps_cuda_delta", True) in calls
    assert ("render_bitmaps_cuda_pts", True) in calls  # the f32 aux group
    assert all(checked for _, checked in calls if _ == "render_bitmaps_cuda_delta")


def test_worker_is_reaped_after_close_break_and_error(low_caps, monkeypatch):
    """The session starts no thread of its own, and a failed dispatch
    raises to the caller: nothing of it is left after `close`, an early
    stop or an error."""
    preps = curved_preps(10, 65, seed=4)
    before = _vg_threads()
    r = Renderer("torch")

    # close() with groups dispatched and none fetched.
    s = r.start_session(parallel=False)
    s.add(preps)
    assert s.groups >= 2 and not _vg_threads() - before
    s.close()
    assert _vg_threads() <= before
    with pytest.raises(RuntimeError, match="closed"):
        list(s.results())

    # A consumer that stops early.
    s = r.start_session(parallel=False)
    s.add(preps)
    for _ in s.results():
        break
    assert _vg_threads() <= before
    with pytest.raises(RuntimeError, match="closed"):
        s.add(preps)

    # An error in a dispatch is raised to the caller: from the add()
    # that fills a group, and from results() for the last group.
    def boom(*a, **kw):
        raise OSError("pack failed")

    monkeypatch.setattr(tbatch, "pack_points_delta", boom)
    with pytest.raises(OSError, match="pack failed"):
        with r.start_session(parallel=False) as s:
            s.add(preps)
    assert s._closed and _vg_threads() <= before
    with r.start_session(parallel=False) as s:
        s.add(preps[:1])
        with pytest.raises(OSError, match="pack failed"):
            list(s.results())
    assert s._closed and _vg_threads() <= before


# -- several devices ------------------------------------------------------


def test_data_devices_on_the_cpu():
    assert mesh.data_devices() is None  # no card here
    assert mesh.data_devices(device_type="cpu") is None
    assert mesh.initialize_multihost(None) is None
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)


def _fake_prep(rng):
    w, h = (int(v) for v in rng.integers(1, 300, 2))
    return types.SimpleNamespace(width=w, height=h, npts=int(rng.integers(1, 90_000)))


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_lpt_rounds_equal_jax(D):
    rng = np.random.default_rng(D)
    items = [(i, _fake_prep(rng)) for i in range(120)]
    items += [(120, types.SimpleNamespace(width=1, height=1, npts=1))]
    want = JaxRenderer("tpu")._lpt_rounds(items, D, 256)
    got = Renderer("torch")._lpt_rounds(items, D, 256)
    ids = lambda rounds: [[[i for i, _ in b] for b in r] for r in rounds]  # noqa: E731
    assert ids(got) == ids(want)
    assert sum(len(b) for r in got for b in r) == len(items)
    if D == 3:
        assert len(got) > 1  # the caps force more than one round


@pytest.mark.parametrize("transport", ["i8", "f32"])
def test_several_devices_match_one_device_and_jax_mesh(
        jax_side, monkeypatch, dispatches, transport):
    stand_ins = [CPU, CPU, CPU]
    monkeypatch.setattr(mesh, "data_devices", lambda *a, **kw: stand_ins)
    preps = _mixed(*MESH_PREPS)
    r = Renderer("torch", transport=transport)
    one = r.render_bitmaps(preps, parallel=False)
    n_one = len(dispatches)
    del dispatches[:]
    several = r.render_bitmaps(preps, parallel=True)
    _same(several, one)
    lanes = {id(lane) for _, lane, *_ in dispatches}
    assert len(lanes) == 3 and len(dispatches) > n_one
    assert all(name == "MainThread" for name, *_ in dispatches)
    if transport == "i8":
        # The aux partition (one item) leaves two bins of its round empty.
        aux = [(i, p) for i, p in enumerate(preps) if not p.q16_ok]
        bins = r._lpt_rounds(aux, 3, 256)[0]
        assert [len(b) for b in bins] == [1, 0, 0]
        assert sum(1 for *_, w, _ in dispatches if w == "f32") == 1
    main = [(i, p) for i, p in enumerate(preps) if p.q16_ok or transport == "f32"]
    tiles = [sum(p.ntiles256 for _, p in b) for b in r._lpt_rounds(main, 3, 256)[0]]
    assert max(tiles) > min(tiles)  # uneven bins
    _same(several, jax_side("mesh", transport))

    # Fewer than two items a device: the one-device groups on the first.
    del dispatches[:]
    few = preps[:5]
    _same(r.render_bitmaps(few, parallel=True), one[:5])
    assert {id(lane) for _, lane, *_ in dispatches} == {id(dispatches[0][1])}


def test_explicit_devices_list_one_device_twice(monkeypatch, dispatches):
    """One device listed twice as the local devices gives two lanes (as
    `chip_smoke.py` lists the one card)."""
    preps = curved_preps(9, 65, seed=10)
    r = Renderer("torch")
    monkeypatch.setattr(mesh, "data_devices", lambda *a, **kw: [CPU, CPU])
    with r.start_session() as s:
        s.add(preps)
        got = list(s.results())
    _same(got, r.render_bitmaps(preps, parallel=False))
    assert s.groups == 2 and len({id(lane) for _, lane, *_ in dispatches[:2]}) == 2


# -- several processes ----------------------------------------------------

_WORKER = r"""
import sys
pid, coord, outdir, fonts = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4:]
from versatiles_glyphs_tpu_torch.parallel.mesh import (
    initialize_multihost, process_count, process_index)
initialize_multihost(coord, num_processes=2, process_id=pid)
assert (process_count(), process_index()) == (2, pid)
import torch.distributed as dist
from versatiles_glyphs_tpu_torch.font.manager import FontManager
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.writer import Writer
mgr = FontManager()
mgr.add_paths(fonts)
w = Writer.new_file(outdir)
mgr.render_glyphs(w, Renderer("torch"))
mgr.write_index_json(w)
mgr.write_families_json(w)
w.finish()
dist.barrier()
dist.destroy_process_group()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "versatiles_glyphs_tpu"))
assert not bad, bad
print("WORKER_OK", pid)
"""


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_two_gloo_processes_split_the_tree(tmp_path, monkeypatch):
    import jax

    from versatiles_glyphs_tpu.font.manager import FontManager as JaxManager
    from versatiles_glyphs_tpu_torch.font.manager import FontManager
    from versatiles_glyphs_tpu_torch.writer import Writer

    fonts = []
    for name, data in (("a.ttf", build_ttf(24, 65)), ("b.otf", build_otf(24, 300)),
                       ("c.ttf", build_ttf_curved(30, 0x2F0, seed=2))):
        (tmp_path / name).write_bytes(data)
        fonts.append(str(tmp_path / name))

    # One process.
    single = tmp_path / "single"
    mgr = FontManager()
    mgr.add_paths(fonts)
    tasks = [f"{n}/{b.filename()}" for n, b in mgr.collect_tasks()]
    assert len(tasks) >= 4
    w = Writer.new_file(str(single))
    mgr.render_glyphs(w, Renderer("torch"))
    mgr.write_index_json(w)
    mgr.write_families_json(w)
    w.finish()
    want = _tree(single)

    # The JAX package's partition for each rank, by its own manager.
    jmgr = JaxManager()
    jmgr.add_paths(fonts)
    jtasks = jmgr.collect_tasks()
    shares = []
    for rank in range(2):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        part = JaxManager._host_partition(jtasks, JaxRenderer("exact"))
        shares.append({f"{n}/{b.filename()}" for n, b in part})
    monkeypatch.undo()
    assert shares[0] and shares[1] and not shares[0] & shares[1]
    assert shares[0] | shares[1] == set(tasks)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [tmp_path / f"proc{p}" for p in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(p), f"127.0.0.1:{port}", str(outs[p]), *fonts],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for p in range(2)
    ]
    results = []
    try:
        for proc in procs:
            results.append(proc.communicate(timeout=240))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for p, (proc, (out, err)) in enumerate(zip(procs, results)):
        assert proc.returncode == 0, f"process {p} failed:\n{err[-3000:]}"
        assert f"WORKER_OK {p}" in out

    trees = [_tree(o) for o in outs]
    for rank in range(2):
        pbfs = {k for k in trees[rank] if k.endswith(".pbf")}
        assert pbfs == shares[rank]
    assert "index.json" in trees[0] and "font_families.json" in trees[0]
    assert "index.json" not in trees[1] and "font_families.json" not in trees[1]
    union = dict(trees[1])
    union.update(trees[0])
    assert union == want
