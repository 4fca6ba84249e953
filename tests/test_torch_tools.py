"""The measurement tools and their two kernels' plain versions, on the CPU.

- `ops.sdf_torch.alu_roof` (plain version of ``csrc/alu_roof.cu``)
  against the body of `_roof_kernel` of the JAX package's
  ``scripts/roofline.py:190-200``, restated with eager ``jnp`` ops on
  the CPU: the kernel is a closure inside that script's ``main()`` and
  cannot be imported. Eager ops are dispatched one by one and do not
  contract into fused multiply-adds. Tolerance: none, bit-equal.
- The tools' work count (`tools.work`) against a brute-force count.
- The decomposition of ``csrc/sdf_tiles_pts_acc.cu`` (L threads a pixel,
  each over every L-th segment, reduced once) written in plain PyTorch:
  byte for byte `ops.sdf_torch.render_tiles_pts` and the JAX package's
  `render_bitmaps_pts_jax`, which is what ``scripts/kernel_ab.py:187-189``
  asserts of the TPU variant.
- The tools raise without a card; the wrappers take their plain
  versions only for the CPU by name.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_pts_jax
from versatiles_glyphs_tpu.render import batch as jbatch
from versatiles_glyphs_tpu_torch.ops import sdf_cuda, sdf_torch
from versatiles_glyphs_tpu_torch.render import batch as pbatch
from versatiles_glyphs_tpu_torch.tools import kernel_ab, roofline, session_turns, work
from versatiles_glyphs_tpu_torch.utils.synth_font import curved_preps

TP = 256


def _roof_body_jnp(T: int, tp: int, n_chunk: int) -> np.ndarray:
    """``scripts/roofline.py:190-200`` on the CPU, one eager op at a
    time: ``acc = 1.0``; per chunk ten times ``a = a * 1.000001 + x;
    a = minimum(a, 3.0e38)``; ``x`` starts at 0.5 and grows by 1.0 a
    chunk. Every tile of the grid computes the same block, and the
    kernel stores lane 0 of each pixel row."""
    K_OPS = 30
    a = jnp.full((tp, 1), 1.0, jnp.float32)
    x = jnp.float32(0.5)
    for _ in range(n_chunk):
        for _ in range(K_OPS // 3):
            a = a * 1.000001 + x
            a = jnp.minimum(a, 3.0e38)
        x = x + 1.0
    assert a.dtype == jnp.float32
    return np.broadcast_to(np.asarray(a).reshape(1, tp), (T, tp))


@pytest.mark.parametrize("n_chunk", [0, 1, 2, 7, 40, 113, 400])
def test_alu_roof_matches_the_tpu_kernels_body(n_chunk):
    got = sdf_torch.alu_roof(3, 128, n_chunk)
    want = _roof_body_jnp(3, 128, n_chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 128)
    assert got.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
    if n_chunk == 0:
        assert float(got[0, 0]) == 1.0
    if n_chunk >= 40:
        assert 1e3 < float(got[0, 0]) < 3.0e38  # it grows and the min never binds


def test_alu_roof_is_not_the_fused_recurrence():
    """The plain version rounds the multiply and the add separately: the
    same recurrence in f64, rounded once a step as a fused multiply-add
    would, gives other bits (at 112 chunks, the depth the tool uses on the
    text font; at some depths the two happen to meet)."""
    a = np.float32(1.0)
    for k in range(112):
        for _ in range(10):
            a = np.float32(min(np.float64(a) * np.float64(np.float32(1.000001))
                               + np.float64(np.float32(0.5 + k)), 3.0e38))
    assert np.float32(sdf_torch.alu_roof(1, 32, 112)[0, 0]) != a


def test_alu_roof_wrapper_on_the_cpu():
    sdf_cuda.reset_launches()
    got = sdf_cuda.alu_roof_cuda(2, 64, 5, "cpu")
    assert torch.equal(got, sdf_torch.alu_roof(2, 64, 5))
    assert sdf_cuda.alu_roof_ops(2, 64, 5) == 2 * 64 * 5 * sdf_cuda.ALU_ROOF_CHAINS * 30
    for bad in (dict(TP=48), dict(TP=2048), dict(T=-1), dict(n_chunk=-1)):
        kw = dict(T=2, TP=64, n_chunk=5) | bad
        with pytest.raises(ValueError):
            sdf_cuda.alu_roof_cuda(kw["T"], kw["TP"], kw["n_chunk"], "cpu")
    with pytest.raises(ValueError, match="no plain version"):
        sdf_cuda.alu_roof_cuda(2, 64, 5, "cpu", fused=True)
    assert not any(sdf_cuda.LAUNCHES.values())
    assert {"alu_roof", "sdf_tiles_pts_acc"} <= set(sdf_cuda.KERNELS) and len(sdf_cuda.KERNELS) == 9


@pytest.fixture(scope="module")
def preps():
    return curved_preps(20, 65, seed=5)


def _wire(preps, dtype=np.float32):
    pts, words, meta = pbatch.pack_points(preps, dtype=dtype, arena_tag="_ttools")
    T = pbatch.tile_starts(meta, len(preps), TP)[1]
    tmeta = np.ascontiguousarray(pbatch.plan_tiles(preps, meta, TP, T_pad=T)[0].T)
    return np.array(pts), np.array(words), tmeta


def test_work_count_against_brute_force(preps):
    """Live pairs = over the tile rows that are not skipped, TP times the
    glyph's live segments, counted here one segment and one row at a
    time from the preps themselves."""
    pts, words, tmeta = _wire(preps)
    pairs = pixels = 0
    for p in preps:
        live = sum(len(r) - 1 for r in p.rings_px)
        assert live == int(p.valid8.sum())
        tiles = -(-(p.width * p.height) // TP)
        pairs += tiles * TP * live
        pixels += tiles * TP
    w = work.tile_kernel_work(tmeta, words, TP, pts.shape[1])
    T = tmeta.shape[1]
    assert w["pairs"] == pairs == work.live_pairs(tmeta, words, TP) and pairs > 10**6
    assert w["pixels"] == pixels == work.live_tiles(tmeta) * TP
    assert w["tiles"] == T >= work.live_tiles(tmeta)
    assert w["f32_ops"] == pairs * work.PAIR_F32_OPS + pixels * work.BYTE_PIXEL_F32_OPS
    assert w["bytes"] == 8 * pts.shape[1] + 4 * words.size + 32 * T + T * TP
    # Bit by bit, without the cumulative sum.
    segs = work.live_segments(tmeta, words)
    for t in range(T):
        x0, y0, ww, hh, npts, off, base, _ = (int(v) for v in tmeta[:, t])
        n = sum((int(words[i >> 5]) >> (i & 31)) & 1 for i in range(off, off + max(npts - 1, 0)))
        assert segs[t] == (n if base < ww * hh else 0), t
    # The tool's own packing gives the same count.
    g = roofline.group_work(preps, arena_tag="_ttools2")
    assert (g["pairs"], g["pixels"], g["tiles"], g["glyphs"]) == (pairs, pixels, T, 20)
    assert g["npix"] == sum(p.width * p.height for p in preps)
    assert roofline.roof_chunks(g) == max(1, round(pairs / pixels / sdf_cuda.ALU_ROOF_CHAINS))


def test_work_count_of_a_segment_soup():
    tmeta = np.array([[0, 0], [0, 0], [10, 4], [10, 4], [7, 9], [0, 7], [0, 256], [0, 0]], np.int32)
    assert work.live_segments(tmeta).tolist() == [7, 0]  # the second row is past w*h
    assert work.live_pairs(tmeta, None, TP) == 7 * TP and work.live_tiles(tmeta) == 1


def test_pair_ops_are_counted_from_the_source():
    """`work.PAIR_F32_OPS` against the f32 operators of the per-pair math:
    `project` of ``csrc/sdf_pair.cuh`` and `d2_and_winding` of
    ``csrc/sdf_tiles_pts_acc.cu``, counted from the text: binary
    ``* + -`` between floats, ``fminf``/``fmaxf``, and the float
    compares; plus the caller's running ``fminf``."""
    import os
    import re

    import versatiles_glyphs_tpu_torch as pkg

    csrc = os.path.join(os.path.dirname(pkg.__file__), "csrc")
    with open(os.path.join(csrc, "sdf_pair.cuh")) as f:
        header = f.read()
    with open(os.path.join(csrc, "sdf_tiles_pts_acc.cu")) as f:
        acc = f.read()

    def body(src, name):
        i = src.index(name)
        i = src.index("{", src.index(")", i))
        depth, j = 0, i
        while True:
            depth += {"{": 1, "}": -1}.get(src[j], 0)
            j += 1
            if depth == 0:
                return re.sub(r"//[^\n]*", "", src[i:j])

    proj = body(header, "void project(")
    pair = body(acc, "float d2_and_winding(")
    pair = pair.replace("vg::project(ex, ey, a.z, a.w, b.x, tc, qx, qy);", "")
    # Integer: the winding's step; the validity select is not arithmetic.
    pair = pair.replace("wn += valid && cross && cx <= pxc ? (c1 ? 1 : -1) : 0;",
                        "cx <= pxc")
    ops = 0
    for text in (proj, pair):
        ops += len(re.findall(r"(?<=[\w\)\]]) [*+-] (?=[\w\(])", text))
        ops += len(re.findall(r"\bfm(?:in|ax)f\(", text))
        ops += len(re.findall(r"<=", text))
    assert ops + 1 == work.PAIR_F32_OPS == 22
    # The caller's running min, once a pair.
    assert acc.count("dmin = fminf(dmin, d2_and_winding(") == 2


def test_issue_rate_is_half_the_published_peak():
    """An un-fused f32 stream's roof: SMs × 128 instructions a clock; at
    the H100's 132 SMs and 1,980 MHz half the published 67·10¹², which
    counts a fused multiply-add as two."""
    rate = work.issue_rate_ops_per_s(132, 1980)
    assert rate == 132 * 128 * 1980e6 == pytest.approx(33.45e12, rel=1e-3)
    assert 2 * rate == pytest.approx(work.PEAK_F32_OPS_PER_S, rel=3e-3)
    assert work.share_of_issue_rate(rate * 2e-3, 2.0, 132, 1980) == pytest.approx(1.0)
    assert work.share_of_issue_rate(rate * 1e-3, 2.0, 132, 990) == pytest.approx(1.0)
    assert work.share_of_issue_rate(rate * 1e-3, 2.0, 66, 1980) == pytest.approx(1.0)


def test_bound_picks_the_larger_time():
    ms, by = work.bound(67e12, 1.0)
    assert by == "operations" and ms == pytest.approx(1000.0)
    ms, by = work.bound(1.0, 3.35e12)
    assert by == "bytes" and ms == pytest.approx(1000.0)


def _split_and_reduce(pts, words, tmeta, L: int) -> torch.Tensor:
    """``csrc/sdf_tiles_pts_acc.cu`` in plain PyTorch: partial l of a
    pixel keeps the min d² and the winding sum over the segments at
    positions l, l + L, ... of its glyph's run; the L partials are then
    reduced (min, sum) and quantized once."""
    out = torch.zeros((tmeta.shape[1], TP), dtype=torch.uint8)
    for t0, m, _, d2, steps in sdf_torch._tile_chunks(
            pts, words, tmeta, TP, pair=sdf_torch._pair_d2_steps):
        dmins = torch.stack([
            torch.amin(d2[:, :, l::L], dim=2) if d2[:, :, l::L].shape[2]
            else torch.full(d2.shape[:2], sdf_torch._BIG) for l in range(L)])
        wns = torch.stack([steps[:, :, l::L].sum(dim=2) for l in range(L)])
        byte = sdf_torch._sdf_bytes(torch.amin(dmins, dim=0), wns.sum(dim=0))
        byte = torch.where(m[6][:, None] < m[2][:, None] * m[3][:, None], byte, 0.0)
        out[t0 : t0 + m.shape[1]] = byte.to(torch.uint8)
    return out


@pytest.mark.parametrize("L", [2, 4, 32])
@pytest.mark.parametrize("wire", ["f32", "i16"])
def test_split_and_reduce_gives_the_tile_kernels_bytes(preps, wire, L):
    pts, words, tmeta = _wire(preps, np.int16 if wire == "i16" else np.float32)
    p, w, tm = torch.from_numpy(pts), torch.from_numpy(words), torch.from_numpy(tmeta)
    if wire == "i16":
        p = sdf_torch.dequantize(p)
    want = sdf_torch.render_tiles_pts(p, w, tm, TP)
    got = _split_and_reduce(p, w, tm, L)
    assert torch.equal(got, want) and int((want > 0).sum()) > 1000

    jpts, jwords, jmeta, _ = jbatch.pack_points(
        preps, dtype=np.int16 if wire == "i16" else np.float32, arena_tag="_ttools_j")
    jtm = jbatch.plan_tiles(preps, jmeta, TP)[0]
    L_max = jbatch.bucket(int(jtm[:, 4].max()), jbatch.S_BUCKETS)
    jax_bytes = np.asarray(render_bitmaps_pts_jax(np.array(jpts), np.array(jwords), jtm, TP, L_max))
    T = tmeta.shape[1]
    np.testing.assert_array_equal(got.numpy(), jax_bytes[:T])

    # The wrapper on the CPU is the plain version, and counts no launch.
    sdf_cuda.reset_launches()
    assert torch.equal(sdf_cuda.render_bitmaps_cuda_pts_acc(p, w, tm, TP, split=min(L, 4)), want)
    assert not any(sdf_cuda.LAUNCHES.values())


def test_split_wrapper_rejects_bad_splits(preps):
    pts, words, tmeta = (torch.from_numpy(a) for a in _wire(preps[:2]))
    for split in (0, 3, 8, 64):  # 8 · 256 threads do not fit a block
        with pytest.raises(ValueError, match="split"):
            sdf_cuda.render_bitmaps_cuda_pts_acc(pts, words, tmeta, TP, split=split)
    assert sdf_cuda.render_bitmaps_cuda_pts_acc(pts, words, tmeta[:, :0], TP).shape == (0, TP)


@pytest.mark.parametrize("tool", [roofline, kernel_ab, session_turns],
                         ids=["roofline", "kernel_ab", "session_turns"])
def test_tools_raise_without_a_card(monkeypatch, tool, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert capsys.readouterr().out == ""
    assert not any(sdf_cuda.LAUNCHES.values())


def test_session_turns_on_the_cpu(monkeypatch):
    """`session_turns.turns` on the ``torch`` backend with a tiny font:
    two variants of this package, timed in turns, trees held equal, the
    profiled render without device events and `WIRE_STATS` read."""
    monkeypatch.setitem(roofline.FONTS, "tiny", (20, 65, 3, 8))
    variants = [session_turns.Variant(label, "versatiles_glyphs_tpu_torch", "torch")
                for label in ("a", "b")]
    res = session_turns.turns(variants, ["tiny"], 3, lambda: None, with_timeline=True)
    for label in ("a", "b"):
        rec = res["tiny"][label]
        tl = rec["timeline"]
        assert {"MainThread:pack", "MainThread:upload", "MainThread:render",
                "MainThread:fetch", "MainThread:wait_fetch", "MainThread:encode"} <= set(tl["stage_ms"])
        assert all(0 <= a <= b <= 1e3 * tl["seconds"] + 1 for _, _, a, b in tl["spans"])
        assert len(rec["seconds"]) == 3 and rec["seconds_min"] <= rec["seconds_median"]
        assert rec["seconds_iqr"] >= 0
        assert ("turns_first_faster" in rec) == (label == "b")
        assert rec["device_events"] == 0 and rec["device_busy_share"] is None
        assert rec["wire_stats"]["groups"] == 1
        assert rec["wire_stats"]["fetch_bytes"] == 256 * sum(
            p.ntiles256 for p in curved_preps(20, 65, seed=3))
    variants[1].native = types.SimpleNamespace(
        encode_block_from_preps=lambda name, rng, bp, it: b"other" + bytes(len(list(zip(bp, it)))))
    with pytest.raises(AssertionError, match="tree differs"):
        session_turns.turns(variants, ["tiny"], 1, lambda: None)


def test_first_group_is_the_sessions(monkeypatch, preps):
    from versatiles_glyphs_tpu_torch.render.driver import Renderer

    assert roofline.first_group(preps) == preps
    monkeypatch.setattr(Renderer, "_LANES_SOFT", preps[0].npts + preps[1].npts)
    assert roofline.first_group(preps) == preps[:2]
    s = Renderer("torch").start_session()
    s.add(preps)
    assert s.groups >= 2
    s.close()


def test_sass_counts_parses_a_listing(monkeypatch, tmp_path):
    """`sass_counts` on a canned ``cuobjdump -sass`` listing."""
    listing = (
        "\tFunction : alu_roof_kernel\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   FMUL R0, R0, 1.00000095367431640625 ;\n"
        "        /*0020*/                   FADD R0, R0, R5 ;\n"
        "        /*0030*/                   FMNMX R0, R0, 3.0e38, PT ;\n"
        "        /*0040*/              @!P0 FADD R2, R2, R0 ;\n"
        "        /*0050*/                   EXIT ;\n"
        "\tFunction : other\n"
        "        /*0000*/                   FFMA R0, R0, R1, R2 ;\n"
    )
    exe = tmp_path / "cuobjdump"
    exe.write_text("#!/bin/sh\ncat <<'EOF'\n" + listing + "EOF\n")
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path), prepend=":")
    got, missing = roofline.sass_counts("any.so")
    assert missing is None
    assert got == {"alu_roof_kernel": {"FMUL": 1, "FADD": 2, "FMNMX": 1, "FFMA": 0},
                   "other": {"FMUL": 0, "FADD": 0, "FMNMX": 0, "FFMA": 1}}

    exe.write_text("#!/bin/sh\necho 'not a cubin' >&2\nexit 3\n")
    got, missing = roofline.sass_counts("any.so")
    assert got is None and "exited 3" in missing and "not a cubin" in missing


def test_sass_loops_finds_the_segment_loops(monkeypatch, tmp_path):
    """`sass_loops` on a canned listing: a loop is the span from a
    backward branch's target to the branch; one with a barrier or with
    few f32 instructions is left out."""
    body = "".join(f"        /*{0x20 + 16 * i:04x}*/                   FMUL.SAT R0, R0, R1 ;\n"
                   for i in range(3))
    listing = (
        "\tFunction : k\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        "        /*0010*/                   LDS.128 R4, [R2] ;\n" + body +
        "        /*0050*/              @!P0 FADD R2, R2, R0 ;\n"
        "        /*0060*/               @P1 BRA 0x10 ;\n"
        "        /*0070*/                   BAR.SYNC 0x0 ;\n"
        "        /*0080*/                   FADD R2, R2, R0 ;\n"
        "        /*0090*/                   BRA 0x70 ;\n"
        "        /*00a0*/                   BRA 0xc0 ;\n"
        "        /*00b0*/                   EXIT ;\n"
    )
    exe = tmp_path / "cuobjdump"
    exe.write_text("#!/bin/sh\ncat <<'EOF'\n" + listing + "EOF\n")
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path), prepend=":")
    got, missing = roofline.sass_loops("any.so", min_f32=4)
    assert missing is None
    assert got == {"k": [{"instructions": 6, "mix": {"LDS": 1, "FMUL": 3, "FADD": 1, "BRA": 1}}]}
    assert roofline.sass_loops("any.so", min_f32=5)[0] == {"k": []}
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    assert roofline.sass_loops("any.so") == (None, "cuobjdump not found")


def test_sass_counts_says_why_there_is_no_listing(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert roofline.sass_counts("any.so") == (None, "cuobjdump not found")


@pytest.mark.parametrize("counts, fault", [
    ({"FMUL": 42, "FADD": 50, "FMNMX": 40, "FFMA": 0}, None),
    ({"FMUL": 2, "FADD": 11, "FMNMX": 40, "FFMA": 40}, "FFMA"),  # contracted
    ({"FMUL": 10, "FADD": 12, "FMNMX": 10, "FFMA": 0}, "at least 40"),  # chains merged
], ids=["whole", "contracted", "merged"])
def test_roof_sass_check(counts, fault):
    """The un-fused roof kernel must keep ten of each operation a chain
    and no fused multiply-add; the fused one is not held to that."""
    sass = {"_Z15alu_roof_kernelILb0EEvifPf": counts,
            "_Z15alu_roof_kernelILb1EEvifPf": {"FMUL": 2, "FADD": 11, "FMNMX": 120, "FFMA": 120}}
    if fault is None:
        roofline.check_roof_sass(sass, sdf_cuda.ALU_ROOF_CHAINS)
    else:
        with pytest.raises(AssertionError, match=fault):
            roofline.check_roof_sass(sass, sdf_cuda.ALU_ROOF_CHAINS)
    with pytest.raises(AssertionError, match="no un-fused kernel"):
        roofline.check_roof_sass({"other": counts}, sdf_cuda.ALU_ROOF_CHAINS)
