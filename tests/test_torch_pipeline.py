"""The port's slice end to end against the JAX package, on the CPU.

The port's CLI with ``--renderer torch`` (the render session, the wire
and the kernel's plain version on the CPU) must write the same tree,
byte for byte, as the JAX CLI with ``--renderer tpu --single-thread``,
which off a TPU runs the kernel's jnp twin on the same wire. Tolerance:
none. The JAX CLI's compilation cache is pointed into the test's
temporary directory.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatiles_glyphs_tpu.cli import main as jax_main
from versatiles_glyphs_tpu.render.driver import Renderer as JaxRenderer
from versatiles_glyphs_tpu.render.metrics import prepare_glyph
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf
from versatiles_glyphs_tpu_torch.cli import main as torch_main
from versatiles_glyphs_tpu_torch.ops import sdf_cuda
from versatiles_glyphs_tpu_torch.render.driver import Renderer
from versatiles_glyphs_tpu_torch.utils.synth_font import build_ttf_curved, curved_preps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fonts(tmp_path, monkeypatch):
    monkeypatch.setenv("VG_JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    paths = []
    for name, data in (
        ("synth.ttf", build_ttf(24)),
        ("synth.otf", build_otf(24)),
        ("curved.ttf", build_ttf_curved(30, 0xF0, seed=2)),
    ):
        p = tmp_path / name
        p.write_bytes(data)
        paths.append(str(p))
    return paths


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize(
    "port_flags,jax_flags",
    [
        (["--renderer", "torch"], ["--renderer", "tpu", "--single-thread"]),
        (["--renderer", "torch", "--transport", "f32"],
         ["--renderer", "tpu", "--single-thread", "--transport", "f32"]),
        (["--dummy"], ["--dummy"]),
    ],
)
def test_merge_tree_matches_jax_cli(tmp_path, fonts, port_flags, jax_flags):
    jax_main(["merge", *fonts, "-o", str(tmp_path / "jax"), *jax_flags], stdout=io.BytesIO())
    torch_main(["merge", *fonts, "-o", str(tmp_path / "port"), *port_flags], stdout=io.BytesIO())
    want = _tree(tmp_path / "jax")
    got = _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([f for f in got if f.endswith(".pbf")]) >= 3
    for name in want:
        assert got[name] == want[name], name

    dbg_jax, dbg_port = io.StringIO(), io.StringIO()
    font_dir = next(d for d in os.listdir(tmp_path / "port") if d.startswith("synth_curved"))
    jax_main(["debug", str(tmp_path / "jax" / font_dir)], stdout=dbg_jax)
    torch_main(["debug", str(tmp_path / "port" / font_dir)], stdout=dbg_port)
    assert dbg_port.getvalue() == dbg_jax.getvalue()
    assert len(dbg_port.getvalue().splitlines()) == 1 + 30


def test_recurse_tree_matches_jax_cli(tmp_path, fonts):
    jax_main(["recurse", str(tmp_path), "-o", str(tmp_path / "jax"), "--renderer", "tpu",
              "--single-thread"], stdout=io.BytesIO())
    torch_main(["recurse", str(tmp_path), "-o", str(tmp_path / "port"), "--renderer", "torch"],
               stdout=io.BytesIO())
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want and want


def test_port_never_loads_jax(tmp_path):
    """The port's CLI and the chip smoke script in a fresh interpreter
    (this process has JAX loaded by conftest) load neither JAX nor the
    JAX package."""
    font = tmp_path / "curved.ttf"
    font.write_bytes(build_ttf_curved(6, 65, seed=4))
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from versatiles_glyphs_tpu_torch.cli import main\n"
        f"main(['merge', {str(font)!r}, '-o', {str(tmp_path / 'out')!r}, '--renderer', 'torch'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'versatiles_glyphs_tpu'))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX" in proc.stdout
    assert os.listdir(tmp_path / "out" / "synth_curved_regular") == ["0-255.pbf"]


def test_curved_ttf_preps_equal_synth_preps():
    """`chip_smoke.py` renders `curved_preps` below the font parser; the
    same outlines as a TTF, parsed by the CLI's path, give the same
    preps (metrics and the wire's point chain)."""
    from versatiles_glyphs_tpu.font.entry import FontFileEntry

    entry = FontFileEntry(build_ttf_curved(40, 32, seed=9))
    parsed = Renderer("torch").prep_block([(32 + k, entry) for k in range(40)])
    synth = curved_preps(40, 32, seed=9)
    assert len(parsed) == len(synth) == 40
    for a, b in zip(parsed, synth):
        assert (a.codepoint, a.advance, a.width, a.height, a.x0, a.y0) == (
            b.codepoint, b.advance, b.width, b.height, b.x0, b.y0)
        np.testing.assert_array_equal(a.chain16, b.chain16)
        np.testing.assert_array_equal(a.valid8, b.valid8)


def test_cuda_backend_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer("cuda")
    # "auto" is the card: the CPU backends are chosen only by name.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer("auto")
    assert not any(sdf_cuda.LAUNCHES.values())


def test_unknown_backend_and_transport():
    with pytest.raises(ValueError):
        Renderer("tpu")
    with pytest.raises(ValueError):
        Renderer("torch", transport="i4")


def _render(renderer, preps):
    s = renderer.start_session()
    s.add(preps)
    return list(s.results())


def _outlier():
    ring = np.array([(0.0, 0.0), (6000.0, 0.0), (6000.0, 6000.0), (0.0, 6000.0), (0.0, 0.0)])
    p = prepare_glyph(9999, [ring], 1000, 6000)
    assert not p.q16_ok
    return p


@pytest.mark.parametrize("transport", ["i8", "i16"])
def test_session_groups_and_aux_match_jax(monkeypatch, transport):
    """Small soft caps split the session into several groups, and a
    glyph outside the q16 range goes to the f32 aux group; bitmaps come
    back in submit order, equal to the JAX session's."""
    preps = curved_preps(9, 65, seed=6)
    mixed = preps[:4] + [_outlier()] + preps[4:]
    monkeypatch.setattr(JaxRenderer, "_LANES_SOFT", 1500)
    monkeypatch.setattr(Renderer, "_LANES_SOFT", 1500)
    want = JaxRenderer("tpu", transport=transport).render_bitmaps(mixed, parallel=False)

    r = Renderer("torch", transport=transport)
    s = r.start_session()
    for i in range(0, len(mixed), 2):
        s.add(mixed[i : i + 2])
    got = list(s.results())
    assert s.groups >= 3
    assert len(got) == len(want) == len(mixed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_session_close():
    r = Renderer("torch")
    preps = curved_preps(2, 65, seed=7)
    with r.start_session() as s:
        s.add(preps)
        assert s.groups == 0
    with pytest.raises(RuntimeError, match="closed"):
        s.add(preps)
    # A drained session closes itself.
    s = r.start_session()
    s.add(preps)
    assert len(list(s.results())) == 2
    with pytest.raises(RuntimeError, match="closed"):
        list(s.results())


def test_exact_and_zeros_backends():
    preps = curved_preps(3, 65, seed=8)
    exact = JaxRenderer("exact").render_bitmaps(preps)
    for a, b in zip(_render(Renderer("exact"), preps), exact):
        np.testing.assert_array_equal(a, b)
    for z, p in zip(_render(Renderer("zeros"), preps), preps):
        assert z.shape == (p.width * p.height,) and not z.any()
