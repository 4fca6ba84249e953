"""Render fitted outlines into a glyph atlas (counterpart of
`versatiles_glyphs_tpu.models.render_fitted.render_fitted_pbfs`).

`fitted_prep` and `fitted_preps` are the JAX package's own functions
(float64 Bernstein chains of the fitted control points → `GlyphPrep`s
with the reference's integer metrics); that module is free of JAX and
of fontTools at import time, so they are reused by import. What differs
is the renderer: the port's `Renderer` and its render session.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from versatiles_glyphs_tpu.models.render_fitted import fitted_preps


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def render_fitted_pbfs(
    params,
    batch,
    entry,
    depth: int,
    out_dir: str,
    fontstack_name: str,
    renderer=None,
) -> list[str]:
    """Render fitted glyphs into a complete atlas under ``out_dir``:
    ``{fontstack_name}/{start}-{end}.pbf`` blocks plus ``index.json``
    and ``font_families.json``, the tree `recurse`/`merge` write.

    ``params``: tensors or numpy arrays under ``curves``/``translate``;
    ``batch``: the `FitBatch` they were fitted on; ``entry``: the source
    font (advances, units per EM, metadata); ``renderer``: a port
    `Renderer` (default ``"auto"``). Returns the block file names."""
    from versatiles_glyphs_tpu.font.index_files import build_font_families_json, build_index_json
    from versatiles_glyphs_tpu.proto.pbf import encode_glyphs
    from versatiles_glyphs_tpu.writer import Writer

    from ..render.driver import Renderer

    if renderer is None:
        renderer = Renderer("auto")
    host = {k: _host(params[k]) for k in ("curves", "translate")}
    preps = fitted_preps(host, batch, entry, depth)
    bitmaps = renderer.render_bitmaps([p for p in preps if not p.empty])
    glyphs = Renderer.assemble_glyphs(preps, iter(bitmaps))

    blocks: dict[int, list] = {}
    for g in glyphs:
        blocks.setdefault(g.id // 256, []).append(g)

    os.makedirs(out_dir, exist_ok=True)
    writer = Writer.new_file(os.path.abspath(out_dir))
    writer.write_directory(f"{fontstack_name}/")
    written = []
    for s in sorted(blocks):
        rng = f"{s * 256}-{s * 256 + 255}"
        pbf = encode_glyphs(fontstack_name, rng, blocks[s])
        writer.write_file(f"{fontstack_name}/{rng}.pbf", pbf)
        written.append(f"{rng}.pbf")
    writer.write_file("index.json", build_index_json([fontstack_name]))

    class _Wrap:  # build_font_families_json expects (id, wrapper)
        @staticmethod
        def get_metadata():
            return entry.metadata

    writer.write_file("font_families.json", build_font_families_json([(fontstack_name, _Wrap)]))
    writer.finish()
    return written
