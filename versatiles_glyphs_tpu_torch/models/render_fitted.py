"""Render fitted outlines into a glyph atlas (counterpart of
`versatiles_glyphs_tpu.models.render_fitted.render_fitted_pbfs`).

The fitted model's geometry is the fixed-depth De Casteljau chain of
its cubic control points (`models.glyph_model.curves_to_segments`);
`fitted_prep` evaluates the same chain in float64 (the Bernstein rows at
the dyadic parameters, exact at t=0/1) into `GlyphPrep`s with the
reference's integer metrics, so the rendered outline is the model's
polyline, not a re-flattening. The atlas goes through the same render
session and PBF encode as `recurse`/`merge`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import BUFFER, GLYPH_SIZE
from ..render.metrics import GlyphPrep, _round_half_away


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _bernstein_f64(depth: int) -> np.ndarray:
    """[K, 4] float64 Bernstein evaluation matrix at the K = 2^depth+1
    dyadic parameters (twin of `fitting._bernstein_matrix`, kept in f64
    so chain endpoints equal the control points bitwise and consecutive
    curves sharing control points join watertight)."""
    K = (1 << depth) + 1
    t = np.arange(K, dtype=np.float64) / (K - 1)
    return np.stack(
        [(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t**3],
        axis=1,
    )


def fitted_prep(
    codepoint: int,
    curves: np.ndarray,
    translate: np.ndarray,
    depth: int,
    advance_units: float,
    units_per_em: int,
) -> GlyphPrep:
    """One `GlyphPrep` from fitted parameters.

    ``curves`` [C, 4, 2] are the glyph's LIVE control points in pixel
    space (the fit initialized them scaled + dx-shifted,
    `fitting.make_fit_batch`); ``translate`` [2] is the fitted
    placement. Metrics re-derive from the fitted geometry with the
    reference's exact integer arithmetic (floor/ceil bbox ± BUFFER,
    `renderer.rs:64-91`); advance comes from the source font (fitting
    moves outlines, not horizontal metrics)."""
    scale = float(GLYPH_SIZE) / float(units_per_em)
    advance_float = float(advance_units) * scale * 0.95
    advance = _round_half_away(advance_float)
    dx = (float(advance) - advance_float) / 2.0

    c = np.asarray(curves, np.float64)
    if c.shape[0] == 0:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)
    c = c + np.asarray(translate, np.float64)[None, None, :]

    M = _bernstein_f64(depth)
    chain = np.einsum("kj,cjd->ckd", M, c)  # [C, K, 2]

    # Merge consecutive curves whose endpoints join bitwise into one
    # chain (halves device lanes vs one chain per curve; the Bernstein
    # rows at t=0/1 are exact, so curves that shared control points
    # before fitting still share them after — the optimizer moves the
    # shared point once).
    rings: list[np.ndarray] = []
    cur = [chain[0]]
    for i in range(1, chain.shape[0]):
        if np.array_equal(cur[-1][-1], chain[i][0]):
            cur.append(chain[i][1:])
        else:
            rings.append(np.concatenate(cur, axis=0))
            cur = [chain[i]]
    rings.append(np.concatenate(cur, axis=0))

    pts = chain.reshape(-1, 2)
    min_x = float(pts[:, 0].min())
    min_y = float(pts[:, 1].min())
    max_x = float(pts[:, 0].max())
    max_y = float(pts[:, 1].max())
    # BBox::is_empty semantics (`src/geometry/bbox.rs:56`).
    if max_x <= min_x and max_y <= min_y:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)

    x0 = int(np.floor(min_x)) - BUFFER
    y0 = int(np.floor(min_y)) - BUFFER
    x1 = int(np.ceil(max_x)) + BUFFER
    y1 = int(np.ceil(max_y)) + BUFFER
    return GlyphPrep(
        codepoint=codepoint,
        advance=advance,
        dx=dx,
        empty=False,
        width=x1 - x0,
        height=y1 - y0,
        x0=x0,
        y0=y0,
        x1=x1,
        y1=y1,
        rings_px=rings,
    )


def fitted_preps(params, batch, entry, depth: int) -> list[GlyphPrep]:
    """GlyphPreps for every fitted glyph of a batch.

    ``params`` is the (host-fetched) parameter dictionary from
    `FontFitter`; ``batch`` the `FitBatch` it was fitted on (supplies
    ``curve_mask`` and ``codepoints``); ``entry`` the source
    `FontFileEntry` (advance metrics)."""
    curves = np.asarray(params["curves"], np.float64)
    translate = np.asarray(params["translate"], np.float64)
    cps = batch.codepoints
    if cps is None:
        raise ValueError("FitBatch.codepoints missing (rebuild the batch)")
    # The params batch may be padded beyond the caller's batch (and
    # cps): iterate the common prefix and skip all-False mask rows
    # (padding) so both shapes are accepted.
    B = min(curves.shape[0], len(cps), batch.curve_mask.shape[0])
    preps = []
    for b in range(B):
        mask = batch.curve_mask[b]
        if not mask.any():
            continue  # padding row / empty glyph
        cp = int(cps[b])
        name = entry.glyph_name(cp)
        adv_units = entry.hor_advance(name) if name is not None else 0
        preps.append(
            fitted_prep(
                cp,
                curves[b][mask],
                translate[b],
                depth,
                adv_units,
                entry.units_per_em,
            )
        )
    return preps


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
    from ..font.index_files import build_font_families_json, build_index_json
    from ..proto.pbf import encode_glyphs
    from ..render.driver import Renderer
    from ..writer import Writer

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
