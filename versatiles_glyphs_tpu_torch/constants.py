"""SDF rendering constants — the parity contract with the reference.

These mirror the constants documented in the reference's render module
(`reference/src/render/mod.rs:52-68`). They define the
maplibre/mapbox SDF glyph spec this framework reproduces:

- ``GLYPH_SIZE``: pixels per EM after scaling outlines.
- ``BUFFER``: pixels of SDF padding stored on every side of the content
  area (the PBF stores only 3 of the 8 radius pixels — a deliberate
  size/quality tradeoff baked into the spec).
- ``SDF_RADIUS``: distance clip in pixels; beyond it bytes saturate.
- ``CUTOFF``: the zero-crossing offset; byte ``192 = 255 - 63`` lies
  exactly on the outline.
"""

GLYPH_SIZE = 24
BUFFER = 3
SDF_RADIUS = 8.0
CUTOFF = 0.25 * 256.0

# Number of codepoints per glyph block / output PBF file
# (reference: src/font/glyph_block.rs:7).
GLYPH_BLOCK_SIZE = 256

# Squared flatness tolerance for Bezier subdivision, in *font units*
# (reference: src/render/ring_builder.rs:62 — `precision: 0.01`).
FLATTEN_TOLERANCE_SQ = 0.01

# f64 machine epsilon used by the ring-close dedup check
# (reference: src/geometry/ring.rs:53-63).
F64_EPSILON = 2.220446049250313e-16
