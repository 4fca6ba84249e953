"""fontTools pens of the font ingest's fallback (`font.entry`): only for
outlines the native walkers do not cover (a CFF2 font, a glyph they
reject). fontTools is imported when `pen_classes` is first called, never
when this module loads.

- ``RingPen`` drives `ops.flatten.RingAccumulator`: fontTools' BasePen
  decomposes TrueType qCurveTo runs into single quadratics with implied
  on-curve midpoints (the decomposition ttf-parser performs) and the
  glyph set resolves composites with their component transforms.
- ``CurvePen`` collects the cubic-curve soup [C, 4, 2] (float64, font
  units) of the differentiable model path: lines become cubics with
  collinear control points, quadratics are degree-elevated exactly, and
  every contour is closed with a line back to its start, so that
  chord-flattening the curves gives the closed rings the SDF needs.
  `font.entry.curve_soup` builds the same soup from the native walkers'
  segments by the same rules.
"""

from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def pen_classes():
    """(RingPen, CurvePen), built on fontTools' BasePen."""
    from fontTools.pens.basePen import BasePen

    class RingPen(BasePen):
        def __init__(self, glyph_set, acc):
            super().__init__(glyph_set)
            self.acc = acc

        def _moveTo(self, pt):
            self.acc.move_to(pt[0], pt[1])

        def _lineTo(self, pt):
            self.acc.line_to(pt[0], pt[1])

        def _qCurveToOne(self, c, e):
            self.acc.quad_to(c[0], c[1], e[0], e[1])

        def _curveToOne(self, c1, c2, e):
            self.acc.cubic_to(c1[0], c1[1], c2[0], c2[1], e[0], e[1])

        def _closePath(self):
            self.acc.close_path()

        def _endPath(self):
            # Open contours don't occur in glyph outlines; the
            # accumulator closes the ring geometrically anyway.
            self.acc.close_path()

    class CurvePen(BasePen):
        def __init__(self, glyph_set):
            super().__init__(glyph_set)
            self.curves: list = []
            self._start = None

        def _line_cubic(self, s, e):
            sx, sy = s
            ex, ey = e
            c1 = (sx + (ex - sx) / 3.0, sy + (ey - sy) / 3.0)
            c2 = (sx + 2.0 * (ex - sx) / 3.0, sy + 2.0 * (ey - sy) / 3.0)
            self.curves.append((s, c1, c2, e))

        def _moveTo(self, pt):
            self._start = pt

        def _lineTo(self, pt):
            self._line_cubic(self._getCurrentPoint(), pt)

        def _qCurveToOne(self, c, e):
            s = self._getCurrentPoint()
            sx, sy = s
            cx, cy = c
            ex, ey = e
            c1 = (sx + 2.0 / 3.0 * (cx - sx), sy + 2.0 / 3.0 * (cy - sy))
            c2 = (ex + 2.0 / 3.0 * (cx - ex), ey + 2.0 / 3.0 * (cy - ey))
            self.curves.append((s, c1, c2, e))

        def _curveToOne(self, c1, c2, e):
            self.curves.append((self._getCurrentPoint(), c1, c2, e))

        def _closePath(self):
            cur = self._getCurrentPoint()
            if self._start is not None and cur is not None and cur != self._start:
                self._line_cubic(cur, self._start)

        def _endPath(self):
            self._closePath()

    return RingPen, CurvePen
