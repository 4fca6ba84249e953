"""Progress reporting to stderr (reference:
`reference/src/utils/progress_bar.rs` — indicatif bar, hidden
under tests). Auto-hides when stderr is not a TTY or under pytest."""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager


class _Bar:
    def __init__(self, total: int, enabled: bool):
        self.total = max(total, 1)
        self.pos = 0
        self.enabled = enabled
        self.start = time.time()
        self._last_draw = 0.0

    def update(self, n: int) -> None:
        self.pos += n
        if not self.enabled:
            return
        now = time.time()
        if now - self._last_draw < 0.1 and self.pos < self.total:
            return
        self._last_draw = now
        frac = min(self.pos / self.total, 1.0)
        width = 40
        filled = int(frac * width)
        elapsed = now - self.start
        eta = elapsed / frac - elapsed if frac > 0 else 0.0
        sys.stderr.write(
            f"\r[{'#' * filled}{'-' * (width - filled)}] "
            f"{self.pos}/{self.total} eta {eta:6.1f}s"
        )
        sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            sys.stderr.write("\n")
            sys.stderr.flush()


@contextmanager
def progress_bar(total: int):
    enabled = sys.stderr.isatty() and "PYTEST_CURRENT_TEST" not in os.environ
    bar = _Bar(total, enabled)
    try:
        yield bar
    finally:
        bar.finish()
