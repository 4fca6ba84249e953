"""Reusable host buffer arena.

A fresh large ``np.zeros`` pays a first-touch page fault for every 4K
page, which can be orders of magnitude slower than copying into a warm
buffer. Hot host paths (batch packing, tile tables) therefore draw
their large arrays from this keyed cache instead of allocating: shape
buckets (`render.batch`) keep the set of distinct shapes tiny, so each
buffer is faulted in once per process and stays warm.

Contract: a buffer returned for a key is INVALIDATED by the next
request for the same key — callers must finish consuming (e.g. copy to
device) before re-requesting. Buffers are zeroed only on first
allocation; callers own any padding they rely on.
"""

from __future__ import annotations

import numpy as np

_CACHE: dict = {}


def get_array(key: str, shape: tuple, dtype) -> np.ndarray:
    """A cached array for (key, shape, dtype); contents are arbitrary
    (previous use) except on first allocation (zeros)."""
    dtype = np.dtype(dtype)
    buf = _CACHE.get(key)
    if buf is None or buf.shape != shape or buf.dtype != dtype:
        buf = np.zeros(shape, dtype)
        _CACHE[key] = buf
    return buf


def clear() -> None:
    _CACHE.clear()
