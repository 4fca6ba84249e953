"""The CUDA device the port renders on.

Counterpart of `versatiles_glyphs_tpu.utils.device.on_tpu`. There is
no CPU fallback here: a caller that asks for the card and finds none
gets an error. Code that runs on the CPU asks for
``torch.device("cpu")`` explicitly.
"""

from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """``torch.device("cuda", 0)``; raises when no CUDA device is
    visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", 0)
