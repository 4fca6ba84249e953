"""The benchmark's own tests: ``python -m pytest glyphbench/tests -q``
from the root of the checkout. Tests marked ``chip`` need a CUDA
device; each decides inside itself and skips without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def program_on_the_cpu(monkeypatch):
    """The program on the CPU: the CLI's default renderer the plain torch
    one, and the fitter's default device the CPU."""
    import torch
    from versatiles_glyphs_tpu_torch import cli
    from versatiles_glyphs_tpu_torch.models import fitting

    orig = cli.Renderer
    monkeypatch.setattr(cli, "Renderer",
                        lambda backend="auto", **kw: orig("torch" if backend == "auto" else backend,
                                                          **kw))
    monkeypatch.setattr(fitting, "cuda_device", lambda: torch.device("cpu"))
