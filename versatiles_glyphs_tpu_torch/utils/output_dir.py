"""Output directory preparation (reference:
`reference/src/utils/output_directory.rs:36-47` — destructive:
removes any existing directory, then recreates it)."""

from __future__ import annotations

import os
import shutil

from . import trace


def prepare_output_directory(path: str) -> str:
    with trace.span("writer.clear"):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
    return path
