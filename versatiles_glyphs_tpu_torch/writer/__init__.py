"""Output writers: directory tree, streamed tar, in-memory dummy.

Facade + three backends mirroring `reference/src/writer/`
(mod.rs, file.rs, tar.rs, dummy.rs). The facade is what the render
scheduler holds; `finish()` is idempotent and a destructor warning
backs it up, matching the reference's best-effort Drop.
"""

from __future__ import annotations

import os
import re
import sys

from ..utils import trace
from .tar import TarWriter

__all__ = ["Writer", "FileWriter", "TarWriter", "DummyWriter"]


class FileWriter:
    """Writes files under a root directory
    (`reference/src/writer/file.rs`)."""

    def __init__(self, root: str):
        self.root = root

    def write_file(self, file_name: str, data: bytes) -> None:
        path = os.path.join(self.root, file_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def write_directory(self, dir_name: str) -> None:
        os.makedirs(os.path.join(self.root, dir_name), exist_ok=True)

    def finish(self) -> None:
        pass

    def get_inner(self):
        return None


_JSON_WS = re.compile(r"\n\s*")


class DummyWriter:
    """In-memory capture for tests (`src/writer/dummy.rs`): `.json`
    files recorded with whitespace-condensed content, others as
    ``name (len)``."""

    def __init__(self):
        self.data: list[str] = []

    def write_file(self, file_name: str, data: bytes) -> None:
        if file_name.endswith(".json"):
            content = _JSON_WS.sub("", data.decode("utf-8"))
            self.data.append(f"{file_name}: {content}")
        else:
            self.data.append(f"{file_name} ({len(data)})")

    def write_directory(self, dir_name: str) -> None:
        self.data.append(dir_name)

    def finish(self) -> None:
        pass

    def get_inner(self):
        return self.data


class Writer:
    """Facade over a boxed backend (`src/writer/mod.rs:22-97`)."""

    def __init__(self, backend):
        self._backend = backend
        self._finished = False

    @classmethod
    def new_file(cls, root: str) -> "Writer":
        return cls(FileWriter(root))

    @classmethod
    def new_tar(cls, stream) -> "Writer":
        return cls(TarWriter(stream))

    @classmethod
    def new_dummy(cls) -> "Writer":
        return cls(DummyWriter())

    def write_file(self, file_name: str, data: bytes) -> None:
        with trace.span("writer.write"):
            self._backend.write_file(file_name, data)

    def write_directory(self, dir_name: str) -> None:
        self._backend.write_directory(dir_name)

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self._backend.finish()

    def get_inner(self):
        return self._backend.get_inner()

    def __del__(self):
        if not getattr(self, "_finished", True):
            try:
                self.finish()
                print("warning: writer was not finished explicitly", file=sys.stderr)
            except Exception:
                pass
