"""FontManager of the port: the JAX package's scheduler, single-process.

`versatiles_glyphs_tpu.font.manager.FontManager` reaches JAX only to
ask for the process count and index of a multi-host run
(`_host_partition`, `_is_index_host`). This subclass answers for one
process: every task is this host's, and it writes the index files.
Multi-process runs on `torch.distributed` come with a later slice.
"""

from __future__ import annotations

from versatiles_glyphs_tpu.font.manager import FontManager as HostFontManager


class FontManager(HostFontManager):
    @staticmethod
    def _host_partition(tasks, renderer=None):
        return tasks

    def _is_index_host(self) -> bool:
        return True
