"""Traffic ``merge_dir``: each request is ``merge <every font file> -o
<a directory under TMPDIR>`` through the program's CLI in process (the
fonts merged into one glyph set, written as a tree of PBFs; the CLI
clears the directory first, so each request writes over the last).
One client, closed loop. No workload ``params``.
"""

from __future__ import annotations

import os

from glyphbench.reference import decode
from glyphbench.render_cell import RenderDriver


class Driver(RenderDriver):
    def run_request(self) -> None:
        paths = [os.path.join(self.font_dir, f.filename) for f in self.fonts]
        self.run_cli(["merge", *paths, "-o", self.out_path])

    def read_output(self) -> dict:
        return decode.read_tree(self.out_path)
