"""Traffic ``recurse_tar``: each request is ``recurse <the fonts'
directory> --tar`` through the program's CLI in process, its tar stream
written over the last request's in one file under TMPDIR (a tile-server
operator's batch conversion of a font family). One client, closed loop.
No workload ``params``.
"""

from __future__ import annotations

from glyphbench.reference import decode
from glyphbench.render_cell import RenderDriver


class Driver(RenderDriver):
    OUT_SUFFIX = ".tar"

    def run_request(self) -> None:
        with open(self.out_path, "wb") as out:
            self.run_cli(["recurse", self.font_dir, "--tar"], stdout=out)

    def read_output(self) -> dict:
        with open(self.out_path, "rb") as f:
            return decode.read_tar(f.read())
