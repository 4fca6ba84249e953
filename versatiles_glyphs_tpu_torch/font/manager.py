"""FontManager: the top-level render scheduler.

Mirrors `reference/src/font/manager.rs` structurally, with the
parallelism re-shaped for an accelerator: where the reference fans the
flat block task list over a rayon thread pool with a Mutex-guarded
writer (`manager.rs:102-121`), this manager batches each block into one
device call (the device's internal grid is the fine-grained
parallelism) and, with ``parallel``, deals the batch over the local
devices (`parallel.mesh.data_devices`). The writer stays host-side and
single-threaded — the same single-writer collection pattern, without
the lock. Across processes (`parallel.mesh.initialize_multihost`) each
process renders and writes its own share of the block task list.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future

from ..utils import trace
from ..utils.progress import progress_bar
from .index_files import build_font_families_json, build_index_json
from .names import name_to_id
from .wrapper import FontWrapper


class FontManager:
    def __init__(self, parallel: bool = True):
        """``parallel`` mirrors `FontManager::new(parallel)`
        (`manager.rs:28`): True deals the render over every local device
        of the backend's kind (`parallel.mesh.data_devices`); False keeps
        it on one device (the reference's ``--single-thread``)."""
        self.fonts: dict[str, FontWrapper] = {}
        self.parallel = parallel

    # -- ingestion -------------------------------------------------------

    def add_path(self, path: str) -> None:
        from .entry import FontFileEntry

        with trace.span("font.read"):
            with open(path, "rb") as f:
                data = f.read()
            try:
                file = FontFileEntry(data)
            except Exception as e:
                # Contextual error instead of a raw parser traceback (the
                # reference's anyhow context chain, `wrapper.rs:137-146`).
                raise ValueError(f"failed to parse font file {path!r}: {e}") from e
            font_id = name_to_id(file.metadata.generate_name())
            wrapper = self.fonts.get(font_id)
            if wrapper is None:
                wrapper = self.fonts[font_id] = FontWrapper()
            wrapper.add_file(file)

    def add_paths(self, paths) -> None:
        for p in paths:
            self.add_path(os.fspath(p))

    def add_font_with_name(self, name: str, sources) -> None:
        font_id = name_to_id(name)
        wrapper = self.fonts.get(font_id)
        if wrapper is None:
            wrapper = self.fonts[font_id] = FontWrapper()
        wrapper.add_paths(sources)

    # -- rendering -------------------------------------------------------

    def collect_tasks(self):
        """The global work list: (font_id, GlyphBlock) for every block
        of every font (`manager.rs:87-97`)."""
        tasks = []
        for name in self.fonts:
            for block in self.fonts[name].get_blocks():
                tasks.append((name, block))
        return tasks

    def render_glyphs(self, writer, renderer) -> None:
        """Pipelined run batching device work across ALL blocks:

        1. host prep runs on a pool of 4 threads, one future a font
           FILE (its outline walk and metrics pass), then a fontstack's
           blocks once its files are done, in a bounded window — the
           native/numpy work releases the GIL enough that the files of
           one merged fontstack overlap each other and the main
           thread's pack + device uploads (the host-side reshaping of
           the reference's rayon overlap, `manager.rs:117-121`);
        2. the main thread drains the queue into an incremental render
           session (which dispatches SMEM-sized device groups as they
           fill and starts their async fetches — uploads, kernels and
           result transfers all overlap);
        3. per-block PBF assembly + write, consuming bitmaps from the
           session in submit order — encoding block N overlaps the
           transfers of blocks > N (single host writer — the
           reference's Mutex-guarded writer without the Mutex,
           `manager.rs:102-115`).
        """
        from concurrent.futures import ThreadPoolExecutor

        from ..proto.pbf import encode_glyphs

        for name in self.fonts:
            writer.write_directory(f"{name}/")
        tasks = self.collect_tasks()
        tasks = self._host_partition(tasks, renderer)
        total = sum(len(block) for _, block in tasks)
        # The bar advances as results land: non-empty glyphs tick inside
        # the session (per fetched device group), the rest tick as their
        # block is written — summing to ``total``. Leaving the block
        # closes the session, also on an error before its results.
        with progress_bar(total) as progress, renderer.start_session(
            parallel=self.parallel, progress=progress.update
        ) as session:

            # One future per FILE (`_PrepPlan`), so the files of one
            # fontstack and of different fontstacks overlap each other and
            # the main thread's pack+upload; a fontstack's blocks are
            # prepped once its files are, and consumed in task order.
            # The numpy/native parts release the GIL.
            runs = _fontstack_runs(tasks)
            jobs = []
            # 4 workers, the JAX package's choice: the per-file prep is
            # mostly native calls that release the GIL. Not measured on
            # the port's hosts.
            with ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="vg-prep"
            ) as pool:
                # The pool's threads hang their spans under the caller's.
                plan = _PrepPlan(pool, renderer, trace.current())
                # Bounded submission window of 8 files: prepped files hold
                # their full transport caches, so on a slow device an
                # unbounded prep backlog would balloon memory on
                # thousand-font runs. A fontstack of more files than that
                # goes alone.
                from collections import deque

                window: deque = deque()
                held = ri = 0
                while window or ri < len(runs):
                    while ri < len(runs) and (
                        not window or held + len(runs[ri].files) <= 8
                    ):
                        plan.start(runs[ri])
                        window.append(runs[ri])
                        held += len(runs[ri].files)
                        ri += 1
                    run = window.popleft()
                    held -= len(run.files)
                    with trace.span("manager.prep_wait"):
                        prepped = run.done.result()
                    for block, preps in zip(run.blocks, prepped):
                        jobs.append((run.name, block, preps))
                        session.add([p for p in preps if not p.empty])
                plan.join()

            from ..proto import native

            use_native = native.available()
            bm_iter = session.results()
            for name, block, preps in jobs:
                # The encode pulls the bitmaps: its span holds the
                # session's fetch waits (and the last groups' dispatch).
                with trace.span("proto.encode"):
                    if use_native:
                        # Fused preps→PBF encode (no per-glyph PbfGlyph
                        # objects, single bitmap copy) — byte-identical to
                        # the assemble+encode pair below.
                        data = native.encode_block_from_preps(
                            name, block.range(), preps, bm_iter
                        )
                    else:
                        glyphs = renderer.assemble_glyphs(preps, bm_iter)
                        data = encode_glyphs(name, block.range(), glyphs)
                writer.write_file(f"{name}/{block.filename()}", data)
                n_nonempty = sum(1 for p in preps if not p.empty)
                progress.update(len(block) - n_nonempty)

    @staticmethod
    def _host_partition(tasks, renderer=None):
        """Multi-process block partition: after
        `parallel.mesh.initialize_multihost` each process renders and
        writes only its own disjoint task subset (`partition_tasks` by
        rank and world size) — the host-local writer rule (no PBF bytes
        ever cross processes). One process: identity.

        Partition weights are pixel-tile counts when a renderer is
        available, as the JAX package weighs them (every process preps
        every font to weigh it; glyph counts alone balance mixed-script
        sets to only ~0.8 mean/max)."""
        from ..parallel.mesh import partition_tasks, process_count, process_index

        P = process_count()
        if P <= 1:
            return tasks
        weights = None
        if renderer is not None:
            TP = 256

            def block_tiles(block):
                n = 0
                for cp, entry in block.glyph_sources():
                    p = renderer.prep_glyph(entry, cp)
                    if p is not None and not p.empty:
                        n += max(1, -(-(p.width * p.height) // TP))
                return n

            weights = [block_tiles(b) for _, b in tasks]
        return partition_tasks(tasks, process_index(), P, weights)

    # -- index files -----------------------------------------------------

    def _is_index_host(self) -> bool:
        """Only process 0 writes the run-global index files in a run of
        several processes (they are identical everywhere; writing them
        once keeps the per-process file sets disjoint)."""
        from ..parallel.mesh import process_count, process_index

        return process_count() <= 1 or process_index() == 0

    def write_index_json(self, writer) -> None:
        if not self._is_index_host():
            return
        writer.write_file("index.json", build_index_json(self.fonts.keys()))

    def write_families_json(self, writer) -> None:
        if not self._is_index_host():
            return
        writer.write_file(
            "font_families.json", build_font_families_json(self.fonts.items())
        )


def _fontstack_runs(tasks) -> list[_Run]:
    """The task list as one run a fontstack, in order of first
    appearance: runs group by font NAME, not adjacency, so a reordered
    task list never splits one fontstack."""
    runs: dict[str, _Run] = {}
    for name, block in tasks:
        run = runs.get(name)
        if run is None:
            run = runs[name] = _Run(name)
        run.blocks.append(block)
    for run in runs.values():
        files = {id(e): e for b in run.blocks for e in b.files()}
        run.files = list(files.values())
    return list(runs.values())


class _Run:
    """A fontstack's blocks (in task order), the files they draw glyphs
    from, and the future of the blocks' preps."""

    def __init__(self, name: str):
        self.name = name
        self.blocks: list = []
        self.files: list = []
        self.left = 0  # files still in prep; 0 once one failed (`_PrepPlan`'s lock)
        self.done: Future = Future()


class _PrepPlan:
    """Host prep on the pool, one future a file of a fontstack (a file
    that claims a glyph of it): the entry's outline walk and prep cores
    (span `manager.prep_file`), the file with the most codepoints first.
    The fontstack's block preps (`Renderer.prep_block`, span
    `manager.prep_font`) run on the pool thread that finishes the last
    of its files, so no pool thread waits on another and an entry's
    prep cores are built before any of its blocks reads them. An error
    reaches the fontstack's future, and `join` raises it too."""

    def __init__(self, pool, renderer, parent):
        self.pool, self.renderer, self.parent = pool, renderer, parent
        self.futures: list = []  # every submission, read by `join`
        self._lock = threading.Lock()

    def start(self, run: _Run) -> None:
        run.left = len(run.files)
        for entry in sorted(run.files, key=lambda e: -len(e.metadata.codepoints)):
            self.futures.append(self.pool.submit(self._prep_file, entry, run))

    def join(self) -> None:
        for f in self.futures:
            f.result()

    def _prep_file(self, entry, run: _Run) -> None:
        try:
            with trace.span("manager.prep_file", self.parent):
                entry.prep_cores  # built here; the block preps read it
        except BaseException as e:  # the fontstack's error too; raised again
            with self._lock:
                first, run.left = run.left > 0, 0
            if first:
                run.done.set_exception(e)
            raise
        with self._lock:
            run.left -= 1
            last = run.left == 0
        if last:
            self._prep_blocks(run)

    def _prep_blocks(self, run: _Run) -> None:
        try:
            with trace.span("manager.prep_font", self.parent):
                preps = [self.renderer.prep_block(b.glyph_sources()) for b in run.blocks]
        except BaseException as e:
            run.done.set_exception(e)
            raise
        run.done.set_result(preps)
