"""The devices and processes a render or a fit is spread over
(counterpart of `versatiles_glyphs_tpu.parallel.mesh`).

The reference's one axis of parallelism is rayon over the flat
(font, block) task list (`reference/src/font/manager.rs:102-121`). Here
it takes three forms:

- in one process, a batch is dealt over the local CUDA devices
  (`data_devices`): the render session splits it into longest-first
  bins (`render.driver.Renderer._lpt_rounds`), and each bin is one group
  on its own device and streams. There is no mesh object and no
  ``shard_map``: a bin launches at its own size, so nothing is stacked
  to a common shape;
- in one process, a fit is sharded over a list of local devices
  (`local_devices`, the counterpart of ``make_mesh(jax.devices()[:n])``):
  `models.fitting.FontFitter` gives each device an equal slice of the
  glyph batch and moves each shard's parameters there with ``.to``,
  which does the work of the JAX package's `batch_sharding` and
  `replicated` placements;
- across processes (`initialize_multihost`, `torch.distributed`), each
  process renders and writes its own disjoint share of the task list
  (`partition_tasks`), and only process 0 writes the index files. No
  bytes of a PBF cross processes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import cuda_device


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad the batch axis so it divides the mesh size (padding rows are
    zeros — glyph metas with w·h = 0 are skipped by the kernels)."""
    n = arr.shape[axis]
    rem = n % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, multiple - rem)
    return np.pad(arr, widths)


def data_devices(min_devices: int = 2, device_type: str = "cuda") -> list | None:
    """Every visible device of ``device_type`` for the render session to
    deal a batch over (counterpart of `data_mesh`), or None below
    ``min_devices``. PyTorch has one CPU device, so ``"cpu"`` gives
    None."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < min_devices:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def local_devices(n: int, device_type: str = "cuda") -> list:
    """The devices of a fit sharded ``n`` ways (counterpart of
    ``make_mesh(jax.devices()[:n])``): the first ``n`` CUDA devices, or
    every visible one where there are fewer, as that slice gives; raises
    without a CUDA device. ``"cpu"``: the one CPU device listed ``n``
    times, stand-ins for XLA's virtual CPU devices."""
    if n < 1:
        raise ValueError(f"a device list needs n >= 1, got {n}")
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    cuda_device()  # raises without one
    return [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]


def initialize_multihost(coordinator: str | None = None, **kw) -> None:
    """Join a run of several processes (no-op without a coordinator, the
    one-process case): `torch.distributed.init_process_group` at
    ``tcp://<coordinator>``, with ``num_processes`` and ``process_id``
    as the JAX package's `initialize_multihost` takes them. The backend
    is ``nccl`` where CUDA is available and ``gloo`` elsewhere, unless
    ``backend=`` names one. Nothing of a render is communicated: after
    this, `FontManager.render_glyphs` renders and writes this process's
    `partition_tasks` share, and only process 0 writes the index
    files."""
    if coordinator is None:
        return
    import torch.distributed as dist

    backend = kw.pop("backend", None) or ("nccl" if torch.cuda.is_available() else "gloo")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend,
        init_method=url,
        world_size=kw.pop("num_processes"),
        rank=kw.pop("process_id"),
        **kw,
    )


def process_count() -> int:
    """The processes of this run: the world size once
    `initialize_multihost` has run, else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank once `initialize_multihost` has run, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def partition_tasks(tasks, process_index: int, process_count: int, weights=None):
    """Deterministic per-host partition of the global (font, block) task
    list — the multi-host layer above the per-host device mesh.

    Greedy LPT: tasks sorted by descending ``weights`` (default: glyph
    count) are assigned to the currently lightest host, so host loads
    stay balanced without any cross-host communication (every host
    computes the same partition independently; the reference's rayon
    pool has no multi-process analogue, SURVEY §2.7). With real work
    weights (pixel tiles — `FontManager._host_partition` supplies them)
    the Noto Regular set balances to ≥0.95 mean/max for 2-4 hosts
    (tests/test_balance.py), supporting BASELINE.md's ≥85% scaling
    target. Returns the sub-list for ``process_index``, preserving the
    original relative order. Partitions are disjoint and their union is
    exactly ``tasks``.
    """
    if process_count <= 1:
        return list(tasks)
    if weights is None:
        weights = [len(b) for _, b in tasks]
    order = sorted(range(len(tasks)), key=lambda i: (-weights[i], i))
    loads = [0.0] * process_count
    owner = [0] * len(tasks)
    for i in order:
        h = loads.index(min(loads))
        owner[i] = h
        loads[h] += max(float(weights[i]), 1e-9)
    return [t for i, t in enumerate(tasks) if owner[i] == process_index]
