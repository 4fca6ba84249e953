"""Adam's update for the fitter: one launch of ``csrc/adam_flat.cu`` over
every leaf on a CUDA device, its plain version on the CPU.

`adam_step` takes the place of ``opt.step()`` for a `torch.optim.Adam`
``opt``: it reads lr, betas and eps from ``opt.param_groups``, keeps the
state where and as `torch.optim.Adam` keeps it (a CPU ``step`` tensor,
``exp_avg`` and ``exp_avg_sq`` in ``opt.state``, made as zeros at the
first step), and computes the single-tensor formula of
`torch.optim.Adam` in f32, each operation rounded once
(`adam_update_plain`). So checkpoints, `models.fitting.adam_state_from_optax`
and ``exp_avg`` readers work as with ``opt.step()``. On the CPU it agrees
with ``opt.step()`` to a few ulps (ATen's CPU lerp fuses its multiply-add);
on the card the kernel gives the plain version's bits.

Options it does not compute raise (amsgrad, maximize, weight decay,
capturable, fused, differentiable, a dtype other than f32, a sparse
gradient): nothing falls back to ``opt.step()``. The launches count in
`ops.sdf_cuda.LAUNCHES` under ``adam_flat``.
"""

from __future__ import annotations

import numpy as np
import torch

# Leaves one launch updates (kMaxLeaves of the source); more take more
# launches.
MAX_LEAVES = 8
# Bytes an element moves: p, g, m and v read, p, m and v written.
BYTES_PER_ELEMENT = 28
# f32 operations an element (sub, mul, add for the lerp; three mul and an
# add for v; sqrt, div, add; mul, div, add for p).
OPS_PER_ELEMENT = 13

_UNSUPPORTED = ("amsgrad", "maximize", "capturable", "fused", "differentiable",
                "decoupled_weight_decay")


def _check_group(group: dict) -> None:
    on = [k for k in _UNSUPPORTED if group.get(k)]
    if on or group.get("weight_decay", 0) != 0:
        raise ValueError(
            f"adam_step computes plain Adam only: {on or ['weight_decay']} is set")


def _state_of(opt: torch.optim.Adam, p: torch.Tensor) -> dict:
    """``p``'s state, made as `torch.optim.Adam` makes it at a first step."""
    state = opt.state[p]
    if not state:
        dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        state["step"] = torch.tensor(0.0, dtype=dtype)
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def step_scalars(lr: float, betas, eps: float, step: float) -> np.ndarray:
    """The update's seven f32 scalars at ``step`` (counted from 1), from
    doubles as `torch.optim.Adam` computes them: w = 1 − β1 and 1 − w
    (the lerp's weight and, in f32, its complement), β2, 1 − β2,
    sqrt(1 − β2^step), eps and −lr / (1 − β1^step)."""
    beta1, beta2 = (float(b) for b in betas)
    bias_correction1 = 1 - beta1**step
    bias_correction2 = 1 - beta2**step
    w = np.float32(1 - beta1)
    return np.array([w, np.float32(1) - w, beta2, 1 - beta2, bias_correction2**0.5, eps,
                     -(float(lr) / bias_correction1)], np.float32)


def adam_update_plain(p, g, m, v, scalars) -> None:
    """The kernel's arithmetic in torch ops, in place on ``p``, ``m`` and
    ``v`` (f32 tensors of one shape, on any device): each operation is
    one f32 rounding, as the kernel's intrinsics (the square root taken
    in f64 and rounded once, `sdf_torch.sqrt_rn`)."""
    from .sdf_torch import sqrt_rn

    w, omw, b2, c2, bc2s, eps, ns = (torch.tensor(float(s), dtype=torch.float32, device=p.device)
                                     for s in scalars)
    d = g - m
    m.copy_(m + w * d if abs(float(scalars[0])) < 0.5 else g - d * omw)
    v.copy_(v * b2 + (c2 * g) * g)
    p.copy_(p + (ns * m) / (sqrt_rn(v) / bc2s + eps))


def _launch(leaves: list, device: torch.device) -> None:
    """One kernel launch over ``leaves`` [(p, g, m, v, scalars)]."""
    from .sdf_cuda import _launch as launch

    ptrs = np.array([t.data_ptr() for p, g, m, v, _ in leaves for t in (p, g, m, v)], np.uint64)
    counts = np.array([p.numel() for p, *_ in leaves], np.int64)
    scalars = np.concatenate([s for *_, s in leaves])
    launch("adam_flat", device, len(leaves), ptrs.ctypes.data, counts.ctypes.data,
           scalars.ctypes.data)


def adam_step(opt: torch.optim.Adam) -> None:
    """One step of ``opt`` (a `torch.optim.Adam`) on the parameters that
    have a ``.grad``: the CUDA ones in one launch a device (up to
    `MAX_LEAVES` leaves a launch), the CPU ones through
    `adam_update_plain`. Every parameter is checked before any state
    changes."""
    todo = []
    for group in opt.param_groups:
        _check_group(group)
        for p in group["params"]:
            g = p.grad
            if g is None:
                continue
            if p.dtype != torch.float32 or g.dtype != torch.float32 or g.is_sparse:
                raise ValueError(f"adam_step takes dense f32 parameters and gradients, got "
                                 f"{p.dtype} and {g.dtype}{' sparse' if g.is_sparse else ''}")
            if p.device.type not in ("cpu", "cuda") or g.device != p.device:
                raise ValueError(f"a parameter on {p.device} with its gradient on {g.device}")
            state = opt.state.get(p, {})
            written = [p] + [state[k] for k in ("exp_avg", "exp_avg_sq") if k in state]
            if not all(t.is_contiguous() for t in written):
                raise ValueError("adam_step updates contiguous parameters and state in place")
            todo.append((group, p, g))
    by_device: dict = {}
    scalars_at: dict = {}  # (group, step) -> scalars: the leaves of a group share them
    for group, p, g in todo:
        state = _state_of(opt, p)
        state["step"] += 1
        key = (id(group), state["step"].item())
        if key not in scalars_at:
            scalars_at[key] = step_scalars(group["lr"], group["betas"], group["eps"], key[1])
        by_device.setdefault(p.device, []).append(
            (p, g.contiguous(), state["exp_avg"], state["exp_avg_sq"], scalars_at[key]))
    for device, leaves in by_device.items():
        if device.type == "cpu":
            with torch.no_grad():
                for p, g, m, v, scalars in leaves:
                    adam_update_plain(p, g, m, v, scalars)
        else:
            for i in range(0, len(leaves), MAX_LEAVES):
                _launch(leaves[i : i + MAX_LEAVES], device)
