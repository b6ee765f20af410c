"""LC state trees.

Port of ``src/repro/core/state.py``:

    {"tasks": {task_name: {"theta": <scheme tree>,
                           "lam":   {param_path: tensor},   # multipliers
                           "a":     {param_path: tensor}}}, # a = Δ(Θ) scattered
     "mu": f32 0-d tensor,
     "k":  i32 0-d tensor (LC-step counter)}

``a`` and ``lam`` are stored per original parameter leaf, so the L step
never materialises the concatenated view. μ and k are 0-d tensors on the
state's device, so arithmetic with them never syncs with the host.

Where JAX donates the state to the C and multiplier steps, the port
updates ``a`` and ``lam`` in place (``LCAlgorithm.c_step`` /
``multiplier_step``): the state handed in is consumed. The *async*
entry points of the trainer's overlapped pipeline (``c_step_async`` /
``multiplier_step_async``) never write in place: the in-flight L step
still reads the previous ``a``/``lam`` through its penalty refs, so both
generations stay live until the trainer swaps its refs
(:func:`ready_probe` is how it polls the new one).
"""
from __future__ import annotations

import torch


def task_state(theta, lam: dict, a: dict) -> dict:
    return {"theta": theta, "lam": lam, "a": a}


def lc_state(tasks: dict, mu: float, k: int, device) -> dict:
    return {"tasks": tasks,
            "mu": torch.tensor(float(mu), dtype=torch.float32, device=device),
            "k": torch.tensor(int(k), dtype=torch.int32, device=device)}


def with_tasks(lc: dict, new_tasks: dict) -> dict:
    """New LC state with ``tasks`` replaced, μ/k carried through."""
    return {"tasks": new_tasks, "mu": lc["mu"], "k": lc["k"]}


def zeros_like_leaves(paths: list[str], leaves: list) -> dict:
    return {p: torch.zeros(l.shape, dtype=torch.float32, device=l.device)
            for p, l in zip(paths, leaves)}


def ready_probe(lc: dict):
    """A readiness probe for an LC state whose work is queued: on CUDA a
    ``torch.cuda.Event`` recorded on the current stream, after the work
    queued so far (the caller records it after the boundary's last
    kernel, the multiplier step's); ``None`` on the CPU, where the work
    is done when the call returns."""
    dev = lc["mu"].device
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def probe_is_ready(probe) -> bool:
    """Non-blocking: has the probed work finished?"""
    return True if probe is None else bool(probe.query())
