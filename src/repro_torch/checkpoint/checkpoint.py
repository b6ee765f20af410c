"""Checkpointing: save/restore of train-state trees.

Port of ``src/repro/checkpoint/checkpoint.py``, with its on-disk layout
(one directory per step), so a checkpoint written by either package is
read by the other:

    ckpt_dir/step_000123/
        manifest.json      # leaves: shapes, dtypes; step
        <flat::path>.npy   # one array per leaf ('/' → '::')
        _COMPLETE          # commit marker (atomicity)

* the state is copied to host memory on the calling thread, then
  written to disk on a background thread (training continues through
  the I/O); a failed background write raises from the next
  ``wait()``/``save()``;
* a directory without ``_COMPLETE`` is ignored (a crash during a write
  never corrupts restart state);
* ``keep_last`` old checkpoints are pruned after each commit;
* ``restore(template)`` rebuilds the template's tree and puts every
  leaf on the device of the template leaf it replaces.

Under an initialized ``torch.distributed`` process group of more than one
rank (data parallelism: every rank holds the same, replicated state),
rank 0 alone writes; every rank waits at a barrier once the write is
done (at the next ``save``/``wait``/``restore``, or at once for a
blocking save), and every rank restores from the same directory. Given
the model config and a mesh whose ``"model"`` axis is above 1 (a train
state split over it), ``save`` writes the whole state, gathered from
every model rank (``sharding.gather_train_state``; every rank takes
part), and ``restore`` slices the whole state it reads
(``sharding.shard_train_state``): a checkpoint restores over any
``"model"`` size, and without a mesh, as the reference's global arrays
do.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core.tasks import flatten_params
from repro_torch.distributed import sharding

_SEP = "::"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict[str, np.ndarray]:
    flat = flatten_params(state)
    return {p.replace("/", _SEP): _host(v) for p, v in flat.items()}


def _unflatten_into(template, flat: dict, prefix: str = ""):
    """Rebuild the nested structure of ``template`` from flat arrays, each
    leaf a tensor on its template leaf's device. (Recursive at module
    level: a recursive closure would hold ``flat`` in a reference
    cycle.)"""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    arr = torch.from_numpy(flat[prefix.replace("/", _SEP)])
    dev = template.device if isinstance(template, torch.Tensor) else "cpu"
    return arr.to(dev)


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _rank_world()[1] > 1:
        sharding.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True, cfg=None, mesh=None):
        self.dir = directory
        # the train state's split over "model" (None: whole)
        self._split = ((cfg, mesh) if sharding.model_size(mesh) > 1
                       else None)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "_COMPLETE")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, state, step: int, blocking: bool = False):
        # snapshot to host memory synchronously, write on the background
        # thread (rank 0 alone, under a process group)
        self.wait()
        if self._split is not None:
            state = sharding.gather_train_state(
                state, *self._split, sharding.DEFAULT_RULES)
        if _rank_world()[0] != 0:
            if blocking:
                _barrier()
            return
        flat = _flatten(state)

        def write():
            d = self._step_dir(step)
            tmp = d + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for k, v in flat.items():
                np.save(os.path.join(tmp, k + ".npy"), v)
                manifest["leaves"][k] = {
                    "shape": list(v.shape), "dtype": str(v.dtype)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
                f.write(str(time.time()))
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
            self._prune()

        if self.async_save and not blocking:
            def guarded():
                try:
                    write()
                except BaseException as e:  # surfaced by the next wait()
                    self._error = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            write()
            _barrier()

    def wait(self):
        """Wait for the write in flight (and, under a process group, for
        every rank to reach this point); raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint save failed: {e!r}") from e

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template, step: int | None = None):
        """Load a checkpoint into the structure of ``template``, each
        leaf on the device of the template leaf it replaces. Returns
        ``(state, step)``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {k: np.load(os.path.join(d, k + ".npy"))
                for k in manifest["leaves"]}
        state = _unflatten_into(template, flat)
        if self._split is not None:
            state = sharding.shard_train_state(
                state, *self._split, sharding.DEFAULT_RULES)
        return state, step
