"""Device meshes over the initialized process group.

Port of ``src/repro/launch/mesh.py``. Each function builds a
``torch.distributed`` ``DeviceMesh`` (``init_device_mesh``, one process
a rank) over the default process group, which the caller initializes
(``torch.distributed.init_process_group``, or ``torchrun``'s
environment); ``make_debug_mesh`` alone sets up a one-rank group when
none exists. Meshes are CUDA meshes unless ``device_type`` says
otherwise (``"cpu"`` for ``gloo`` ranks on the CPU).
:func:`abstract_mesh` stands in for a production mesh where there are
no ranks (the dry run, ``launch/dryrun.py``): it needs no process group.
"""
from __future__ import annotations

import math


def _mesh(device_type: str, shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} "
            f"ranks; the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _require_group(what: str, device_type: str) -> None:
    """The device type is usable (a CUDA mesh raises where there is no
    card, as every entry point does) and a process group exists."""
    import torch.distributed as dist

    from repro_torch.interop import resolve_device
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: no process group: call torch.distributed."
            f"init_process_group first (or launch with torchrun)")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 × 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod. The "pod"
    axis is an outer data-parallel axis: the batch shards over ("pod",
    "data"). Raises when the process group is smaller (or larger) than
    the mesh."""
    _require_group("make_production_mesh", device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh for tests and examples. Where no process group exists
    and the mesh has one rank, this sets one up: a one-rank group in this
    process (``nccl`` for a CUDA mesh, ``gloo`` otherwise, over an
    in-memory store), which later calls reuse."""
    import torch.distributed as dist

    from repro_torch.interop import resolve_device
    resolve_device(device_type)
    if not dist.is_initialized() and math.prod(shape) == 1:
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    _require_group("make_debug_mesh", device_type)
    return _mesh(device_type, tuple(shape), tuple(axes))


def make_cstep_mesh(n_data: int | None = None, device_type: str = "cuda"):
    """A data-only mesh, ``(n_data, 1)`` over ("data", "model"), for the
    sharded grouped C step: the packed item axes shard over "data"
    (``distributed/sharding.py`` rule ``"items"``). ``n_data`` defaults
    to every rank of the process group."""
    import torch.distributed as dist
    _require_group("make_cstep_mesh", device_type)
    n = n_data if n_data is not None else dist.get_world_size()
    return _mesh(device_type, (n, 1), ("data", "model"))


def launch_mesh(shape: str, device=None):
    """``(device, mesh)`` of a CLI run over ``--mesh DATA,MODEL``
    (``shape``): under ``torchrun`` (``WORLD_SIZE`` above 1 in the
    environment) the process group comes from its environment and a CUDA
    rank takes the card of its ``LOCAL_RANK``; otherwise
    :func:`make_debug_mesh` sets up a one-rank group in this process.
    ``device`` (``None``: the card) as every entry point takes it."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.interop import resolve_device
    dev = resolve_device(device)
    sizes = tuple(int(n) for n in shape.split(","))
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        if dev.type == "cuda" and device is None:
            dev = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", "0"))
                % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, make_debug_mesh(sizes, device_type=dev.type)


class AbstractMesh:
    """A mesh of ``shape`` over ``axes`` seen from one rank, with no
    process group: what the port's sharding code reads of a
    ``DeviceMesh`` (``mesh_dim_names``, ``shape``, ``get_local_rank``,
    ``get_group``, and ``mesh[axes]._flatten().get_group()`` for a joint
    entry). Its groups are recording groups (``sharding.RecordingGroup``):
    every collective on them is recorded and issues nothing."""

    def __init__(self, shape: tuple, axes: tuple, rank: int = 0):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        n = math.prod(shape)
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        self.shape = tuple(int(d) for d in shape)
        self.mesh_dim_names = tuple(axes)
        self.rank = rank
        coords, r = [], rank
        for d in reversed(self.shape):
            coords.append(r % d)
            r //= d
        self._coords = dict(zip(self.mesh_dim_names, reversed(coords)))

    def size(self) -> int:
        return math.prod(self.shape)

    def get_local_rank(self, axis: str) -> int:
        return self._coords[axis]

    def get_group(self, axis: str | None = None):
        return self._group(self.mesh_dim_names if axis is None
                           else (axis,))

    def _group(self, axes: tuple):
        from repro_torch.distributed.sharding import RecordingGroup
        sizes = dict(zip(self.mesh_dim_names, self.shape))
        return RecordingGroup(axes, math.prod(sizes[a] for a in axes))

    def __getitem__(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return _Joint(self._group(axes))

    def __repr__(self):
        return (f"AbstractMesh(shape={self.shape}, "
                f"axes={self.mesh_dim_names}, rank={self.rank})")


class _Joint:
    """``mesh[axes]`` of an :class:`AbstractMesh`, as
    ``sharding.entry_group`` reads a joint entry:
    ``._flatten().get_group()``."""

    def __init__(self, group):
        self.group = group

    def _flatten(self):
        return self

    def get_group(self):
        return self.group


def abstract_mesh(shape: tuple, axes: tuple | None = None, rank: int = 0):
    """The mesh of ``shape`` (axes ``("data", "model")``, or ``("pod",
    "data", "model")`` for three dims) as rank ``rank`` sees it, with no
    process group (:class:`AbstractMesh`): the dry run's stand-in for the
    reference's 512 host devices. ``sharding.shard_bounds`` asserts even
    splits, so rank 0's shard shapes stand for every rank's."""
    if axes is None:
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
    return AbstractMesh(tuple(shape), tuple(axes), rank)
