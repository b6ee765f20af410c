"""Compression tasks: (parameter selector) → (view, scheme).

Port of ``src/repro/core/tasks.py``. Parameters live in a nested dict of
tensors, so the selector is a regex over slash-joined paths (``l0/w``),
matching the same paths as the JAX package.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.schemes.base import CompressionScheme, map_items
from repro_torch.core.views import View


def flatten_params(params) -> dict[str, Any]:
    """Nested dict → {'a/b/c': leaf} with deterministic (sorted) order."""
    flat = {}
    _flatten_into(params, "", flat)
    return flat


def _flatten_into(node, prefix: str, flat: dict) -> None:
    # a module-level function: a recursive closure would keep itself and
    # ``flat`` (every leaf) in a reference cycle, alive until the cyclic
    # GC runs, which device memory does not trigger
    if isinstance(node, dict):
        for k in sorted(node.keys()):
            _flatten_into(node[k], f"{prefix}/{k}" if prefix else str(k),
                          flat)
    else:
        flat[prefix] = node


def set_path(params, path: str, value):
    """Set a slash path in a nested dict, copying the dicts on the way
    (the leaves are shared, the input tree is left as it was)."""
    keys = path.split("/")
    node = dict(params)
    cursor = node
    for k in keys[:-1]:
        cursor[k] = dict(cursor[k])
        cursor = cursor[k]
    cursor[keys[-1]] = value
    return node


def get_path(params, path: str):
    node = params
    for k in path.split("/"):
        node = node[k]
    return node


@dataclass
class CompressionTask:
    """One entry of the compression-tasks structure."""

    name: str
    pattern: str                      # regex matched with re.search on paths
    view: View
    scheme: CompressionScheme
    # resolved lazily against a concrete params tree:
    paths: list[str] = field(default_factory=list)

    def resolve(self, params) -> "CompressionTask":
        flat = flatten_params(params)
        rx = re.compile(self.pattern)
        paths = [p for p in flat if rx.search(p)]
        if not paths:
            raise ValueError(
                f"task {self.name!r}: pattern {self.pattern!r} matched no "
                f"parameters; available: {sorted(flat)[:20]}...")
        return CompressionTask(self.name, self.pattern, self.view,
                               self.scheme, paths)

    def leaves(self, params) -> list:
        return [get_path(params, p) for p in self.paths]

    def compressible(self, params):
        """x = view(w) — the array the scheme projects."""
        return self.view.to_compressible(self.leaves(params))

    def shifted_compressible(self, params, task_state, mu):
        """x = view(w − λ/μ) — the C-step input (paper Fig. 2)."""
        leaves = self.leaves(params)
        shifted = [l.float() - task_state["lam"][p] / mu
                   for p, l in zip(self.paths, leaves)]
        return self.view.to_compressible(
            [s.to(l.dtype) for s, l in zip(shifted, leaves)])

    def scatter_decompressed(self, a_arr, params) -> dict:
        """Δ(Θ) in compressible shape → {path: f32 leaf} (the ``a`` refs)."""
        a_leaves = self.view.from_compressible(a_arr, self.leaves(params))
        return {p: l.float() for p, l in zip(self.paths, a_leaves)}

    def group_signature(self, x, batched: bool = False) -> tuple | None:
        """Hashable grouping signature, or None when not groupable.

        Only ``x.shape``/``x.dtype`` are read. With ``batched=True``
        (kernel dispatch active) a :meth:`CompressionScheme.
        kernel_dispatch_ready` scheme groups by its ``batch_key()``:
        hyperparameters the batched solver takes as per-item operands (κ,
        K) drop out, so mixed-κ and mixed-K tasks share one launch.
        """
        if batched and self.scheme.kernel_dispatch_ready():
            key = ("batched", self.scheme.solver, self.scheme.batch_key())
        else:
            key = self.scheme.group_key()
        if key is None:
            return None
        # the scheme class is part of the identity: a subclass overriding
        # compress() but inheriting group_key() must not merge with its
        # parent (the group runs ONE scheme instance for all members)
        return (type(self.scheme).__qualname__, key,
                self.view.item_shape(x), str(x.dtype))

    # ---- per-item sketch seeds (stochastic C steps) -------------------
    def item_keys(self, n_items: int) -> torch.Tensor:
        """(n_items,) int64 seeds for schemes with ``wants_key``, on the
        CPU.

        Derived from the *task name* (``crc32 & 0x7FFFFFFF``, as the JAX
        package derives its base key) and the within-task item index, so
        the seeds are the same on the grouped and per-task paths,
        deterministic across reruns, and distinct for every item: no two
        items share a randomized-SVD sketch. A torch generator cannot
        reproduce JAX's ``fold_in`` keys, so the sketches themselves
        differ between the packages; each item draws its sketch from a
        ``torch.Generator`` seeded with its seed."""
        base = zlib.crc32(self.name.encode("utf-8")) & 0x7FFFFFFF
        return base * (1 << 32) + torch.arange(n_items, dtype=torch.int64)

    # ---- scheme application, item by item when the view is stacked ----
    def scheme_init(self, x):
        if self.scheme.wants_key:
            keys = self.item_keys(self.view.item_count(x))
            if self.view.stacked:
                return map_items(
                    lambda xi, ki: self.scheme.init(xi, key=ki), x, keys)
            return self.scheme.init(x, key=keys[0])
        if self.view.stacked:
            return map_items(self.scheme.init, x)
        return self.scheme.init(x)

    def scheme_compress(self, x, theta, mu):
        if self.scheme.wants_key:
            keys = self.item_keys(self.view.item_count(x))
            if self.view.stacked:
                return map_items(
                    lambda xi, ti, ki: self.scheme.compress(
                        xi, ti, mu=mu, key=ki), x, theta, keys)
            return self.scheme.compress(x, theta, mu=mu, key=keys[0])
        if self.view.stacked:
            return map_items(
                lambda xi, ti: self.scheme.compress(xi, ti, mu=mu), x, theta)
        return self.scheme.compress(x, theta, mu=mu)

    def scheme_decompress(self, theta):
        if self.view.stacked:
            return map_items(self.scheme.decompress, theta)
        return self.scheme.decompress(theta)


def check_disjoint(tasks: list[CompressionTask]):
    """Each parameter may belong to at most one task."""
    seen: dict[str, str] = {}
    for t in tasks:
        for p in t.paths:
            if p in seen:
                raise ValueError(
                    f"parameter {p} claimed by tasks {seen[p]!r} and "
                    f"{t.name!r}; use AdditiveCombination for multi-scheme")
            seen[p] = t.name
    return True
