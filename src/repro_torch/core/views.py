"""Compression views (paper §5, "compression tasks").

Port of ``src/repro/core/views.py``. A view adapts a subset of model
parameters to the array a scheme expects and scatters the decompressed
result back:

* ``AsVector``  — flatten + concatenate all selected leaves into one 1-D
  vector (one codebook shared across several layers).
* ``AsIs``      — a single 2-D leaf used directly as a matrix.
* ``AsMatrix``  — a single leaf reshaped to 2-D (merge all but last dim).
* ``AsStacked`` — a single leaf with ``stack_ndim`` leading stack axes
  (scanned layer or expert stacks); each stack entry is one *item* with
  its own Θ. ``domain`` says whether an item is flattened ("vector") or
  kept as a matrix ("matrix").

Views only reshape: ``from_compressible(to_compressible(x)) == x``. A
compressible array may be a view of the parameter storage; callers that
keep it past the next parameter update must copy it.
"""
from __future__ import annotations

import math

import torch


class View:
    #: whether the compressible array carries a leading item (stack) axis
    stacked: bool = False

    def to_compressible(self, leaves: list[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def from_compressible(self, arr: torch.Tensor,
                          templates: list) -> list[torch.Tensor]:
        raise NotImplementedError

    # ---- item protocol (grouped C step, `core.grouping`) ----
    def to_items(self, arr: torch.Tensor) -> torch.Tensor:
        """Compressible array → (n_items, *item_shape)."""
        return arr if self.stacked else arr[None]

    def from_items(self, items: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_items`."""
        return items if self.stacked else items[0]

    def item_count(self, arr) -> int:
        return int(arr.shape[0]) if self.stacked else 1

    def item_shape(self, arr) -> tuple:
        return tuple(arr.shape[1:]) if self.stacked else tuple(arr.shape)


class AsVector(View):
    def to_compressible(self, leaves):
        return torch.cat([l.reshape(-1).float() for l in leaves])

    def from_compressible(self, arr, templates):
        out, off = [], 0
        for t in templates:
            n = math.prod(t.shape)
            out.append(arr[off:off + n].reshape(t.shape).to(t.dtype))
            off += n
        return out


class AsIs(View):
    def to_compressible(self, leaves):
        assert len(leaves) == 1, "AsIs views exactly one parameter"
        (l,) = leaves
        assert l.ndim == 2, f"AsIs needs a 2-D matrix, got {tuple(l.shape)}"
        return l.float()

    def from_compressible(self, arr, templates):
        return [arr.reshape(templates[0].shape).to(templates[0].dtype)]


class AsMatrix(View):
    """Reshape one leaf to (prod(leading dims), last dim)."""

    def to_compressible(self, leaves):
        assert len(leaves) == 1, "AsMatrix views exactly one parameter"
        (l,) = leaves
        return l.reshape(-1, l.shape[-1]).float()

    def from_compressible(self, arr, templates):
        return [arr.reshape(templates[0].shape).to(templates[0].dtype)]


class AsStacked(View):
    """Leading axes = stack (layers/experts); one item per stack entry.

    ``stack_ndim`` merges that many leading axes into the stack: a
    scanned MoE leaf ``(L, E, m, n)`` with ``stack_ndim=2`` becomes
    ``L·E`` items.
    """

    stacked = True

    def __init__(self, domain: str = "vector", stack_ndim: int = 1):
        assert domain in ("vector", "matrix")
        assert stack_ndim >= 1
        self.domain = domain
        self.stack_ndim = int(stack_ndim)

    def to_compressible(self, leaves):
        assert len(leaves) == 1, "AsStacked views exactly one parameter"
        (l,) = leaves
        k = self.stack_ndim
        assert l.ndim >= k + 1, \
            f"AsStacked(stack_ndim={k}) needs ndim>{k}, got {tuple(l.shape)}"
        n = math.prod(l.shape[:k])
        if self.domain == "vector":
            return l.reshape(n, -1).float()
        return l.reshape(n, -1, l.shape[-1]).float()

    def from_compressible(self, arr, templates):
        return [arr.reshape(templates[0].shape).to(templates[0].dtype)]
