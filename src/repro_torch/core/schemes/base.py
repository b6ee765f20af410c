"""Base class for C-step compression schemes.

Port of ``src/repro/core/schemes/base.py``. A scheme operates on a
*compressible tensor* produced by a view (``core.views``): a 1-D vector,
a 2-D matrix, or, for stacked views, one item of a stack (the engine
applies the scheme item by item, or through a batched solver).

The key contract (paper §3): decompress(compress(w, θ_prev)) is the L2
projection of ``w`` onto the scheme's feasible set — ``‖w − Δ(Θ)‖²``
must never increase across C steps (paper §7 monitors this).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

Theta = Any  # scheme-specific tree of tensors


class CompressionScheme:
    """Abstract C step: Π(w) = argmin_Θ ‖w − Δ(Θ)‖²."""

    #: "vector" | "matrix" — what the view must produce.
    domain: str = "vector"

    #: name of a batched solver in the dispatch registry
    #: (``repro_torch.kernels.dispatch``), or None — the scheme then
    #: always runs item by item. Declaring a name claims that
    #: :meth:`compress_batched` reproduces :meth:`compress` for every
    #: item of a packed stack.
    solver: str | None = None

    #: whether the engine threads a per-item sketch seed into the solves
    #: (stochastic C steps; ``CompressionTask.item_keys``): as the last
    #: solver operand, or as the ``key=`` argument of init/compress.
    wants_key: bool = False

    #: whether the batched solver partitions under plain sharding
    #: annotations (matmul/elementwise only). Kept for the contract; the
    #: port has no mesh yet, so nothing reads it.
    gspmd_safe: bool = False

    #: the parameter names, in order, that :meth:`batch_operands` binds
    #: to in the registered solver's signature
    #: (``repro_torch.kernels.dispatch.solver_signature``).
    solver_operands: tuple[str, ...] = ()

    def init(self, w: torch.Tensor, key=None) -> Theta:
        """Direct compression Θ^DC = Π(w) used to initialise the LC loop."""
        raise NotImplementedError

    def compress(self, w: torch.Tensor, theta: Theta, mu=None) -> Theta:
        """One C step, warm-started at the previous Θ. ``mu`` is used only
        by penalty-form schemes."""
        raise NotImplementedError

    def decompress(self, theta: Theta) -> torch.Tensor:
        """Δ(Θ) → dense tensor with the view's compressible shape."""
        raise NotImplementedError

    def warm_start(self, theta: Theta) -> Theta:
        """The part of the previous Θ that :meth:`compress` (and
        :meth:`compress_batched`) reads, in Θ's structure: the grouped C
        step packs only this. Leaves it does not read may be cut to
        zero width; by default it reads all of Θ."""
        return theta

    def bits(self, theta: Theta, float_bits: int = 32) -> float:
        """Storage cost of Θ in bits (compression-ratio accounting)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def group_key(self) -> tuple | None:
        """Static identity for grouped C-step dispatch (`core.grouping`):
        every hyperparameter that changes ``compress``. ``None`` opts the
        scheme out of grouping."""
        return None

    def init_key(self) -> tuple | None:
        """Static identity for grouped *init*; defaults to
        :meth:`group_key` and must add init-only hyperparameters."""
        return self.group_key()

    def batch_key(self) -> tuple | None:
        """Static identity for kernel-dispatched grouping. Defaults to
        :meth:`group_key`; a scheme that moves a hyperparameter into a
        per-item operand (:meth:`batch_operands`) drops it here."""
        return self.group_key()

    def batch_operands(self, n_items: int, device) -> tuple:
        """Per-item operand tensors (leading axis ``n_items``, on
        ``device``) passed to :meth:`compress_batched`. Default: none."""
        return ()

    def compress_batched(self, solve: Callable, w: torch.Tensor,
                         theta: Theta, operands: tuple, mu=None) -> Theta:
        """Whole-group C step: ``solve`` is the resolved implementation
        of :attr:`solver`; ``w`` is ``(n_items, *item_shape)``, ``theta``
        carries the same leading axis, ``operands`` is the
        group-concatenated :meth:`batch_operands`."""
        raise NotImplementedError

    def kernel_dispatch_ready(self) -> bool:
        """Whether the dispatch layer may replace the item-by-item
        ``compress`` with :meth:`compress_batched`.

        Needs a solver and groupable keys; ``group_key() is None`` opts
        out; and the class providing ``compress`` must also stand behind
        ``compress_batched`` (a subclass overriding only ``compress``
        would otherwise run its parent's math)."""
        if (self.solver is None or self.group_key() is None
                or self.batch_key() is None):
            return False

        def provider(name):
            for c in type(self).__mro__:
                if name in c.__dict__:
                    return c
            return None

        cp, cbp = provider("compress"), provider("compress_batched")
        return (cbp is not None and cbp is not CompressionScheme
                and cp is not None and issubclass(cbp, cp))

    # ------------------------------------------------------------------
    def distortion(self, w: torch.Tensor, theta: Theta) -> torch.Tensor:
        """‖w − Δ(Θ)‖² — the C-step objective, used by monitors/tests."""
        d = w - self.decompress(theta)
        return torch.sum(d.float() ** 2)

    @property
    def name(self) -> str:
        return type(self).__name__


# ----------------------------------------------------------------------
# Stacked-Θ packing: grouped dispatch concatenates per-task Θ trees along
# a leading item axis, solves the stack, and slices the result back.
# ----------------------------------------------------------------------
def add_leading_axis(theta: Theta) -> Theta:
    """Θ for a single item → Θ with a length-1 leading item axis."""
    return tree_map(lambda x: x[None], theta)


def drop_leading_axis(theta: Theta) -> Theta:
    """Inverse of :func:`add_leading_axis` (leading axis must be 1)."""
    return tree_map(lambda x: x[0], theta)


def pack_thetas(thetas: list[Theta]) -> Theta:
    """Concatenate Θ trees (each with a leading item axis) along axis 0."""
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *thetas)


def pack_thetas_padded(thetas: list[Theta]) -> Theta:
    """:func:`pack_thetas` with trailing-dim zero padding up to the
    per-leaf maximum, so Θs whose leaves differ in a trailing dim
    (mixed-K codebooks ``(K_i,)`` → ``(K_max,)``) pack into one batched
    solve. Each item's live entries stay in the leading slots, so
    :func:`slice_theta_like` recovers every task's own shapes."""
    def cat(*xs):
        trail = tuple(max(x.shape[1 + d] for x in xs)
                      for d in range(xs[0].ndim - 1))

        def pad(x):
            widths = [t - s for s, t in zip(x.shape[1:], trail)]
            if not any(widths):
                return x
            flat = []
            for w in reversed(widths):   # F.pad lists the last dim first
                flat += [0, w]
            return torch.nn.functional.pad(x, flat)

        return torch.cat([pad(x) for x in xs], dim=0)

    return tree_map(cat, *thetas)


def slice_theta_like(theta: Theta, like: Theta) -> Theta:
    """Undo :func:`pack_thetas_padded` for one task: slice every leaf of
    ``theta`` down to ``like``'s trailing shape."""
    return tree_map(
        lambda new, old: new[(slice(None),)
                             + tuple(slice(0, s) for s in old.shape[1:])],
        theta, like)


def unpack_thetas(packed: Theta, counts: list[int]) -> list[Theta]:
    """Split a stacked Θ back into per-task Θs of ``counts`` items."""
    out, off = [], 0
    for n in counts:
        out.append(tree_map(lambda x, o=off, n=n: x[o:o + n], packed))
        off += n
    return out


def map_items(fn: Callable, *trees) -> Theta:
    """Apply ``fn`` to each item of trees that share a leading item axis
    and stack the results: the port's ``jax.vmap`` over items. Each
    item's result is copied into the stacked output as it comes, so the
    results of all items are never held twice (at LM width an item stack
    is gigabytes)."""
    n = int(tree_leaves(trees[0])[0].shape[0])
    out = None
    for i in range(n):
        res = fn(*(tree_map(lambda x, i=i: x[i], t) for t in trees))
        if out is None:
            out = tree_map(lambda x: x.new_empty((n, *x.shape)), res)
        tree_map(lambda o, x, i=i: o[i].copy_(x), out, res)
    return out
