"""Synthetic data for the LeNet300 showcase.

Port of ``gaussian_blobs`` from ``src/repro/data/pipeline.py``. The
numbers are drawn from a seeded ``torch.Generator`` on the CPU (so they
are the same whatever the target device) and differ from the JAX
package's ``jax.random`` draws: tests that compare the two packages hand
both the same numpy arrays instead.
"""
from __future__ import annotations

import torch

from repro_torch.interop import resolve_device


def gaussian_blobs(n: int, d: int = 784, classes: int = 10,
                   sigma: float = 1.0, seed: int = 7, device=None):
    """Class-conditional Gaussians → (x (n, d) f32, y (n,) int64) on
    ``device`` (``None``: the card). Learnable to ~0 error: the MNIST
    stand-in of the LeNet300 showcase."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((classes, d), generator=g)
    y = torch.randint(0, classes, (n,), generator=g)
    x = means[y] + sigma * torch.randn((n, d), generator=g)
    return x.to(dev), y.to(dev)
