"""The paper's LeNet300 showcase: the harness the quickstart runs.

Port of ``benchmarks/common.py``. LeNet300 is the 784→300→100→10 tanh
MLP; the data are class-conditional Gaussians (``data.gaussian_blobs``),
learnable to ~0 error like MNIST for LeNet300. The L step is the paper's
Listing 2: SGD with Nesterov momentum on the cross-entropy plus the LC
penalty.

The entry points (``reference_problem``, ``run_lc``, ``direct_compress``)
run on ``device``: ``None`` means the card, and they raise when CUDA is
absent. They switch TF32 off (:func:`full_fp32_matmuls`), so the L
step's float32 matmuls run in full float32 on the card.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.core import (
    AsVector, CompressionTask, LCAlgorithm, flatten_params)
from repro_torch.data import gaussian_blobs
from repro_torch.interop import resolve_device

DIMS = (784, 300, 100, 10)


def full_fp32_matmuls() -> None:
    """Run float32 matmuls and convolutions in full float32 on the card:
    TF32 keeps about three decimal digits, too few to hold the port
    against the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_mlp(generator: torch.Generator, dims=DIMS, device=None) -> dict:
    """{"l{i}": {"w": (in, out), "b": (out,)}} with w ~ N(0, 1/in); drawn
    on the CPU from ``generator``, then moved to ``device`` (``None``:
    the card, as every entry point)."""
    device = resolve_device(device)
    p = {}
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator)
        p[f"l{i}"] = {"w": (w / math.sqrt(dims[i])).to(device),
                      "b": torch.zeros((dims[i + 1],), device=device)}
    return p


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    n = len(params)
    for i in range(n):
        h = h @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n - 1:
            h = torch.tanh(h)
    return h


class LeNet300(nn.Module):
    """The tanh MLP (784-300-100-10 for LeNet300) as an ``nn.Module``
    whose weights keep the JAX layout ``(in, out)``. :meth:`tree` gives
    its parameters as the ``l{i}/w``, ``l{i}/b`` tree the LC tasks
    address; the tensors are the module's own parameters."""

    def __init__(self, params: dict):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(len(params)):
            layer = nn.Module()
            layer.w = nn.Parameter(params[f"l{i}"]["w"].detach().clone())
            layer.b = nn.Parameter(params[f"l{i}"]["b"].detach().clone())
            self.layers.append(layer)

    def tree(self) -> dict:
        return {f"l{i}": {"w": l.w, "b": l.b}
                for i, l in enumerate(self.layers)}

    def forward(self, x):
        return mlp_apply(self.tree(), x)


def ce_loss(params: dict, x, y) -> torch.Tensor:
    logits = mlp_apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(logp[torch.arange(y.numel(), device=y.device),
                            y.long()])


@torch.no_grad()
def error_rate(params: dict, x, y) -> float:
    pred = torch.argmax(mlp_apply(params, x), dim=-1)
    return float(torch.mean((pred != y).float()))


@dataclass
class Problem:
    params: dict            # the trained reference model w̄
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    ref_test_err: float
    ref_train_err: float


def reference_problem(n_train=4096, n_test=1024, steps=400, lr=0.05,
                      seed=0, device=None) -> Problem:
    """Train the reference (uncompressed) model: plain SGD on batches of
    256. σ=5 puts the reference test error near 2%, the LeNet300/MNIST
    regime (paper: 2.13%)."""
    dev = resolve_device(device)
    full_fp32_matmuls()
    x, y = gaussian_blobs(n_train + n_test, d=DIMS[0], classes=DIMS[-1],
                          sigma=5.0, seed=seed, device=dev)
    xtr, ytr = x[:n_train], y[:n_train]
    xte, yte = x[n_train:], y[n_train:]
    model = LeNet300(init_mlp(torch.Generator().manual_seed(seed + 1),
                              device=dev))
    plist = list(model.parameters())
    for i in range(steps):
        b = (i * 256) % (n_train - 256)
        grads = torch.autograd.grad(
            ce_loss(model.tree(), xtr[b:b + 256], ytr[b:b + 256]), plist)
        with torch.no_grad():
            for p, g in zip(plist, grads):
                p.sub_(lr * g)
    params = {k: {n: t.detach().clone() for n, t in v.items()}
              for k, v in model.tree().items()}
    return Problem(params, xtr, ytr, xte, yte,
                   error_rate(params, xte, yte),
                   error_rate(params, xtr, ytr))


def sgd_l_step_factory(prob: Problem, iters=40, lr0=0.05, decay=0.98,
                       momentum=0.9, batch=256):
    """The paper's Listing-2 L step on a :class:`LeNet300`: SGD with
    Nesterov momentum (reset every L step), lr decayed per LC step, loss
    = CE + LC penalty. Updates the module's parameters in place."""
    def l_step(model: LeNet300, lc: dict, k: int) -> LeNet300:
        lr = lr0 * (decay ** k)
        mu = lc["mu"]
        refs = [(lc["tasks"][t]["a"], lc["tasks"][t]["lam"])
                for t in lc["tasks"]]
        params = model.tree()
        flat = flatten_params(params)
        plist = list(flat.values())
        mom = [torch.zeros_like(p) for p in plist]

        def total_loss(x, y):
            loss = ce_loss(params, x, y)
            for a, lam in refs:
                for path, a_leaf in a.items():
                    d = flat[path] - a_leaf - lam[path] / mu
                    loss = loss + 0.5 * mu * torch.sum(d * d)
            return loss

        n = prob.x_train.shape[0]
        for i in range(iters):
            b = (i * batch) % (n - batch)
            grads = torch.autograd.grad(
                total_loss(prob.x_train[b:b + batch],
                           prob.y_train[b:b + batch]), plist)
            with torch.no_grad():
                for p, m, g in zip(plist, mom, grads):
                    m.mul_(momentum).add_(g)
                    p.sub_(lr * (g + momentum * m))    # nesterov
        return model
    return l_step


def run_lc(prob: Problem, tasks, mu0=9e-5, a=1.3, n_steps=20,
           iters_per_l=40, lr0=0.05, callbacks=(), device=None) -> dict:
    """Full LC run (paper Fig. 2) from a copy of ``prob.params``; returns
    errors, compression ratio, wall time and the LC objects.
    ``callbacks`` are handed to :meth:`LCAlgorithm.run`."""
    full_fp32_matmuls()
    lc = LCAlgorithm(tasks, [mu0 * a**k for k in range(n_steps)],
                     l_step=sgd_l_step_factory(prob, iters=iters_per_l,
                                               lr0=lr0),
                     device=device)
    t0 = time.time()
    model, lc_state, hist = lc.run(LeNet300(prob.params),
                                   params_of=LeNet300.tree,
                                   callbacks=callbacks)
    wall = time.time() - t0
    compressed = lc.apply_compression(model.tree())
    return {
        "test_err": error_rate(compressed, prob.x_test, prob.y_test),
        "train_err": error_rate(compressed, prob.x_train, prob.y_train),
        "ratio": hist[-1].compression_ratio,
        "wall_s": wall,
        "lc": lc, "state": model, "lc_state": lc_state,
        "history": hist, "compressed": compressed,
    }


def per_layer_tasks(scheme_factory) -> list:
    """Paper Table-2 "quantize all layers": one task (own Θ) per layer."""
    return [CompressionTask(f"t{i}", rf"l{i}/w$", AsVector(),
                            scheme_factory())
            for i in range(len(DIMS) - 1)]


def direct_compress(prob: Problem, tasks, device=None) -> dict:
    """Θ^DC = Π(w̄) with no retraining — the paper's DC baseline."""
    full_fp32_matmuls()
    lc = LCAlgorithm(tasks, [1e-4], device=device)
    lc_state = lc.init(prob.params)
    lc._last_lc = lc_state
    compressed = lc.apply_compression(prob.params)
    return {
        "test_err": error_rate(compressed, prob.x_test, prob.y_test),
        "train_err": error_rate(compressed, prob.x_train, prob.y_train),
        "ratio": lc.compression_ratio(prob.params, lc_state),
        "lc": lc, "lc_state": lc_state,
    }

