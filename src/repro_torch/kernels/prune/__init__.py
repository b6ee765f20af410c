"""Pruning C-step solvers and their CUDA kernels (K2, K3, K8, K9)."""
from repro_torch.kernels.prune.ops import topk_mask

__all__ = ["topk_mask"]
