"""Pruning C-step solvers and the threshold-count CUDA kernel (K2)."""
