"""k-means C-step solver and its CUDA kernel (K1)."""
