"""Low-rank C-step solvers (matmul-only randomized SVD) and the low-rank
serving op."""
