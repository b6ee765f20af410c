"""k-means C-step solvers and their CUDA kernel (K1, K7)."""
from repro_torch.kernels.kmeans.ops import assign_moments, kmeans, lloyd_step

__all__ = ["assign_moments", "kmeans", "lloyd_step"]
