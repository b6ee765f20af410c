from repro_torch.data.pipeline import gaussian_blobs

__all__ = ["gaussian_blobs"]
