from repro_torch.data.pipeline import (
    Prefetcher, TokenStream, embedding_stream, gaussian_blobs,
    teacher_classification)

__all__ = ["Prefetcher", "TokenStream", "embedding_stream",
           "gaussian_blobs", "teacher_classification"]
