"""Wrapper: model-layout (B, S, H, D) GQA attention on the flash kernel.

Port of ``src/repro/kernels/flash_attention/ops.py``. The kernel picks
its own tiles, so the reference's ``q_chunk``/``kv_chunk`` arguments are
gone; the device of the tensors decides between the kernel (CUDA) and
its plain version (CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k: (B, S, KV, D); v: (B, S, KV, Dv) → (B, S, H, Dv)
    in q's dtype; ``scale`` defaults to 1/√D. Head h belongs to kv head
    h // (H / KV)."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[-1]
    g = h // kvh
    qg = q.float().reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4)
    kg = k.float().transpose(1, 2)                     # (B, KV, S, D)
    vg = v.float().transpose(1, 2)                     # (B, KV, S, Dv)
    out = flash_attention(qg.contiguous(), kg.contiguous(), vg.contiguous(),
                          window=window, scale=scale)  # (B, KV, G, S, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)
