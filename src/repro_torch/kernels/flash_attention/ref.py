"""Plain PyTorch version of the flash-attention kernel (causal + window):
the oracle for K6 and what its wrapper runs on CPU tensors."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, KV, G, Sq, D); k: (B, KV, Sk, D); v: (B, KV, Sk, Dv) →
    (B, KV, G, Sq, Dv) f32.

    Causal over absolute positions (Sq == Sk); with ``window > 0`` a
    query at position i sees keys i - window < j ≤ i. Scores are scaled
    by ``scale`` (default 1/√D)."""
    sq, sk = q.shape[3], k.shape[2]
    d = q.shape[-1]
    s = torch.einsum("bkgqd,bkcd->bkgqc", q.float(), k.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
