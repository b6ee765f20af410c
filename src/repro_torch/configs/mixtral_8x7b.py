"""Mixtral-8x7B [arXiv:2401.04088]: 32L, d=4096, 32H GQA(kv=8), 8 experts
top-2 (d_ff=14336 per expert), sliding-window attention (w=4096)."""
from repro_torch.configs.base import LayerSpec, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    pattern=(LayerSpec("attn", "moe", window=4096),),
    pattern_reps=32,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=14336, n_shared=0),
    rope_theta=1e6, tie_embeddings=False,
    subquadratic=True,  # SWA → ring-buffer KV, O(window) per token
)
