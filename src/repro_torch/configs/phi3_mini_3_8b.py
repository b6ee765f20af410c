"""Phi-3-mini 3.8B [arXiv:2404.14219]: 32L, d=3072, 32H MHA (kv=32),
head_dim=96, d_ff=8192, vocab=32064. RoPE + SwiGLU, full attention."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    pattern=(LayerSpec("attn", "dense"),),
    pattern_reps=32,
    rope_theta=10000.0, tie_embeddings=False,
    subquadratic=False,
)
