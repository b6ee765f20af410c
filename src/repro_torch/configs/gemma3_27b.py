"""Gemma3-27B-class config [hf:google/gemma-3 family]: 62L, d=5376,
32H GQA(kv=16), d_ff=21504, vocab=262144, 5:1 local:global attention
(local window 1024). 62 = 10×(5 local + 1 global) + 2 local tail."""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec("attn", "dense", window=1024)
_GLOBAL = LayerSpec("attn", "dense", window=0)

CONFIG = ModelConfig(
    name="gemma3-27b",
    d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    pattern_reps=10,
    tail=(_LOCAL, _LOCAL),
    rope_theta=1e6, tie_embeddings=True,
    # 5-in-6 layers are O(window); the periodic global layers keep full KV
    # (the arch's own design) — long_500k runs with ring-buffer local KV.
    subquadratic=True,
)
