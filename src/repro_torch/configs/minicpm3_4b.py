"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L, d=2560, 40H, d_ff=6400,
vocab=73448, Multi-head Latent Attention (q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64) — the KV cache stores only the
(kv_lora+rope)-dim latents."""
from repro_torch.configs.base import LayerSpec, MLACfg, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab_size=73448,
    pattern=(LayerSpec("mla", "dense"),),
    pattern_reps=62,
    mla=MLACfg(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
               qk_rope_dim=32, v_head_dim=64),
    rope_theta=10000.0, tie_embeddings=True,
    subquadratic=False,
)
