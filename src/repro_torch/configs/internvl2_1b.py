"""InternVL2-1B [arXiv:2404.16821]: InternViT-300M frontend (STUB — the
dry-run feeds precomputed patch embeddings via input_specs) + Qwen2-0.5B
LM backbone: 24L, d=896, 14H GQA(kv=2), d_ff=4864, vocab=151655."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655,
    pattern=(LayerSpec("attn", "dense"),),
    pattern_reps=24,
    rope_theta=1e6, tie_embeddings=False,
    input_mode="embeddings", d_input=1024,  # InternViT hidden size
    subquadratic=False,
)
