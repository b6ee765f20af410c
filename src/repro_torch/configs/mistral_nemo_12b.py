"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: 40L, d=5120,
32H GQA(kv=8), head_dim=128 (q_dim=4096 ≠ d_model), d_ff=14336,
vocab=131072, full attention, 128k context."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    pattern=(LayerSpec("attn", "dense"),),
    pattern_reps=40,
    rope_theta=1e6, tie_embeddings=False,
    subquadratic=False,
)
