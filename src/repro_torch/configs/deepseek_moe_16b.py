"""DeepSeekMoE-16B [arXiv:2401.06066]: 28L, d=2048, 16H (MHA), fine-grained
MoE — 64 routed experts top-6 + 2 shared, expert d_ff=1408; layer 0 is a
dense FFN (d_ff=10944) as in the released checkpoint."""
from repro_torch.configs.base import LayerSpec, MoECfg, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,  # the single dense layer's FFN width
    vocab_size=102400,
    lead=(LayerSpec("attn", "dense"),),
    pattern=(LayerSpec("attn", "moe"),),
    pattern_reps=27,
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    rope_theta=10000.0, tie_embeddings=False,
    subquadratic=False,
)
