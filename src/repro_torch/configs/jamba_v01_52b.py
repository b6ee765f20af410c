"""Jamba-v0.1 (52B total) [arXiv:2403.19887]: 32L, d=4096. Period-8
super-block: attention at index 4, Mamba elsewhere (1:7 attn:mamba);
MoE (16 experts, top-2, d_expert=14336) on odd layers, dense FFN on even.
GQA kv=8 on the attention layers."""
from repro_torch.configs.base import LayerSpec, MambaCfg, MoECfg, ModelConfig

_P = []
for i in range(8):
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer, ffn))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    pattern=tuple(_P),
    pattern_reps=4,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336, n_shared=0),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    rope_theta=10000.0, tie_embeddings=False,
    subquadratic=True,  # Mamba states + 4 attention layers
)
