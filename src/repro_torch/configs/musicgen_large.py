"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.
48L, d=2048, 32H MHA, d_ff=8192, vocab=2048 (one EnCodec codebook head).
The EnCodec frontend is a STUB — input_specs supplies precomputed frame
embeddings (sum of the 4 codebook embeddings, dim d_model)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    pattern=(LayerSpec("attn", "dense"),),
    pattern_reps=48,
    rope_theta=10000.0, tie_embeddings=False,
    input_mode="embeddings", d_input=2048,
    subquadratic=False,
)
