"""xLSTM-125M [arXiv:2405.04517]: 12 blocks, d=768, 4 heads, vocab=50304,
d_ff=0 (projections live inside the xLSTM blocks). mLSTM:sLSTM ≈ 5:1
interleave (pattern of 6, ×2). Pure recurrent state → long_500k capable."""
from repro_torch.configs.base import LayerSpec, ModelConfig, XLSTMCfg

_M = LayerSpec("mlstm", "none")
_S = LayerSpec("slstm", "none")

CONFIG = ModelConfig(
    name="xlstm-125m",
    d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    pattern=(_M, _M, _M, _M, _M, _S),
    pattern_reps=2,
    xlstm=XLSTMCfg(proj_factor_m=2.0, proj_factor_s=4 / 3,
                   conv_kernel=4, chunk=256),
    tie_embeddings=True,
    subquadratic=True,
)
