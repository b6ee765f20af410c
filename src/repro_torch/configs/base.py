"""Model configuration dataclasses.

Every assigned architecture is expressed as a *pattern* of layer specs
(mixer × ffn) repeated ``pattern_reps`` times plus an optional unrolled
``tail`` — the transformer scans over pattern repetitions so compile time
is O(|pattern|), not O(n_layers).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMCfg:
    proj_factor_m: float = 2.0     # mLSTM up-projection
    proj_factor_s: float = 4 / 3   # sLSTM post-MLP
    conv_kernel: int = 4
    chunk: int = 256               # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class LayerSpec:
    mixer: str          # attn | mla | mamba | mlstm | slstm
    ffn: str            # dense | moe | none
    window: int = 0     # sliding-window size for mixer="attn" (0 = full)

    def __post_init__(self):
        assert self.mixer in ("attn", "mla", "mamba", "mlstm", "slstm")
        assert self.ffn in ("dense", "moe", "none")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    pattern_reps: int
    lead: tuple[LayerSpec, ...] = ()    # unrolled layers before the scan
    tail: tuple[LayerSpec, ...] = ()    # unrolled layers after the scan
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    input_mode: str = "tokens"      # tokens | embeddings (stub frontend)
    d_input: int = 0                # embeddings mode: frontend embed dim
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk_q: int = 1024        # blockwise-attention chunk sizes
    attn_chunk_kv: int = 1024
    # treat attention as a fused Pallas flash kernel (kernels/
    # flash_attention) for the dry-run accounting — beyond-paper perf
    fused_attention: bool = False
    # long-context capability flag (sub-quadratic mechanism present);
    # used by the dry-run to decide long_500k applicability.
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return (len(self.lead) + len(self.pattern) * self.pattern_reps
                + len(self.tail))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def all_layer_specs(self) -> list[LayerSpec]:
        return (list(self.lead) + list(self.pattern) * self.pattern_reps
                + list(self.tail))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        from repro_torch.models.transformer import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
