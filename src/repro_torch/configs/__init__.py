"""Architecture registry: ``get_config(arch_id)`` + reduced smoke configs.

The port's own copy of ``src/repro/configs`` (pure dataclasses, the same
ten architectures): the port imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    LayerSpec, MLACfg, MambaCfg, MoECfg, ModelConfig, ShapeCfg, SHAPES,
    XLSTMCfg)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-large": "musicgen_large",
    "gemma3-27b": "gemma3_27b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "minicpm3-4b": "minicpm3_4b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-125m": "xlstm_125m",
}

ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: identical pattern
    structure (mixers/ffn kinds/windows scaled), small dims."""
    def shrink_spec(s: LayerSpec) -> LayerSpec:
        return LayerSpec(s.mixer, s.ffn, window=min(s.window, 8)
                         if s.window else 0)

    kw = dict(
        name=cfg.name + "-reduced",
        d_model=64, n_heads=2, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab_size=256,
        pattern=tuple(shrink_spec(s) for s in cfg.pattern),
        pattern_reps=min(cfg.pattern_reps, 2),
        lead=tuple(shrink_spec(s) for s in cfg.lead),
        tail=tuple(shrink_spec(s) for s in cfg.tail[:1]),
        attn_chunk_q=8, attn_chunk_kv=8,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_expert=32, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla:
        kw["mla"] = MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                           qk_rope_dim=8, v_head_dim=8)
    if cfg.mamba:
        kw["mamba"] = MambaCfg(d_state=4, d_conv=4, expand=2, dt_rank=8)
    if cfg.xlstm:
        kw["xlstm"] = XLSTMCfg(chunk=8)
    if cfg.input_mode == "embeddings":
        kw["input_mode"] = "embeddings"
        kw["d_input"] = 32
        kw["tie_embeddings"] = False
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "get_config", "reduced_config", "ModelConfig",
           "LayerSpec", "MoECfg", "MLACfg", "MambaCfg", "XLSTMCfg",
           "ShapeCfg", "SHAPES"]
