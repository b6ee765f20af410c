"""Roofline terms of one rank's step on the H100, from its op counts.

Port of ``src/repro/analysis/roofline.py``. The reference reads a
compiled dry-run artifact; the port reads the ``analysis/op_stats.py``
counts of the step run eagerly on meta tensors (``launch/dryrun.py``) or
on the card:

    compute    = Σ_class FLOPs_class / peak_class           [s]
    memory     = bytes / HBM_BW                             [s]
    collective = Σ_axes collective bytes / link(axes)       [s]

all per rank (the counts are the rank's). The rates are the H100 SXM's
spec-sheet numbers at 700 W (``analysis/cost.H100``), whatever host runs
the count, never the host's own device: f32 products on the CUDA cores
(67 TFLOP/s), the kernels' 3-pass TF32 split (494.7 TFLOP/s for three
times the FLOPs), bf16 products (989.4 TFLOP/s); HBM3 at 3.35 TB/s. A
collective runs over NVLink (450 GB/s a direction) where the ranks of
its mesh axes share an 8-GPU node, and over the NICs (50 GB/s a GPU)
where they do not: the production ``"model"`` axis of 16 spans two
nodes, and the row says so (``coll_links``). The collectives' bytes are
output bytes by primitive, the reference's convention.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.cost import H100

#: FLOP/s of each ``op_stats`` FLOP class (the tensor cores' TF32 rate
#: over the kernels' three passes)
TF32_PASSES = 3
PEAK_FLOPS = {"f32": H100.peak_flops,
              "tf32": H100.tf32_flops / TF32_PASSES,
              "bf16": H100.bf16_flops}
HBM_BW = H100.hbm_bw
NVLINK_BW = H100.link_bw
NIC_BW = H100.nic_bw
NODE_SIZE = H100.node_size


def axes_link(mesh_shape: tuple, mesh_axes: tuple, axes) -> str:
    """``"nvlink"`` where the ranks of rank 0's group along ``axes``
    share a node of ``NODE_SIZE`` (ranks numbered row-major over the
    mesh), else ``"nic"``; ``None`` (a real group's collective) is
    ``"nvlink"``."""
    if axes is None:
        return "nvlink"
    strides, acc = {}, 1
    for name, n in zip(reversed(mesh_axes), reversed(mesh_shape)):
        strides[name] = acc
        acc *= n
    sizes = dict(zip(mesh_axes, mesh_shape))
    last = sum((sizes[a] - 1) * strides[a] for a in axes)
    return "nvlink" if last < NODE_SIZE else "nic"


def collective_bytes(stats) -> dict[str, float]:
    """Per-rank output bytes by collective primitive, and their
    ``"count"``."""
    out = {k: float(v) for k, v in stats.coll.items()}
    out["count"] = stats.coll_count
    return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0          # 6·N·D (N = active params)
    peak_bytes_per_chip: float = 0.0  # given + the step's live peak
    flops_by_class: dict = field(default_factory=dict)
    coll_by_axes: dict = field(default_factory=dict)   # "a,b" -> bytes
    coll_links: dict = field(default_factory=dict)     # "a,b" -> link
    launches: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        by = self.flops_by_class or {"f32": self.flops_per_chip}
        return sum(f / PEAK_FLOPS[c] for c, f in by.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / (NIC_BW if self.coll_links.get(a) == "nic"
                        else NVLINK_BW)
                   for a, b in self.coll_by_axes.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / the step's counted FLOPs over every chip."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def peak_class(self) -> str:
        """The FLOP class of most of the step's FLOPs."""
        by = self.flops_by_class or {"f32": 1.0}
        return max(by, key=by.get)

    @property
    def roofline_fraction(self) -> float:
        """useful time at the main class's peak / modelled step time
        (max of terms)."""
        t_star = self.model_flops / (self.chips
                                     * PEAK_FLOPS[self.peak_class])
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / t if t else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_bytes_per_chip": self.peak_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "flops_by_class": self.flops_by_class,
            "coll_by_axes": self.coll_by_axes,
            "coll_links": self.coll_links,
            "launches": self.launches,
        }


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D for a train step (fwd+bwd)."""
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    return 6.0 * n * tokens


def model_flops_decode(cfg, batch: int, context: int) -> float:
    """2·N_active per token + attention KV reads ≈ 2·N + 2·kv_flops."""
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    # per-token attention score+value FLOPs against the cache
    kv_flops = 0.0
    for spec in cfg.all_layer_specs():
        if spec.mixer == "attn":
            ctx = min(spec.window, context) if spec.window else context
            kv_flops += 2 * 2 * cfg.n_heads * cfg.head_dim * ctx
        elif spec.mixer == "mla":
            m = cfg.mla
            kv_flops += 2 * cfg.n_heads * context * (
                m.kv_lora_rank * 2 + m.qk_rope_dim)
    return batch * (2.0 * n + kv_flops)


def model_flops_prefill(cfg, tokens: int) -> float:
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    return 2.0 * n * tokens


def fused_attention_bytes(cfg, shape_cfg, chips: int) -> float:
    """Analytic per-chip boundary I/O of the flash-attention kernel.

    train/prefill: q, k, v, o tiles in bf16, ×4 passes for training
    (fwd + remat recompute + bwd reads/writes), ×1 for prefill.
    decode (flash-decoding): the KV-cache read dominates — per step the
    kernel streams the whole (window-clamped) cache once."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    total = 0.0
    if shape_cfg.kind == "decode":
        for spec in cfg.all_layer_specs():
            if spec.mixer == "attn":
                ctx = min(spec.window, s) if spec.window else s
                total += 2 * b * ctx * cfg.kv_dim * 2      # K + V bf16
            elif spec.mixer == "mla":
                m = cfg.mla
                total += b * s * (m.kv_lora_rank + m.qk_rope_dim) * 2
        return total / chips
    passes = 4.0 if shape_cfg.kind == "train" else 1.0
    for spec in cfg.all_layer_specs():
        if spec.mixer == "attn":
            q = b * s * cfg.q_dim * 2
            kv = 2 * b * s * cfg.kv_dim * 2
            o = b * s * cfg.q_dim * 2
        elif spec.mixer == "mla":
            m = cfg.mla
            q = b * s * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim) * 2
            kv = b * s * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim
                                        + m.v_head_dim) * 2
            o = b * s * cfg.n_heads * m.v_head_dim * 2
        else:
            continue
        total += (q + kv + o) * passes
    return total / chips


def analyze(stats, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, extra_bytes_per_chip: float = 0.0,
            mesh=None) -> RooflineTerms:
    """The terms of a step from its ``op_stats.Stats`` (one rank's);
    ``extra_bytes_per_chip`` adds a skipped scope's analytic bytes (the
    reference's argument), and ``mesh`` (its ``shape`` and
    ``mesh_dim_names``) places each collective's axes on NVLink or the
    NICs."""
    coll = collective_bytes(stats)
    by_axes, links = {}, {}
    for axes, nbytes in stats.coll_by_axes().items():
        key = "" if axes is None else ",".join(axes)
        by_axes[key] = by_axes.get(key, 0.0) + nbytes
        links[key] = ("nvlink" if mesh is None else axes_link(
            tuple(mesh.shape), tuple(mesh.mesh_dim_names), axes))
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=stats.flops,
        bytes_per_chip=stats.bytes + extra_bytes_per_chip,
        coll_bytes_per_chip=stats.coll_bytes, coll_breakdown=coll,
        model_flops=model_flops,
        peak_bytes_per_chip=stats.arg_bytes + stats.peak_bytes,
        flops_by_class=dict(stats.flops_by_class), coll_by_axes=by_axes,
        coll_links=links, launches=dict(stats.launches))

