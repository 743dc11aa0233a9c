"""Architecture & input-shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeCfg`` entries in ``SHAPES``.  ``reduce_for_smoke``
produces a family-preserving tiny config for CPU smoke tests (the FULL
configs are only ever lowered abstractly by launch/dryrun.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts block configuration (routed + shared experts)."""

    n_routed: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # shared experts (fused: one FFN of n_shared*d_expert)
    first_k_dense: int = 0         # leading dense layers (deepseek-v2 style)
    dense_ff: int = 0              # FFN width of those dense layers
    capacity_factor: float = 1.25  # train-time dispatch capacity factor
    aux_coef: float = 0.001        # load-balancing auxiliary loss coefficient
    shared_gate: bool = False      # qwen2-moe gates the shared expert output


@dataclass(frozen=True)
class MLACfg:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncoderCfg:
    """Auxiliary encoder for enc-dec archs (whisper).  Frontend is a STUB:
    input_specs() provides precomputed frame embeddings (B, n_frames, d_model)."""

    n_layers: int
    n_frames: int = 1500


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    norm: str = "rms"              # rms | ln
    norm_eps: float = 1e-5
    pos_emb: str = "rope"          # rope | learned | sincos
    rope_theta: float = 10000.0
    rope_pct: float = 1.0          # partial rotary (stablelm: 0.25)
    qk_norm: bool = False          # per-head q/k layernorm (stablelm-2)
    mlp: str = "swiglu"            # swiglu | gelu | geglu
    act: str = "silu"
    tie_embeddings: bool = False
    # family extras -----------------------------------------------------
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    block_pattern: Tuple[str, ...] = ()   # repeating unit for hybrid/ssm stacks
    pattern_tail: Tuple[str, ...] = ()    # trailing blocks after the repeated unit
    window: int = 0                       # local-attention window (0 = full/causal)
    d_rnn: int = 0                        # recurrent width (rglru); 0 -> d_model
    conv_width: int = 4                   # temporal conv width (rglru)
    proj_factor: float = 2.0              # mLSTM up-projection factor
    encoder: Optional[EncoderCfg] = None
    n_vision_tokens: int = 0              # VLM stub: patch embeds merged at seq head
    subquadratic: bool = False            # may run long_500k
    source: str = ""                      # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer block-kind sequence."""
        if not self.block_pattern:
            return ("attn",) * self.n_layers
        unit = self.block_pattern
        n_unit = (self.n_layers - len(self.pattern_tail)) // len(unit)
        seq = unit * n_unit + self.pattern_tail
        assert len(seq) == self.n_layers, (len(seq), self.n_layers)
        return seq

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        from repro_torch.models.registry import count_params
        return count_params(self)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeCfg("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 524k dense KV decode is the "
                       "quadratic regime the shape spec says to skip (DESIGN.md §5)")
    return True, ""


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving tiny config for 1-device CPU smoke tests."""
    changes = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        d_rnn=64 if cfg.d_rnn or cfg.family == "hybrid" else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
    )
    unit = len(cfg.block_pattern) if cfg.block_pattern else 1
    n_layers = max(2 * unit + len(cfg.pattern_tail), 2)
    changes["n_layers"] = n_layers
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_routed=8, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 2),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_ff=64 if cfg.moe.dense_ff else 0)
    if cfg.mla is not None:
        changes["mla"] = MLACfg(kv_lora_rank=32, qk_nope_head_dim=16,
                                qk_rope_head_dim=8, v_head_dim=16)
    if cfg.encoder is not None:
        changes["encoder"] = EncoderCfg(n_layers=2, n_frames=16)
    return dataclasses.replace(cfg, **changes)
