"""Family dispatch (torch twin of ``repro.models.registry``): one API over
every architecture, the LM families and the audio encoder-decoder
(whisper).  ``batch_specs`` gives a step's data inputs as ``meta``
tensors (the reference's ``ShapeDtypeStruct`` stand-ins) and
``batch_logical_axes`` the logical axes that lay them out on a mesh."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import model as lm
from repro_torch.models import whisper as wh
from repro_torch.models.params import param_count


@dataclass(frozen=True)
class ModelAPI:
    param_defs: Callable   # (cfg, max_seq) -> Pm tree
    forward: Callable      # (cfg, params, batch, policy, remat) -> (logits, aux)
    cache_defs: Callable   # (cfg, batch, max_seq, dtype=bf16) -> Pm tree
    prefill: Callable      # (cfg, params, tokens, extras, max_cache, policy, cache=None) -> (logits, cache)
    decode: Callable       # (cfg, params, cache, token, pos, policy) -> (logits, cache)


_LM_API = ModelAPI(lm.lm_param_defs, lm.lm_forward, lm.lm_cache_defs,
                   lm.lm_prefill, lm.lm_decode)
_WHISPER_API = ModelAPI(wh.whisper_param_defs, wh.whisper_forward,
                        wh.whisper_cache_defs, wh.whisper_prefill,
                        wh.whisper_decode)


def get_api(cfg: ArchConfig) -> ModelAPI:
    return _WHISPER_API if cfg.family == "audio" else _LM_API


def count_params(cfg: ArchConfig, max_seq: int = 4096) -> int:
    return param_count(get_api(cfg).param_defs(cfg, max_seq))


def active_param_ratio(cfg: ArchConfig) -> float:
    """Fraction of per-token-active params (MoE: top_k+shared of routed)."""
    if cfg.moe is None:
        return 1.0
    e = cfg.moe
    total_moe = e.n_routed * 3 * cfg.d_model * e.d_expert
    active_moe = (e.top_k + e.n_shared) * 3 * cfg.d_model * e.d_expert
    n_moe_layers = cfg.n_layers - e.first_k_dense
    total = count_params(cfg)
    return (total - n_moe_layers * (total_moe - active_moe)) / total


def batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """``meta`` tensors standing in for the *data* inputs of a step.

    train:   tokens/targets (B,S) [+ frames | vision_embeds]
    prefill: tokens (B,S) [+ frames | vision_embeds]
    decode:  token (B,1), pos (B,)   (cache specs come from cache_defs)
    """
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        out = {"tokens": spec((b, s)), "targets": spec((b, s))}
    elif shape.kind == "prefill":
        out = {"tokens": spec((b, s))}
    else:
        return {"token": spec((b, 1)), "pos": spec((b,))}
    if cfg.family == "audio":
        out["frames"] = spec((b, cfg.encoder.n_frames, cfg.d_model),
                             torch.bfloat16)
    if cfg.family == "vlm":
        out["vision_embeds"] = spec((b, cfg.n_vision_tokens, cfg.d_model),
                                    torch.bfloat16)
    return out


def batch_logical_axes(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, tuple]:
    """Logical sharding axes for each batch input."""
    if shape.kind == "decode":
        return {"token": ("batch", None), "pos": ("batch",)}
    ax = {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    if cfg.family == "audio":
        ax["frames"] = ("batch", "frames", "embed")
    if cfg.family == "vlm":
        ax["vision_embeds"] = ("batch", None, "embed")
    return ax
