"""Family dispatch (torch twin of ``repro.models.registry``): one API over
every architecture, the LM families and the audio encoder-decoder
(whisper).  ``batch_specs`` and ``batch_logical_axes`` wait for the
dry-run (ROADMAP.md, Queue 1), their only reader."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ArchConfig
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
