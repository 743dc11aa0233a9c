"""Batched serving engine (torch twin of ``repro.serve.engine``): prefill +
decode with a KV cache, greedy sampling, on one device, and a
checkpointable serving state (cache + positions + generated tokens): the
service can be drained, snapshotted in the reference's checkpoint format,
and restored by either package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.layers import DEFAULT_POLICY, Policy
from repro_torch.models.params import is_pm, tree_leaves, tree_map
from repro_torch.models.registry import get_api


@dataclass
class GenResult:
    tokens: np.ndarray              # (B, n_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_seq: int,
                 policy: Policy = DEFAULT_POLICY, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_seq = max_seq
        self.policy = policy
        self.api = get_api(cfg)
        self.params = policy.cast_params(
            tree_map(lambda x: x.to(self.device), params))
        self.cache = None
        self.pos = None
        self.generated: List[np.ndarray] = []

    # ------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int,
                 extras: Optional[dict] = None) -> GenResult:
        """prompts (B, P) equal-length token batch; greedy decode n_new.
        Both clocks are read only after the device has finished."""
        b, p = prompts.shape
        if p + n_new > self.max_seq:
            raise ValueError(f"prompt {p} + {n_new} new tokens exceed "
                             f"max_seq {self.max_seq}")
        dev = self.device
        extras = {k: torch.as_tensor(np.asarray(x), device=dev)
                  for k, x in (extras or {}).items()}
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=dev)
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.cfg, self.params, tokens, extras,
                                         self.max_seq, self.policy)
        # pad prefill cache (built at prompt length) up to max_seq buffers
        cache = self._pad_cache(cache, p)
        tok = torch.argmax(logits, dim=-1)[:, None]
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        pos = torch.full((b,), p, dtype=torch.long, device=dev)
        out = [tok]
        for _ in range(n_new - 1):
            logits, cache = self.api.decode(self.cfg, self.params, cache, tok,
                                            pos, self.policy)
            tok = torch.argmax(logits, dim=-1)[:, None]
            pos = pos + 1
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
        self.cache, self.pos = cache, pos + 1
        self.generated.append(toks)
        return GenResult(tokens=toks, prefill_s=t_prefill, decode_s=t_decode,
                         tokens_per_s=b * max(n_new - 1, 1) / max(t_decode, 1e-9))

    def _pad_cache(self, cache, p: int):
        """Grow seq-dim buffers from prompt length to max_seq (zero fill).
        Target defs are built with batch=1; dims of size 1 in the target
        take the runtime batch, larger target dims are zero-padded."""
        flat_t = tree_leaves(self.api.cache_defs(self.cfg, 1, self.max_seq),
                             is_leaf=is_pm)
        assert len(flat_t) == len(tree_leaves(cache)), len(flat_t)
        targets = iter(flat_t)          # same sorted-key order as tree_map

        def pad(x):
            tshape = [sx if st == 1 else max(sx, st)
                      for sx, st in zip(x.shape, next(targets).shape)]
            if list(x.shape) == tshape:
                return x
            y = x.new_zeros(tshape)
            y[tuple(slice(0, s) for s in x.shape)] = x
            return y

        return tree_map(pad, cache)

    # ----------------------------------------------------------- checkpoint
    def snapshot_service(self, mgr, step: int) -> None:
        """Drain + snapshot the serving state through ``mgr`` (a
        ``repro_torch.checkpoint.manager.CheckpointManager``), as the
        reference does: ``{"cache", "pos", "generated"}``, ``pos`` as int32
        like the reference's.  ``pos`` is one past the next cache slot: the
        last generated token is not in the cache yet, so a continuation
        feeds ``generated[:, -1]`` at ``pos - 1``."""
        payload = {"cache": self.cache,
                   "pos": None if self.pos is None
                   else self.pos.to(torch.int32),
                   "generated": np.concatenate(self.generated, axis=1)
                   if self.generated else np.zeros((0, 0), np.int32)}
        mgr.save(step, payload, meta={"kind": "serve", "arch": self.cfg.name})
        mgr.wait()
