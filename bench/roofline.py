"""The benchmark's frozen arithmetic: the card's peaks, the bytes and
operations a kernel or a step needs, and the model flops that MFU counts.

Everything here works from a configuration's published numbers and a
cell's shapes, never from the program's objects, so that a change to the
program cannot move the yardstick.  ``attention_pairs``, ``flash_bound``
and ``bound`` are copies of the same functions in ``chip_smoke.py``.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its 700 W power limit.
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(n_bytes: float, ops: float, peak_ops: float = BF16_FLOP_PER_S):
    """The least time the card could take (seconds) for ``n_bytes`` moved
    and ``ops`` operations, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_pairs(s: int, window: int = 0) -> int:
    """Causal (q, k) pairs of one head, within the window if there is one."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def flash_bound(bh: int, bkv: int, s: int, hd: int, window: int = 0,
                elem_bytes: int = 2) -> float:
    """Seconds one causal flash launch needs at least: q and o, k and v
    read or written once each; QK^T and PV over the kept pairs, 2 flops a
    multiply-add, on the bf16 tensor cores."""
    n_bytes = (2 * bh + 2 * bkv) * s * hd * elem_bytes
    return bound(n_bytes, 4 * hd * attention_pairs(s, window) * bh)[0]


# ------------------------------------------------------------------ models

def is_mla(hf: dict) -> bool:
    return hf.get("kv_lora_rank") is not None


def _n_moe_layers(hf: dict) -> int:
    if not hf.get("n_routed_experts"):
        return 0
    return hf["num_hidden_layers"] - hf.get("first_k_dense_replace", 0)


def attn_params(hf: dict) -> int:
    """Weights of one attention block's products."""
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    if is_mla(hf):
        qk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
        r = hf["kv_lora_rank"]
        return (d * h * qk + d * (r + hf["qk_rope_head_dim"])
                + r * h * hf["qk_nope_head_dim"] + r * h * hf["v_head_dim"]
                + h * hf["v_head_dim"] * d)
    hd = hf.get("head_dim") or d // h
    kv = hf["num_key_value_heads"]
    return d * h * hd * 2 + d * kv * hd * 2


def expert_params(hf: dict) -> int:
    """One routed expert's three matrices."""
    return 3 * hf["hidden_size"] * hf["moe_intermediate_size"]


def active_block_params(hf: dict) -> int:
    """Matrix weights one token passes through in the blocks: attention,
    the dense MLPs, and in each MoE layer the router, its top-k routed
    experts and the shared experts."""
    d, n = hf["hidden_size"], hf["num_hidden_layers"]
    n_moe = _n_moe_layers(hf)
    dense_ff = 3 * d * hf["intermediate_size"]
    total = n * attn_params(hf) + (n - n_moe) * dense_ff
    if n_moe:
        per = (d * hf["n_routed_experts"]
               + hf["num_experts_per_tok"] * expert_params(hf)
               + 3 * d * hf["moe_intermediate_size"]
               * hf.get("n_shared_experts", 0))
        total += n_moe * per
    return total


def head_params(hf: dict) -> int:
    return hf["hidden_size"] * hf["vocab_size"]


def attention_flops(hf: dict, s: int) -> float:
    """Forward flops of one sequence's causal attention, all layers:
    QK^T over the query/key head dim and PV over the value head dim."""
    h = hf["num_attention_heads"]
    if is_mla(hf):
        qk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
        v = hf["v_head_dim"]
    else:
        qk = v = hf.get("head_dim") or hf["hidden_size"] // h
    return (2 * (qk + v) * attention_pairs(s) * h
            * hf["num_hidden_layers"])


def train_flops(hf: dict, batch: int, seq: int) -> float:
    """Model flops of one training step: 6 per weight a token passes
    through (the LM head at every position) and three times the causal
    attention's forward; recomputation is not counted."""
    n = active_block_params(hf) + head_params(hf)
    return 6.0 * n * batch * seq + 3.0 * batch * attention_flops(hf, seq)


def prefill_flops(hf: dict, batch: int, prompt: int) -> float:
    """Model flops of one prefill: 2 per weight a prompt token passes
    through, the causal attention, and the LM head at the last position
    only (the one whose token is served)."""
    return (2.0 * active_block_params(hf) * batch * prompt
            + 2.0 * head_params(hf) * batch
            + batch * attention_flops(hf, prompt))


def decode_bytes(hf: dict, batch: int, slots: float, routed: float,
                 elem_bytes: int = 2) -> float:
    """Bytes one decode step of ``batch`` tokens must move: every matrix
    read once (the input embedding only where the head is that table: an
    untied step gathers ``batch`` rows of it), of each MoE layer's routed
    experts only ``routed`` (the mean number of distinct experts that the
    step's tokens selected, summed over the MoE layers), and the cache
    read up to ``slots`` positions a sequence and written at one."""
    d, n = hf["hidden_size"], hf["num_hidden_layers"]
    n_moe = _n_moe_layers(hf)
    weights = n * attn_params(hf) + (n - n_moe) * 3 * d * hf["intermediate_size"]
    if n_moe:
        weights += n_moe * (d * hf["n_routed_experts"]
                            + 3 * d * hf["moe_intermediate_size"]
                            * hf.get("n_shared_experts", 0))
        weights += routed * expert_params(hf)
    weights += head_params(hf)
    if not hf.get("tie_word_embeddings"):
        weights += batch * d
    if is_mla(hf):
        per_slot = hf["kv_lora_rank"] + hf["qk_rope_head_dim"]
    else:
        hd = hf.get("head_dim") or d // hf["num_attention_heads"]
        per_slot = 2 * hf["num_key_value_heads"] * hd
    cache = n * batch * (slots + 1) * per_slot
    return (weights + cache) * elem_bytes


def decode_flops(hf: dict, batch: int, slots: float) -> float:
    """Flops of one decode step: 2 per active weight a token, the head,
    and attention over ``slots`` positions (MLA absorbed: over the
    compressed cache)."""
    h, n = hf["num_attention_heads"], hf["num_hidden_layers"]
    if is_mla(hf):
        att = 2 * h * (2 * hf["kv_lora_rank"] + hf["qk_rope_head_dim"])
    else:
        hd = hf.get("head_dim") or hf["hidden_size"] // h
        att = 4 * h * hd
    return batch * (2.0 * (active_block_params(hf) + head_params(hf))
                    + n * att * slots)
