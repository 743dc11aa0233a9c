"""The benchmark's side of the system under test: the program's
configuration built from a configuration file's published keys, and the
weights drawn from the seed.

The program (``repro_torch``) runs each architecture by its registry
entry.  ``program_cfg`` sets every size of that entry from the file, so
the file is what runs, and refuses a file that asks for what the program
cannot do (a mode it has no path for).  ``make_weights`` draws every
matrix of the program's parameter tree in one call on the device, from
the seed, in the dtype it is served or trained in: normal with the
configuration's ``initializer_range`` as its standard deviation (the
published models' own initialisation), norm scales one.
"""
from __future__ import annotations

import dataclasses

import torch

#: published keys whose value has one meaning the program implements
_LLAMA_FIXED = {"hidden_act": "silu", "attention_bias": False,
                "rope_scaling": None, "mlp_bias": False}
_DEEPSEEK_FIXED = {"hidden_act": "silu", "attention_bias": False,
                   "rope_scaling": None, "q_lora_rank": None,
                   "scoring_func": "softmax", "topk_method": "greedy",
                   "n_group": 1, "topk_group": 1, "norm_topk_prob": False,
                   "routed_scaling_factor": 1, "moe_layer_freq": 1}


def program_cfg(hf: dict):
    """The program's ``ArchConfig`` for the configuration file ``hf``: its
    registry entry (``hf["arch"]``) with every size taken from the file."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MLACfg, MoECfg
    base = get_arch(hf["arch"])
    fixed = _DEEPSEEK_FIXED if hf["model_type"] == "deepseek_v2" else \
        _LLAMA_FIXED
    for key, want in fixed.items():
        if key in hf and hf[key] != want:
            raise ValueError(f"{hf['arch']}: {key}={hf[key]!r}: the program "
                             f"implements only {want!r}")
    sizes = dict(n_layers=hf["num_hidden_layers"], d_model=hf["hidden_size"],
                 n_heads=hf["num_attention_heads"],
                 n_kv_heads=hf["num_key_value_heads"],
                 vocab_size=hf["vocab_size"], norm_eps=hf["rms_norm_eps"],
                 rope_theta=float(hf["rope_theta"]),
                 tie_embeddings=bool(hf.get("tie_word_embeddings", False)))
    if hf["model_type"] == "deepseek_v2":
        from repro_torch.models.moe import GROUP_SIZE
        if hf.get("moe_group_size") != GROUP_SIZE:
            raise ValueError(f"{hf['arch']}: moe_group_size="
                             f"{hf.get('moe_group_size')!r}: the program "
                             f"groups {GROUP_SIZE} tokens")
        sizes.update(
            d_ff=hf["moe_intermediate_size"],
            head_dim=hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"],
            moe=MoECfg(n_routed=hf["n_routed_experts"],
                       top_k=hf["num_experts_per_tok"],
                       d_expert=hf["moe_intermediate_size"],
                       n_shared=hf["n_shared_experts"],
                       first_k_dense=hf["first_k_dense_replace"],
                       dense_ff=hf["intermediate_size"],
                       capacity_factor=hf["capacity_factor"]),
            mla=MLACfg(kv_lora_rank=hf["kv_lora_rank"],
                       qk_nope_head_dim=hf["qk_nope_head_dim"],
                       qk_rope_head_dim=hf["qk_rope_head_dim"],
                       v_head_dim=hf["v_head_dim"]))
    elif hf["model_type"] == "llama":
        sizes.update(d_ff=hf["intermediate_size"],
                     head_dim=hf.get("head_dim") or
                     hf["hidden_size"] // hf["num_attention_heads"])
    else:
        raise ValueError(f"model_type {hf['model_type']!r}")
    return dataclasses.replace(base, **sizes)


def make_weights(defs, seed: int, std: float, dtype, device):
    """The parameter tree of ``defs`` (the program's ``Pm`` tree): one
    normal draw of ``std`` from a ``torch.Generator`` on ``device`` seeded
    with ``seed``, in ``dtype``, over one flat buffer of which each matrix
    is a view.  Norm scales (``ones``) and ``zeros`` leaves
    are made as declared (float32)."""
    from repro_torch.models.params import is_pm, tree_leaves
    leaves = tree_leaves(defs, is_leaf=is_pm)
    n = sum(_numel(p) for p in leaves if p.init not in ("ones", "zeros"))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, dtype=dtype, device=device)
    flat.normal_(0.0, std, generator=gen)
    return views(defs, flat)


def views(defs, flat):
    """``defs``' tree over ``flat``: each matrix a view, in the order of
    the tree's leaves."""
    from repro_torch.models.params import tree_map_pm
    off = 0

    def one(p):
        nonlocal off
        if p.init in ("ones", "zeros"):
            fill = torch.ones if p.init == "ones" else torch.zeros
            return fill(p.shape, dtype=p.dtype, device=flat.device)
        t = flat[off:off + _numel(p)].view(p.shape)
        off += _numel(p)
        return t
    return tree_map_pm(one, defs)


def _numel(p) -> int:
    n = 1
    for s in p.shape:
        n *= s
    return n
