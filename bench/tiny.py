"""Smoke-width cells for the CPU tests: the two configurations' layouts at
widths a test can hold, each traffic mix at a few steps or batches, and
limits set from the readings of those widths on the CPU (the chip's
limits are in ``workloads/``)."""
from __future__ import annotations

import copy

from harness import Cell

LLAMA = {"arch": "smollm-135m", "model_type": "llama", "hidden_size": 64,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 128,
         "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
         "tie_word_embeddings": True, "hidden_act": "silu",
         "initializer_range": 0.02, "dtype": "bfloat16",
         "rope_scaling": None}
DEEPSEEK = {"arch": "deepseek-v2-lite-16b", "model_type": "deepseek_v2",
            "hidden_size": 64, "num_hidden_layers": 3,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "intermediate_size": 128, "moe_intermediate_size": 32,
            "n_routed_experts": 8, "num_experts_per_tok": 2,
            "n_shared_experts": 2, "first_k_dense_replace": 1,
            "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "vocab_size": 256,
            "rms_norm_eps": 1e-6, "rope_theta": 10000,
            "tie_word_embeddings": False, "capacity_factor": 1.25,
            "moe_group_size": 256,
            "initializer_range": 0.02, "hidden_act": "silu",
            "dtype": "bfloat16", "rope_scaling": None, "q_lora_rank": None,
            "scoring_func": "softmax", "topk_method": "greedy",
            "n_group": 1, "topk_group": 1, "norm_topk_prob": False,
            "routed_scaling_factor": 1, "moe_layer_freq": 1}

OPT = {"lr": 3e-4, "warmup": 20, "total_steps": 1000, "min_lr_frac": 0.1,
       "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "clip_norm": 1.0}
TRAIN = {"generator": "train_ckpt", "batch": 2, "seq": 32, "check_steps": 3,
         "save_at": 3, "log_every": 2, "keep": 2, "trace_from": 1,
         "trace_steps": 2, "tiny_grad": 1e-3, "optimizer": OPT,
         "limits": {"loss_gap": 2e-4, "grad_gap": 0.004, "change_gap": 0.002}}
DECODE = {"generator": "serve_batches", "batch": 3, "prompt": 16,
          "new_tokens": 6, "snapshot": True, "keep": 2,
          "sample_batches": 1, "ref_rows": 3, "trace_from": 1,
          "trace_batches": 1, "limits": {"max_gap": 0.003}}
PREFILL = dict(DECODE, prompt=32, new_tokens=1, snapshot=False,
               sample_batches=4, ref_rows=4)

#: the cells in which the CPU tests put the fp8 control in the program's
#: place: more served positions in the check (at smoke widths fp8 moves the
#: first token at about one position in ten), and the dense model drawn
#: wider (at 0.02 its served token is the prompt's last, by the tied
#: embedding, and no rounding moves it); limits from CPU readings of these
#: cells (program: at most 8e-5, 7e-4 and 1.5e-2; control: at least
#: 1.7e-2, 6.4e-3 and 0.10, five seeds each)
CONTROL = [("train", LLAMA, TRAIN),
           ("decode", DEEPSEEK, dict(DECODE, batch=8, new_tokens=8,
                                     ref_rows=8)),
           ("prefill", DEEPSEEK, dict(PREFILL, batch=8, sample_batches=8,
                                      ref_rows=8)),
           ("prefill_dense", dict(LLAMA, initializer_range=0.1),
            dict(PREFILL, batch=8, sample_batches=8, ref_rows=8,
                 limits={"max_gap": 0.05}))]

E2E = {"train_ckpt": ["train_tok_per_s"],
       "serve_batches": ["serve_tok_per_s", "ttft_p95_s.tiny"]}
PER = {"train_ckpt": ["train_mfu", "ckpt_block_s.train",
                      "flash_roofline.train", "idle_share.train"],
       "serve_batches": ["snapshot_s.serve", "decode_step_ms.serve",
                         "decode_bound_share.serve", "idle_share.serve",
                         "prefill_mfu", "idle_share.prefill"]}


def cell(hf: dict, wl: dict, name: str = "tiny") -> Cell:
    kind = wl["generator"]
    e2e = [{"name": n, "unit": "u"} for n in E2E[kind] + ["setup_s"]]
    per = [{"name": n, "unit": "%"} for n in PER[kind]]
    return Cell(name, {"traffic": name, "chips": 1}, copy.deepcopy(hf),
                copy.deepcopy(wl), e2e, per)
