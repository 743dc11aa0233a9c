"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA (kv_lora=512) + MoE.
[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff(expert)=1408 vocab=102400,
64 routed experts top-6 + 2 shared, first layer dense (d_ff=10944).

NOTE (DESIGN.md §5): the assignment line mentions both "64e" and "160 routed";
160 belongs to full DeepSeek-V2 — the V2-Lite HF config has 64 routed and we
follow it.  Group-limited routing is simplified to plain top-k (noted)."""
from repro_torch.configs.base import ArchConfig, MoECfg, MLACfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=192,            # qk_nope(128) + qk_rope(64)
    mlp="swiglu",
    moe=MoECfg(n_routed=64, top_k=6, d_expert=1408, n_shared=2,
               first_k_dense=1, dense_ff=10944),
    mla=MLACfg(kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434 (V2-Lite)",
)
