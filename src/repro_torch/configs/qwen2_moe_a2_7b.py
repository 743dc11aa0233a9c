"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + shared expert (4x width,
sigmoid-gated).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (MHA) d_ff(expert)=1408
vocab=151936; shared_expert_intermediate 5632 = 4 x 1408 ("4 shared")."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    mlp="swiglu",
    moe=MoECfg(n_routed=60, top_k=4, d_expert=1408, n_shared=4,
               shared_gate=True),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
