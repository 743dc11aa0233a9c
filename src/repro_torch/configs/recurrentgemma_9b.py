"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; window 2048; head_dim 256; GeGLU MLP.

38 layers = 12 x (rglru, rglru, local_attn) + 2 trailing rglru blocks.
Bounded state (RG-LRU h + 2048-window KV) -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp="geglu",
    act="gelu",
    block_pattern=("rglru", "rglru", "local_attn"),
    pattern_tail=("rglru", "rglru"),
    window=2048,
    d_rnn=4096,
    conv_width=4,
    subquadratic=True,
    source="arXiv:2402.19427",
)
