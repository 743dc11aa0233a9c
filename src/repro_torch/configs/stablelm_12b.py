"""StableLM-2-12B — partial rotary (25%), per-head qk-norm.
[hf:stabilityai/stablelm-2-12b family; hf]  40L d_model=5120 32H (GQA kv=8)
d_ff=13824 vocab=100352."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    norm="ln",
    rope_pct=0.25,
    qk_norm=True,
    mlp="swiglu",
    source="hf:stabilityai/stablelm-2-12b",
)
