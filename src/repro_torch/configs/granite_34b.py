"""Granite-34B-Code — GPT-BigCode arch: MQA, learned positions, GELU MLP.
[arXiv:2405.04324; hf]  88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    norm="ln",
    pos_emb="learned",
    mlp="gelu",
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2405.04324 (gpt_bigcode)",
)
