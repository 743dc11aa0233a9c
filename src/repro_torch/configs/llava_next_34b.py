"""LLaVA-NeXT-34B — VLM: yi-34b-class LM backbone; anyres vision frontend is a
STUB per the assignment (input_specs() provides precomputed patch embeddings,
576 tokens, merged at the sequence head).
[hf:llava-hf/llava-v1.6 family; unverified]  60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
    mlp="swiglu",
    n_vision_tokens=576,
    source="hf:llava-hf/llava-v1.6 (34b backbone)",
)
