"""SmolLM-135M — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    rope_theta=10000.0,
    mlp="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
