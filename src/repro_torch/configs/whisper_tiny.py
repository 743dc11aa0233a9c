"""Whisper-tiny — encoder-decoder audio backbone; conv frontend is a STUB per
the assignment (input_specs() provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]  4L d_model=384 6H (MHA) d_ff=1536 vocab=51865.

Shapes interpret seq_len as the DECODER length (the backbone spec); the
encoder runs its fixed 1500 frames."""
from repro_torch.configs.base import ArchConfig, EncoderCfg

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    norm="ln",
    pos_emb="learned",
    mlp="gelu",
    act="gelu",
    tie_embeddings=True,
    encoder=EncoderCfg(n_layers=4, n_frames=1500),
    source="arXiv:2212.04356",
)
