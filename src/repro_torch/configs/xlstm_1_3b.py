"""xLSTM-1.3B — sLSTM + mLSTM blocks, ratio 7:1 (xLSTM[7:1]).
[arXiv:2405.04517; unverified]  48L d_model=2048 4H d_ff=0 vocab=50304.

d_ff=0 in the assignment: blocks carry their own up/down projections
(mLSTM proj-factor 2; sLSTM with a 4/3 gated FFN).  48 layers = 6 repeating
units of (7 mLSTM, 1 sLSTM).  O(1) recurrent state -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    proj_factor=2.0,
    subquadratic=True,
    source="arXiv:2405.04517 xLSTM[7:1]",
)
