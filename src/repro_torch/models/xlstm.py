"""xLSTM pieces (torch twin of part of ``repro.models.xlstm``).

Only the depthwise causal conv is here, because the RG-LRU block uses it
(``models/rglru.py``), as in the reference.  The mLSTM and sLSTM blocks
wait for ROADMAP.md, Queue 1, item 5 (the other families).
"""
from __future__ import annotations

import torch


def _causal_conv(u, w, state=None):
    """Depthwise causal conv. u (B,S,F), w (cw,F). state (B,cw-1,F) or None."""
    cw = w.shape[0]
    pad = state if state is not None else torch.zeros(
        (u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(cw))
    return out, up[:, -(cw - 1):]                    # (B,S,F), new state
