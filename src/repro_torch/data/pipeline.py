"""Deterministic synthetic token pipeline with a checkpointable cursor:
the port's own copy of ``repro.data.pipeline`` (numpy only; the port
imports nothing of ``repro``).  Batch k is byte-equal to the reference's
for the same (seed, k), so a run resumed in either package reads the same
data.

The cursor counts CONSUMED batches — the pipeline's entire state is
(seed, cursor), so the checkpoint is one integer.  Batches are
Philox-counter generated, so batch k is identical no matter when or where
it is produced.  The reference's prefetch thread and its in-flight cache
are left out: the port's loop draws each batch when it needs it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = global_batch
        self.seq = seq_len
        self.seed = seed
        self.cursor = 0                      # consumed batches

    def _gen(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=index))
        tokens = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                              dtype=np.int64).astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def next_batch(self) -> Dict[str, np.ndarray]:
        batch = self._gen(self.cursor)
        self.cursor += 1
        return batch

    def snapshot(self) -> dict:
        return {"seed": self.seed, "cursor": self.cursor,
                "vocab": self.vocab, "batch": self.batch, "seq": self.seq}
