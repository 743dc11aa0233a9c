"""Deterministic synthetic token pipeline with a checkpointable cursor and
a drainable prefetch queue: the port's own copy of ``repro.data.pipeline``
(numpy only; the port imports nothing of ``repro``).  Batch k is
byte-equal to the reference's for the same (seed, k), so a run resumed in
either package reads the same data.

The cursor counts CONSUMED batches — the pipeline's entire state is
(seed, cursor), so the checkpoint is one integer.  Prefetched-but-unconsumed
batches are handled per the paper's drain semantics: ``snapshot`` can either
CACHE them (paper-faithful: they are 'in-flight messages' from the producer
thread) or DROP them and regenerate deterministically (equivalent here by
construction; both modes tested).  Batches are Philox-counter generated so
batch k is identical no matter when/where it is produced.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, prefetch: int = 2):
        self.vocab = vocab_size
        self.batch = global_batch
        self.seq = seq_len
        self.seed = seed
        self.cursor = 0                      # consumed batches
        self.prefetch_depth = prefetch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._producer: Optional[threading.Thread] = None
        self._produced = 0                   # batches pushed to the queue
        self._stop = threading.Event()

    # ----------------------------------------------------------- generation
    def _gen(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=index))
        tokens = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                              dtype=np.int64).astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    # ------------------------------------------------------------- prefetch
    def start(self) -> None:
        if self._producer is not None:
            return
        self._stop.clear()
        self._produced = self.cursor + self._q.qsize()  # after inflight restore

        def _produce():
            while not self._stop.is_set():
                idx = self._produced
                batch = self._gen(idx)
                while not self._stop.is_set():
                    try:
                        self._q.put((idx, batch), timeout=0.05)
                        self._produced += 1
                        break
                    except queue.Full:
                        continue

        self._producer = threading.Thread(target=_produce, daemon=True,
                                          name="data-prefetch")
        self._producer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._producer is not None:
            self._producer.join(timeout=2)
            self._producer = None
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self._producer is None:
            batch = self._gen(self.cursor)
            self.cursor += 1
            return batch
        idx, batch = self._q.get()
        assert idx == self.cursor, f"out-of-order batch {idx} != {self.cursor}"
        self.cursor += 1
        return batch

    # ------------------------------------------------------------ checkpoint
    def snapshot(self, cache_inflight: bool = False) -> dict:
        snap = {"seed": self.seed, "cursor": self.cursor,
                "vocab": self.vocab, "batch": self.batch, "seq": self.seq}
        if cache_inflight:
            # paper-faithful: drain the queue into the snapshot
            cached = []
            while True:
                try:
                    cached.append(self._q.get_nowait())
                except queue.Empty:
                    break
            snap["inflight"] = [(i, {k: v.copy() for k, v in b.items()})
                                for i, b in cached]
        return snap

    @classmethod
    def restore(cls, snap: dict, prefetch: int = 2) -> "TokenPipeline":
        inflight = snap.get("inflight", [])
        # queue must hold every cached in-flight batch or restore deadlocks
        p = cls(snap["vocab"], snap["batch"], snap["seq"], seed=snap["seed"],
                prefetch=max(prefetch, len(inflight) + 1))
        p.cursor = snap["cursor"]
        for i, b in inflight:
            p._q.put((i, b))
            p._produced = i + 1
        return p
