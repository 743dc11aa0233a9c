"""One shared location for env-tunable size knobs (DESIGN.md §14.6).

The names are the reference's, so one setting governs both packages:

  REPRO_ALLREDUCE_RING_MIN_BYTES   Allreduce crossover: ndarray payloads
                                   at least this large use the ring
                                   (bandwidth-optimal reduce-scatter +
                                   allgather), smaller ones the binomial
                                   tree (latency-optimal).  Default 8 MiB
                                   — all ranks share one GIL here so
                                   serialization is effectively a shared
                                   resource; real clusters set this far
                                   lower.
  REPRO_SHMRING_MIN_BYTES          shm tensor-ring crossover: proc-world
                                   payloads at least this large park in
                                   the shared-memory ring and the frame
                                   carries a descriptor; smaller ones
                                   ship inline.  Default 256 KiB.
                                   REPRO_RING_MIN_BYTES is an accepted
                                   alias.
  REPRO_LEDGER                     "0" disables the ContributionLedger
                                   (collective inputs are not pinned;
                                   mid-collective recovery always falls
                                   back to rollback-restart).
  REPRO_LEDGER_OPS                 max in-flight collective ops pinned
                                   per job (default 4; oldest evicted).
  REPRO_CHUNK_RETRIES              RemoteChunkStore connection-layer
                                   retry budget per request (default 4
                                   attempts total); every chunk-service
                                   command is idempotent, so a torn
                                   socket is safely re-dialed and
                                   replayed.
  REPRO_CHUNK_RETRY_BASE_S         first-retry backoff (default 0.05 s);
                                   doubles per attempt, ±50% jitter so a
                                   fleet of ranks doesn't re-dial a
                                   restarting server in lockstep.
  REPRO_CHUNK_OOB_MIN              chunk-service blobs at least this large
                                   ride as pickle protocol-5 out-of-band
                                   buffers (zero-copy scatter-gather) in
                                   both wire directions; smaller ones are
                                   cheaper in-band.  Default 64 KiB.
  REPRO_CHUNK_LEASE_TTL_S          default TTL for a client's automatic
                                   live-set lease on the server (default
                                   600 s) — long enough to bridge several
                                   save/gc rounds, short enough that a
                                   dead client's pin drains on its own.
  REPRO_CHUNK_PREFETCH_BATCH       chunks per get_many round trip when a
                                   restore prefetches its working set
                                   (default 32): bounds the size of any
                                   one reply buffer, and for a sharded
                                   store each batch fans out per shard.
  REPRO_REPLICAS                   how many shard endpoints each chunk is
                                   written to when a StoreSpec doesn't
                                   say (default 2, clamped to the shard
                                   count).  REPRO_SHARD_REPLICAS is an
                                   accepted alias.
  REPRO_SHARD_FANOUT               max concurrent per-shard requests one
                                   ShardedChunkStore issues (default 8;
                                   also clamped to the shard count).
  REPRO_SHARD_RETRY_S              mark-down cooldown after a shard's
                                   retry budget is exhausted (default
                                   3 s): the shard is skipped — writes
                                   degrade to surviving replicas, reads
                                   fail over — until the cooldown
                                   elapses and one probe re-tests it, so
                                   a dead server costs one backoff
                                   ladder, not one per chunk.
  REPRO_TRACE                      "0" disables the flight recorder and
                                   span emission entirely (core/trace.py
                                   compiles to no-ops).  Default on: the
                                   CI-gated overhead budget keeps span
                                   granularity cheap enough to leave on.
  REPRO_TRACE_DIR                  where per-process flight-recorder
                                   rings are dumped on fault/abort/exit
                                   (and by MPIJob.dump_trace()).  Unset
                                   means automatic dumps are off;
                                   explicit dump_trace() calls can still
                                   pass a directory.  Read at dump time,
                                   not import time, so tests and forked
                                   rank children see live changes.
  REPRO_TRACE_RING                 flight-recorder capacity in events
                                   per process (default 4096; oldest
                                   evicted).  Bounds both memory and
                                   dump size no matter how long a world
                                   runs.
  REPRO_METRICS_HIST_BUCKETS       bucket count for metrics histograms
                                   (default 12 exponential buckets);
                                   label sets and bucket counts are both
                                   bounded so a misbehaving caller
                                   cannot grow the registry without
                                   limit.
"""
from __future__ import annotations

import os


def env_bytes(name: str, default: int, aliases: tuple = ()) -> int:
    """Read a byte-count knob from the environment, first name wins."""
    for key in (name,) + tuple(aliases):
        raw = os.environ.get(key)
        if raw is not None:
            return int(raw)
    return default


def env_float(name: str, default: float, aliases: tuple = ()) -> float:
    """Read a float knob from the environment, first name wins."""
    for key in (name,) + tuple(aliases):
        raw = os.environ.get(key)
        if raw is not None:
            return float(raw)
    return default


def env_int(name: str, default: int, aliases: tuple = ()) -> int:
    """Read an integer knob from the environment, first name wins."""
    for key in (name,) + tuple(aliases):
        raw = os.environ.get(key)
        if raw is not None:
            return int(raw)
    return default


#: Allreduce ring/tree algorithm crossover (core/api.py)
ALLREDUCE_RING_MIN_BYTES = env_bytes("REPRO_ALLREDUCE_RING_MIN_BYTES", 1 << 23)

#: shm tensor-ring inline/ring payload crossover (core/dataplane.py)
SHMRING_MIN_BYTES = env_bytes("REPRO_SHMRING_MIN_BYTES", 1 << 18,
                              aliases=("REPRO_RING_MIN_BYTES",))

#: mid-collective recovery ledger (core/dataplane.py ContributionLedger)
LEDGER_ENABLED = os.environ.get("REPRO_LEDGER", "1") != "0"
LEDGER_MAX_OPS = env_int("REPRO_LEDGER_OPS", 4)

#: RemoteChunkStore reconnect policy (checkpoint/chunkservice.py)
CHUNK_RETRIES = env_int("REPRO_CHUNK_RETRIES", 4)
CHUNK_RETRY_BASE_S = env_float("REPRO_CHUNK_RETRY_BASE_S", 0.05)

#: chunk-service wire crossover + lease/prefetch knobs (chunkservice.py)
CHUNK_OOB_MIN = env_bytes("REPRO_CHUNK_OOB_MIN", 1 << 16)
CHUNK_LEASE_TTL_S = env_float("REPRO_CHUNK_LEASE_TTL_S", 600.0)
CHUNK_PREFETCH_BATCH = env_int("REPRO_CHUNK_PREFETCH_BATCH", 32)

#: sharded chunk-store tier (checkpoint/chunkservice.py ShardedChunkStore)
SHARD_REPLICAS = env_int("REPRO_REPLICAS", 2,
                         aliases=("REPRO_SHARD_REPLICAS",))
SHARD_FANOUT = env_int("REPRO_SHARD_FANOUT", 8)
SHARD_RETRY_S = env_float("REPRO_SHARD_RETRY_S", 3.0)

#: flight recorder + tracing (core/trace.py)
TRACE_ENABLED = os.environ.get("REPRO_TRACE", "1") != "0"
TRACE_RING = env_int("REPRO_TRACE_RING", 4096)


def trace_dir():
    """REPRO_TRACE_DIR, read live (dump time) rather than at import so
    monkeypatched tests and forked rank children agree on the target."""
    return os.environ.get("REPRO_TRACE_DIR") or None


#: metrics registry histograms (core/metrics.py)
METRICS_HIST_BUCKETS = env_int("REPRO_METRICS_HIST_BUCKETS", 12)
