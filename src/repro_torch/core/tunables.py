"""Environment knobs of the port's chunk service (copy of the chunk-store
half of ``repro.core.tunables``).

The names are the reference's, so one setting governs both packages:

  REPRO_CHUNK_RETRIES              RemoteChunkStore connection-layer
                                   retry budget per request (default 4
                                   attempts total); every chunk-service
                                   command is idempotent, so a torn
                                   socket is safely re-dialed and
                                   replayed.
  REPRO_CHUNK_RETRY_BASE_S         first-retry backoff (default 0.05 s);
                                   doubles per attempt, ±50% jitter so a
                                   fleet of clients doesn't re-dial a
                                   restarting server in lockstep.
  REPRO_CHUNK_OOB_MIN              chunk-service blobs at least this large
                                   ride as pickle protocol-5 out-of-band
                                   buffers (zero-copy scatter-gather) in
                                   both wire directions; smaller ones are
                                   cheaper in-band.  Default 64 KiB.
  REPRO_CHUNK_LEASE_TTL_S          default TTL for a client's automatic
                                   live-set lease on the server (default
                                   600 s).
  REPRO_CHUNK_PREFETCH_BATCH       chunks per get_many round trip when a
                                   restore prefetches its working set
                                   (default 32).
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
                                   3 s): the shard is skipped until the
                                   cooldown elapses and one probe
                                   re-tests it.

The reference's knobs of the MPI runtime (collective crossovers, the
contribution ledger) and of its trace dumps are not copied: the port has
neither.
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
