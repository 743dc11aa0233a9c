"""Network drain + drained-message cache (paper §4, challenge 1).

At checkpoint time every rank pumps its proxy until the coordinator sees
GLOBAL sent == received (the counter heuristic from Cao's thesis [5]);
everything pumped out of the network lands in this per-rank MessageCache,
which is checkpointed with the application and consulted FIRST by
Recv/Probe/Iprobe after restart (and during normal operation — an envelope
that arrived while the app was busy lives here too).

On an ELASTIC restart the cached envelopes are world-remapped: src/dst
ranks rewritten through the old→new map, and envelopes that reference a
dead rank or a dropped communicator are discarded (their sender no longer
exists in the new world — DESIGN.md §8)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Set

from repro_torch.core.messages import ANY_SOURCE, ANY_TAG, Envelope


@dataclass
class MessageCache:
    envelopes: List[Envelope] = field(default_factory=list)

    def put(self, env: Envelope) -> None:
        self.envelopes.append(env)

    def put_many(self, envs: List[Envelope]) -> None:
        """Bulk-poll landing zone: one extend per drained batch."""
        self.envelopes.extend(envs)

    def match(self, src: int, tag: int, comm_vid: int,
              remove: bool = True) -> Optional[Envelope]:
        """First matching envelope in arrival order (MPI matching rules:
        ANY_SOURCE / ANY_TAG wildcards; per-(src,comm) order preserved)."""
        for i, env in enumerate(self.envelopes):
            if env.comm_vid != comm_vid:
                continue
            if src != ANY_SOURCE and env.src != src:
                continue
            if tag != ANY_TAG and env.tag != tag:
                continue
            return self.envelopes.pop(i) if remove else env
        return None

    def __len__(self) -> int:
        return len(self.envelopes)

    def snapshot(self) -> list:
        return [e.to_bytes() for e in self.envelopes]

    @staticmethod
    def restore(items: list) -> "MessageCache":
        return MessageCache([Envelope.from_bytes(b) for b in items])


def remap_cache_snapshot(items: list, rank_map: dict,
                         dropped_comms: Iterable[int] = ()) -> list:
    """World-remap a MessageCache.snapshot() for an elastic restart.
    Envelopes whose src or dst did not survive, or whose communicator was
    dropped by the reshape, are discarded."""
    dropped: Set[int] = set(dropped_comms)
    out: list = []
    for b in items:
        env = Envelope.from_bytes(b)
        if env.comm_vid in dropped:
            continue
        src = rank_map.get(env.src)
        dst = rank_map.get(env.dst)
        if src is None or dst is None:
            continue
        out.append(dataclasses.replace(env, src=src, dst=dst).to_bytes())
    return out
