"""Membership of the world (the port's own copy of the generation
service of ``repro.core.coordinator``, without its checkpoint FSM).

The world's shape is an epoch called the *generation*.  A dead or removed
rank bumps the generation; any message stamped with a stale generation is
rejected with ``StaleGenerationError``, so a zombie of a previous
incarnation cannot corrupt a restarted world.  ``distributed.elastic``
bumps it once per reshape."""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple


class StaleGenerationError(RuntimeError):
    """A message stamped with a superseded membership generation."""


class Membership:
    """Generation-based membership: which world shape is current.

    A Membership object OUTLIVES any single job: its supervisor owns one and
    threads it through restarts, so a rank checkpointed in generation g can
    never ack, propose or report into generation g+1.
    """

    def __init__(self, world_size: int, generation: int = 0):
        self._lock = threading.Lock()
        self.world_size = world_size
        self.generation = generation
        #: (generation, world_size, dead_ranks) per epoch, oldest first
        self.history: List[Tuple[int, int, Tuple[int, ...]]] = [
            (generation, world_size, ())]

    def bump(self, dead: Sequence[int] = (),
             world_size: Optional[int] = None) -> int:
        """Start a new membership epoch: remove `dead`, adopt `world_size`
        (default: shrink by the number of dead ranks).  Returns the new
        generation."""
        with self._lock:
            if world_size is None:
                world_size = self.world_size - len(set(dead))
            if world_size < 1:
                raise ValueError(
                    f"membership bump would leave world_size={world_size}")
            self.generation += 1
            self.world_size = world_size
            self.history.append(
                (self.generation, world_size, tuple(sorted(set(dead)))))
            return self.generation

    def check(self, generation: Optional[int]) -> None:
        """Reject a stale-generation message (None = unstamped, accepted:
        intra-job calls are implicitly current)."""
        if generation is None:
            return
        with self._lock:
            if generation != self.generation:
                raise StaleGenerationError(
                    f"message from generation {generation} rejected: "
                    f"current generation is {self.generation} "
                    f"(world_size={self.world_size})")
