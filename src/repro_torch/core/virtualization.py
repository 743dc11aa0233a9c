"""Virtual id tables (paper §7): communicators, groups and requests are
exposed to the application as small integers that survive checkpoint /
restart and transport switches; the mapping to live backend objects is
rebuilt by admin-log replay.

World remap (elastic restart, DESIGN.md §8): when the world is reshaped
(dead rank removed, replacement added, grown), every world-rank reference
inside a checkpointed table is rewritten through an old→new rank map.
Comms/groups whose member set fully survives the reshape are kept (ranks
remapped); any referencing a dead rank are DROPPED — the application sees
a KeyError if it uses them, exactly like a real revoked communicator."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

WORLD_VID = 0


#: old world rank -> new world rank (None = the rank did not survive)
RankMap = Dict[int, Optional[int]]


def make_rank_map(old_n: int, new_n: int,
                  dead: Tuple[int, ...] = ()) -> RankMap:
    """Canonical old→new mapping for a reshape: survivors keep their order
    and compact down over the holes left by dead ranks; survivors beyond
    the new world size are dropped (shrink past the death count)."""
    survivors = [r for r in range(old_n) if r not in set(dead)]
    out: RankMap = {r: None for r in range(old_n)}
    for i, r in enumerate(survivors):
        out[r] = i if i < new_n else None
    return out


def remap_rank_tuple(ranks: Tuple[int, ...],
                     rank_map: RankMap) -> Optional[Tuple[int, ...]]:
    """Remapped member tuple, or None if any member did not survive."""
    out = []
    for r in ranks:
        nr = rank_map.get(r)
        if nr is None:
            return None
        out.append(nr)
    return tuple(out)


def remap_vids_snapshot(snap: dict, rank_map: RankMap,
                        new_n: int) -> Tuple[dict, Set[int]]:
    """Rewrite a VirtualIds.snapshot() for a reshaped world.  Returns the
    new snapshot plus the set of DROPPED COMM vids (so the cache, pending
    recvs and collective sequence tables can drop matching state
    consistently).  Comm and group vids are SEPARATE namespaces — both
    counters start at 1 — so dropped group vids must never leak into the
    comm-keyed filter.  COMM_WORLD is special: always rebuilt as
    range(new_n)."""
    dropped_comms: Set[int] = set()
    comms: Dict[int, Tuple[int, ...]] = {}
    for v, ranks in snap["comms"].items():
        v = int(v)
        if v == WORLD_VID:
            comms[v] = tuple(range(new_n))
            continue
        new_ranks = remap_rank_tuple(tuple(ranks), rank_map)
        if new_ranks is None:
            dropped_comms.add(v)
        else:
            comms[v] = new_ranks
    groups: Dict[int, Tuple[int, ...]] = {}
    for v, ranks in snap["groups"].items():
        v = int(v)
        new_ranks = remap_rank_tuple(tuple(ranks), rank_map)
        if new_ranks is not None:
            groups[v] = new_ranks
    pending = []
    for vid, src, tag, comm_vid in snap["pending_recvs"]:
        if comm_vid in dropped_comms:
            continue
        new_src = src if src < 0 else rank_map.get(src)   # ANY_SOURCE < 0
        if new_src is None:
            continue                 # the sender died with the old world
        pending.append((vid, new_src, tag, comm_vid))
    return ({"comms": comms, "groups": groups, "pending_recvs": pending,
             "next": snap["next"]}, dropped_comms)


@dataclass(frozen=True)
class CommInfo:
    vid: int
    ranks: Tuple[int, ...]        # world ranks, ordered

    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, world_rank: int) -> int:
        return self.ranks.index(world_rank)

    def world_rank(self, comm_rank: int) -> int:
        return self.ranks[comm_rank]


@dataclass(frozen=True)
class GroupInfo:
    vid: int
    ranks: Tuple[int, ...]


@dataclass
class RequestInfo:
    vid: int
    kind: str                    # "send" | "recv"
    src: int                     # world rank (recv side) / self (send side)
    tag: int
    comm_vid: int
    done: bool = False
    value: object = None
    status: object = None


class VirtualIds:
    """Per-rank table; contents are checkpointed verbatim (pure data)."""

    def __init__(self, n_ranks: int):
        self.comms: Dict[int, CommInfo] = {
            WORLD_VID: CommInfo(WORLD_VID, tuple(range(n_ranks)))}
        self.groups: Dict[int, GroupInfo] = {}
        self.requests: Dict[int, RequestInfo] = {}
        self._next_comm = 1
        self._next_group = 1
        self._next_req = 1

    def new_comm(self, ranks: Tuple[int, ...],
                 vid: Optional[int] = None) -> CommInfo:
        if vid is None:
            vid = self._next_comm
        info = CommInfo(vid, tuple(ranks))
        self.comms[vid] = info
        self._next_comm = max(self._next_comm, vid + 1)
        return info

    def new_group(self, ranks: Tuple[int, ...],
                  vid: Optional[int] = None) -> GroupInfo:
        if vid is None:
            vid = self._next_group
        info = GroupInfo(vid, tuple(ranks))
        self.groups[vid] = info
        self._next_group = max(self._next_group, vid + 1)
        return info

    def new_request(self, kind, src, tag, comm_vid) -> RequestInfo:
        info = RequestInfo(self._next_req, kind, src, tag, comm_vid)
        self.requests[info.vid] = info
        self._next_req += 1
        return info

    def free_comm(self, vid: int) -> None:
        if vid == WORLD_VID:
            raise ValueError("cannot free MPI_COMM_WORLD")
        self.comms.pop(vid, None)

    def shrink_world(self, dead: Set[int]) -> None:
        """In-place world shrink (mid-collective recovery, DESIGN.md §14):
        drop `dead` from every communicator and group WITHOUT renumbering
        the survivors — world-rank ids stay sparse, comm ranks compact
        naturally through ``rank_of``.  (Contrast with the restart-time
        ``remap_vids_snapshot``, which compacts world ranks densely.)"""
        dead = set(dead)
        for vid, c in list(self.comms.items()):
            if set(c.ranks) & dead:
                self.comms[vid] = CommInfo(
                    vid, tuple(r for r in c.ranks if r not in dead))
        for vid, g in list(self.groups.items()):
            if set(g.ranks) & dead:
                self.groups[vid] = GroupInfo(
                    vid, tuple(r for r in g.ranks if r not in dead))

    def free_group(self, vid: int) -> None:
        self.groups.pop(vid, None)

    # --- checkpoint payload -------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "comms": {v: tuple(c.ranks) for v, c in self.comms.items()},
            "groups": {v: tuple(g.ranks) for v, g in self.groups.items()},
            "pending_recvs": [
                (r.vid, r.src, r.tag, r.comm_vid)
                for r in self.requests.values()
                if r.kind == "recv" and not r.done],
            "next": (self._next_comm, self._next_group, self._next_req),
        }

    def restore(self, snap: dict, n_ranks: int) -> None:
        self.comms = {int(v): CommInfo(int(v), tuple(r))
                      for v, r in snap["comms"].items()}
        self.groups = {int(v): GroupInfo(int(v), tuple(r))
                       for v, r in snap["groups"].items()}
        self.requests = {}
        for vid, src, tag, comm_vid in snap["pending_recvs"]:
            self.requests[vid] = RequestInfo(vid, "recv", src, tag, comm_vid)
        self._next_comm, self._next_group, self._next_req = snap["next"]
