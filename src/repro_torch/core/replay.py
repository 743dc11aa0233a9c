"""Administrative-message log + replay (paper §4).

Administrative messages are "messages between the rank and the MPI
coordinator to either retrieve information about the current configuration
... or to create new configurations".  They are LOGGED during execution and
REPLAYED against a fresh proxy on restart, so the new active library reaches
the same state as at checkpoint time — regardless of which transport backs
it.  Message *actions* (recv/probe) are NOT logged; they are served by the
drained-message cache (drain.py).

Elastic restart adds a REMAP step before replay: world-rank references in
the log are rewritten through the old→new rank map, and records touching a
configuration that did not survive the reshape (a comm/group with a dead
member) are dropped — including their later frees (DESIGN.md §8)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Set, Tuple

from repro_torch.core.virtualization import RankMap, remap_rank_tuple


@dataclass(frozen=True)
class AdminRecord:
    op: str                     # init | comm_create | comm_split | group_* | comm_free ...
    args: tuple
    vid: int                    # virtual id assigned at record time (-1 if n/a)


@dataclass
class AdminLog:
    records: List[AdminRecord] = field(default_factory=list)

    def append(self, op: str, args: tuple, vid: int = -1) -> None:
        self.records.append(AdminRecord(op, tuple(args), vid))

    def snapshot(self) -> list:
        return [(r.op, r.args, r.vid) for r in self.records]

    @staticmethod
    def restore(items: list) -> "AdminLog":
        return AdminLog([AdminRecord(op, tuple(a), v) for op, a, v in items])

    def remap(self, rank_map: RankMap, new_rank: int,
              new_n: int) -> "AdminLog":
        """World-remapped copy for an elastic restart: `init` is rewritten
        to the surviving rank's NEW identity; comm/group creation records
        have their member tuples remapped, or are dropped (together with
        their frees) when a member did not survive."""
        out: List[AdminRecord] = []
        # comm and group vids are separate (overlapping) namespaces: a
        # dropped group vid must not suppress a surviving comm's free
        dropped_comms: Set[int] = set()
        dropped_groups: Set[int] = set()
        for r in self.records:
            if r.op == "init":
                out.append(AdminRecord("init", (new_rank, new_n), r.vid))
            elif r.op in ("comm_create", "group_incl"):
                new_ranks = remap_rank_tuple(tuple(r.args[0]), rank_map)
                if new_ranks is None:
                    (dropped_comms if r.op == "comm_create"
                     else dropped_groups).add(r.vid)
                    continue
                out.append(AdminRecord(r.op, (new_ranks,), r.vid))
            elif r.op == "comm_free":
                if r.vid in dropped_comms:
                    continue
                out.append(r)
            elif r.op == "group_free":
                if r.vid in dropped_groups:
                    continue
                out.append(r)
            else:
                out.append(r)
        return AdminLog(out)

    def replay(self, vids, proxy) -> None:
        """Re-execute configuration ops against fresh virtual-id tables and a
        fresh proxy.  The proxy is told about comm layouts so its (new,
        possibly different) active transport can address peers."""
        for r in self.records:
            if r.op == "init":
                proxy.register_rank(*r.args)
            elif r.op == "comm_create":
                vids.new_comm(tuple(r.args[0]), vid=r.vid)
                proxy.register_comm(r.vid, tuple(r.args[0]))
            elif r.op == "group_incl":
                vids.new_group(tuple(r.args[0]), vid=r.vid)
            elif r.op == "comm_free":
                vids.free_comm(r.vid)
                proxy.unregister_comm(r.vid)
            elif r.op == "group_free":
                vids.free_group(r.vid)
            elif r.op == "finalize":
                pass
            else:
                raise ValueError(f"unknown admin op {r.op!r}")
