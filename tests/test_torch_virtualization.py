"""The port's virtual-id tables, admin-log replay and world remap
(``repro_torch.core.{virtualization,replay,drain,api}``) and its
``plan_summary``, against the reference's: twins of
tests/test_virtualization.py.

What one package snapshots, the other restores: a vids snapshot and an
admin log are pickled by one package, loaded and replayed by the other,
and the rebuilt tables equal those the writer rebuilds itself.  The remap
helpers give the reference's outputs for the same inputs, byte for byte
where they return envelopes."""
import pickle

import numpy as np
import pytest
import torch

from repro.core import api as r_api
from repro.core import drain as r_drain
from repro.core import replay as r_replay
from repro.core import virtualization as r_virt
from repro.core.messages import Envelope as REnvelope
from repro_torch.core import replay as t_replay
from repro_torch.core import virtualization as t_virt
from repro_torch.core.api import remap_mpi_snapshot
from repro_torch.core.drain import remap_cache_snapshot
from repro_torch.core.messages import ANY_SOURCE, Envelope
from repro_torch.core.replay import AdminLog
from repro_torch.core.virtualization import (WORLD_VID, VirtualIds,
                                             make_rank_map, remap_rank_tuple,
                                             remap_vids_snapshot)


class FakeProxy:
    """Records the configuration calls replay makes (stand-in for the
    channel-backed proxy facade)."""

    def __init__(self):
        self.ranks = []
        self.comms = {}

    def register_rank(self, rank, n):
        self.ranks.append((rank, n))

    def register_comm(self, vid, ranks):
        self.comms[vid] = tuple(ranks)

    def unregister_comm(self, vid):
        self.comms.pop(vid, None)


def _tables(vids):
    return ({v: tuple(c.ranks) for v, c in vids.comms.items()},
            {v: tuple(g.ranks) for v, g in vids.groups.items()},
            sorted((r.vid, r.kind, r.src, r.tag, r.comm_vid)
                   for r in vids.requests.values()))


def _across(snap):
    """`snap` pickled and loaded back: what the other package reads."""
    return pickle.loads(pickle.dumps(snap))


# ------------------------------------------------- snapshot/restore churn

def _churned(mod):
    v = mod.VirtualIds(4)
    c1 = v.new_comm((0, 1))
    c2 = v.new_comm((1, 2, 3))
    g1 = v.new_group((0, 2))
    v.new_request("recv", 3, 7, c2.vid)
    done = v.new_request("recv", 1, 2, c1.vid)
    done.done = True                       # completed: not checkpointed
    v.free_comm(c1.vid)                    # create-free churn
    v.free_group(g1.vid)
    g2 = v.new_group((1, 3))
    return v, c2, g2


def test_vids_snapshot_restore_roundtrip_under_churn():
    v, c2, g2 = _churned(r_virt)
    ours, _, _ = _churned(t_virt)
    snap = ours.snapshot()
    assert snap == v.snapshot()            # the same tables, same counters

    r = VirtualIds(4)
    r.restore(_across(snap), 4)
    assert set(r.comms) == {WORLD_VID, c2.vid}
    assert r.comms[c2.vid].ranks == (1, 2, 3)
    assert set(r.groups) == {g2.vid}
    pend = list(r.requests.values())
    assert len(pend) == 1 and pend[0].src == 3 and pend[0].tag == 7
    # each package restores the other's snapshot to the same tables
    theirs = r_virt.VirtualIds(4)
    theirs.restore(_across(snap), 4)
    mine = VirtualIds(4)
    mine.restore(_across(v.snapshot()), 4)
    assert _tables(theirs) == _tables(r) == _tables(mine)
    # id allocators continue past the churn (no vid reuse after restore)
    assert r.new_comm((0, 3)).vid > c2.vid
    assert r.new_group((0,)).vid > g2.vid
    assert theirs.new_comm((0, 3)).vid == r.comms[max(r.comms)].vid


def _log(mod):
    log = mod.AdminLog()
    log.append("init", (2, 4))
    log.append("comm_create", ((0, 2),), 1)
    log.append("group_incl", ((1, 3),), 1)
    log.append("comm_create", ((1, 2, 3),), 2)
    log.append("comm_free", (), 1)         # churn: created then freed
    log.append("group_free", (), 1)
    return log


def test_admin_log_replay_rebuilds_proxy_and_tables():
    snap = _log(t_replay).snapshot()
    assert snap == _log(r_replay).snapshot()

    vids, proxy = VirtualIds(4), FakeProxy()
    AdminLog.restore(_across(snap)).replay(vids, proxy)
    assert proxy.ranks == [(2, 4)]
    assert proxy.comms == {2: (1, 2, 3)}   # comm 1 freed during replay
    assert set(vids.comms) == {WORLD_VID, 2}
    assert vids.groups == {}
    # the reference replays the port's log, the port the reference's
    for restore, vids_cls, src in (
            (r_replay.AdminLog.restore, r_virt.VirtualIds, snap),
            (AdminLog.restore, VirtualIds, _log(r_replay).snapshot())):
        v2, p2 = vids_cls(4), FakeProxy()
        restore(_across(src)).replay(v2, p2)
        assert (_tables(v2), p2.ranks, p2.comms) == \
            (_tables(vids), proxy.ranks, proxy.comms)
    with pytest.raises(ValueError):
        AdminLog.restore([("warp", (), -1)]).replay(VirtualIds(2),
                                                    FakeProxy())


# ------------------------------------------------------------ world remap

def test_make_rank_map_shrink_grow():
    assert make_rank_map(4, 3, dead=(2,)) == {0: 0, 1: 1, 2: None, 3: 2}
    # shrink past the death count: trailing survivors dropped too
    assert make_rank_map(4, 2, dead=(1,)) == {0: 0, 1: None, 2: 1, 3: None}
    # grow: survivors keep identity, new slots have no old counterpart
    assert make_rank_map(2, 4, dead=(1,)) == {0: 0, 1: None}
    assert remap_rank_tuple((0, 3), make_rank_map(4, 3, dead=(2,))) == (0, 2)
    assert remap_rank_tuple((0, 2), make_rank_map(4, 3, dead=(2,))) is None
    # the reference's maps for every shrink and grow of up to 5 ranks
    for old in range(1, 6):
        for new in range(1, 6):
            for dead in [()] + [(d,) for d in range(old)] + [(0, old - 1)]:
                rm = make_rank_map(old, new, dead=dead)
                assert rm == r_virt.make_rank_map(old, new, dead=dead)
                members = tuple(range(old))
                assert remap_rank_tuple(members, rm) == \
                    r_virt.remap_rank_tuple(members, rm)


def test_remap_vids_snapshot_drops_dead_member_configs():
    def build(mod):
        v = mod.VirtualIds(4)
        alive = v.new_comm((0, 1, 3))          # survives (remapped)
        doomed = v.new_comm((1, 2))            # member 2 dies
        v.new_group((0, 3))
        v.new_group((2,))
        v.new_request("recv", 3, 5, alive.vid)            # src 3 -> 2
        v.new_request("recv", 2, 5, mod.WORLD_VID)        # sender died
        v.new_request("recv", ANY_SOURCE, 1, doomed.vid)  # comm dropped
        return v, alive, doomed

    v, alive, doomed = build(t_virt)
    rv, _, _ = build(r_virt)
    rank_map = make_rank_map(4, 3, dead=(2,))
    snap, dropped = remap_vids_snapshot(v.snapshot(), rank_map, 3)
    assert dropped == {doomed.vid}         # comm vids only, never group vids
    assert snap["comms"][WORLD_VID] == (0, 1, 2)    # rebuilt for new world
    assert snap["comms"][alive.vid] == (0, 1, 2)
    assert doomed.vid not in snap["comms"]
    assert list(snap["groups"].values()) == [(0, 2)]
    assert snap["pending_recvs"] == [(1, 2, 5, alive.vid)]
    assert (snap, dropped) == r_virt.remap_vids_snapshot(
        _across(rv.snapshot()), rank_map, 3)


def test_admin_log_remap_drops_freed_dead_configs():
    def build(mod):
        log = mod.AdminLog()
        log.append("init", (3, 4))
        log.append("comm_create", ((0, 1, 3),), 1)
        log.append("comm_create", ((1, 2),), 2)   # dead member
        log.append("comm_free", (), 2)            # ...its free goes too
        log.append("group_incl", ((0, 3),), 1)
        log.append("finalize", ())
        return log

    rank_map = make_rank_map(4, 3, dead=(2,))
    out = build(t_replay).remap(rank_map, new_rank=2, new_n=3)
    ops = [(r.op, r.args, r.vid) for r in out.records]
    assert ops == [("init", (2, 3), -1),
                   ("comm_create", ((0, 1, 2),), 1),
                   ("group_incl", ((0, 2),), 1),
                   ("finalize", (), -1)]
    ref = build(r_replay).remap(rank_map, new_rank=2, new_n=3)
    assert out.snapshot() == ref.snapshot()
    # the remapped log replays cleanly onto the new world, in both packages
    vids, proxy = VirtualIds(3), FakeProxy()
    out.replay(vids, proxy)
    assert proxy.comms == {1: (0, 1, 2)}
    rvids, rproxy = r_virt.VirtualIds(3), FakeProxy()
    r_replay.AdminLog.restore(_across(out.snapshot())).replay(rvids, rproxy)
    assert (_tables(rvids), rproxy.comms) == (_tables(vids), proxy.comms)


def test_remap_cache_snapshot_filters_and_rewrites():
    def items(env_cls):
        def env(src, dst, comm=0):
            return env_cls(src=src, dst=dst, tag=1, comm_vid=comm, seq=0,
                           payload=b"x").to_bytes()
        return [env(3, 0), env(2, 0), env(0, 2), env(1, 3, comm=7)]

    rank_map = make_rank_map(4, 3, dead=(2,))
    raw = remap_cache_snapshot(items(Envelope), rank_map, dropped_comms={7})
    out = [Envelope.from_bytes(b) for b in raw]
    assert len(out) == 1                   # dead src, dead dst, dropped comm
    assert (out[0].src, out[0].dst) == (2, 0)
    assert raw == r_drain.remap_cache_snapshot(items(REnvelope), rank_map,
                                               dropped_comms={7})


def test_remap_comm_group_vid_namespaces_do_not_collide():
    """Comm vids and group vids are separate counters that both start at
    1: dropping group vid 1 (a dead member) must not discard state keyed
    by the surviving comm vid 1: pending recvs, cached envelopes,
    coll_seq, or the comm's replayed free."""
    v = VirtualIds(4)
    g = v.new_group((0, 1, 2, 3))          # group vid 1: holds dead rank
    c = v.new_comm((0, 1))                 # comm vid 1: fully survives
    assert g.vid == c.vid == 1             # the collision under test
    v.new_request("recv", 1, 9, c.vid)
    rank_map = make_rank_map(4, 3, dead=(3,))
    snap, dropped = remap_vids_snapshot(v.snapshot(), rank_map, 3)
    assert dropped == set()                # no comm was dropped
    assert snap["comms"][c.vid] == (0, 1)
    assert snap["groups"] == {}            # group 1 itself is dropped
    assert snap["pending_recvs"] == [(1, 1, 9, c.vid)]   # recv survives

    log = AdminLog()
    log.append("init", (0, 4))
    log.append("group_incl", ((0, 1, 2, 3),), 1)   # dropped (dead member)
    log.append("comm_create", ((0, 1),), 1)        # survives
    log.append("comm_free", (), 1)                 # ...and so must its free
    log.append("group_free", (), 1)                # group's free is dropped
    out = log.remap(rank_map, new_rank=0, new_n=3)
    ops = [(r.op, r.vid) for r in out.records]
    assert ops == [("init", -1), ("comm_create", 1), ("comm_free", 1)]

    full = {"rank": 0, "n": 4, "cache": [
                Envelope(src=1, dst=0, tag=9, comm_vid=c.vid, seq=0,
                         payload=b"x").to_bytes()],
            "vids": v.snapshot(), "admin": log.snapshot(),
            "sent": 3, "received": 2, "coll_seq": {0: 4, c.vid: 7}}
    re = remap_mpi_snapshot(full, rank_map, new_rank=0, new_n=3)
    assert len(re["cache"]) == 1           # envelope on comm 1 kept
    assert re["coll_seq"] == {0: 4, c.vid: 7}   # sequence not reset
    assert re == r_api.remap_mpi_snapshot(_across(full), rank_map,
                                          new_rank=0, new_n=3)


# ------------------------------------------------------------ plan_summary

def test_plan_summary_reports_source_world(tmp_path):
    """The port's summary of its own checkpoint, and the reference's
    summary of that same checkpoint, agree."""
    from repro.checkpoint.resharding import plan_summary as r_plan_summary
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.resharding import plan_summary
    mgr = CheckpointManager(tmp_path, generation=3)
    state = {"w": torch.arange(24.0).reshape(4, 6),
             "b": np.arange(6, dtype=np.float64)}
    mgr.save(2, state)
    mgr.wait()
    plan = plan_summary(mgr.latest_valid())
    assert plan["n_leaves"] == 2
    assert plan["n_shards"] == 2
    assert plan["approx_bytes"] == 24 * 4 + 6 * 8
    assert plan["generation"] == 3
    assert plan["source_world"] == {"n_devices": 1}
    assert plan["meta"]["step"] == 2
    assert r_plan_summary(mgr.latest_valid()) == plan
