"""The port's pre-copy live migration (``repro_torch.core.migrate`` and
``MPIJob.migrate``) against the reference's: twins of
tests/test_live_migrate.py (its bit-identity case is
tests/test_torch_rank_recovery.py::test_live_migrate_bit_identical).

Rounds are exact: for the same sequence of states both packages ship the
same dirty leaves and bytes a round, under the same chunk names, and a
round manifest the port writes loads in the reference.  Migration is
invisible to the application: a world that moved a rank finishes with the
results of one that never did.  Rounds stage and the manifest commits: a
migration that dies mid-round leaves the previous checkpoint restorable,
and the checkpoint a migration commits restarts in either package."""
import pickle
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from repro.checkpoint.chunkstore import ChunkStore as RChunkStore
from repro.core import migrate as r_migration
from repro.core.runtime import MPIJob as RJob
from repro_torch.checkpoint.chunkstore import ChunkStore, content_digest
from repro_torch.core import migrate as migration
from repro_torch.core.ckpt_protocol import checkpoint_valid, load_manifest
from repro_torch.core.runtime import MPIJob

N = 2
STEPS = 100


def init_fn(mpi):
    r = mpi.rank
    return {
        "acc": np.zeros(32, dtype=np.float64),
        "hot": np.full(2048, float(r), dtype=np.float64),
        "cold": np.arange(8192, dtype=np.float64),   # never dirtied
    }


def step_fn(mpi, state, step):
    total = mpi.Allreduce(state["acc"][:4] + step)
    state = dict(state)
    state["acc"] = state["acc"].copy()
    state["acc"][:4] += total
    state["hot"] = state["hot"] + 0.5
    time.sleep(0.004)
    return state


def _run_async(job, n_steps, timeout=120.0):
    box = {}

    def runner():
        try:
            box["out"] = job.run(n_steps, timeout=timeout)
        except BaseException as e:  # noqa: BLE001 - surfaced by _finish
            box["err"] = e

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    box["thread"] = t
    return box


def _finish(job, box, timeout=120.0):
    box["thread"].join(timeout)
    assert not box["thread"].is_alive(), "job did not finish"
    job.stop()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _control(job_cls=RJob):
    ctrl = job_cls(N, step_fn, init_fn, transport="shm")
    try:
        return ctrl.run(STEPS, timeout=120.0)
    finally:
        ctrl.stop()


def _equal(got, want):
    for r in range(N):
        for k in want[r]:
            assert np.array_equal(got[r][k], want[r][k]), (r, k)


# ----------------------------------------------------- split/join + rounds

def test_split_join_roundtrip():
    assert migration.LEAF_SINGLETON == r_migration.LEAF_SINGLETON
    d = {"a": np.arange(4), "b": "text", "c": {"nested": 1}}
    assert set(migration.split_state(d)) == {"a", "b", "c"}
    assert migration.split_state(d).keys() == r_migration.split_state(d).keys()
    back = migration.join_state(migration.split_state(d))
    assert back["b"] == "text" and back["c"] == {"nested": 1}
    assert np.array_equal(back["a"], d["a"])
    # non-dict states (and dicts that could collide with the singleton
    # leaf name) collapse to one leaf, as in the reference
    for s in ([1, 2, 3], "blob", {"_": 1}, {}, {3: "int-key"}):
        leaves = migration.split_state(s)
        assert set(leaves) == {migration.LEAF_SINGLETON}
        assert set(r_migration.split_state(s)) == set(leaves)
        assert migration.join_state(leaves) == s
        assert r_migration.join_state(leaves) == s


def test_stream_round_ships_exactly_dirty_leaves(tmp_path, rng):
    """Across many randomized rounds a round ships exactly the leaves whose
    content changed and references every unchanged one; the reference's
    round over the same states ships the same leaves and bytes under the
    same chunk names."""
    store = ChunkStore(tmp_path / "chunks")
    ref_store = RChunkStore(tmp_path / "ref_chunks")
    state = {f"k{i}": rng.standard_normal(64) for i in range(6)}
    prev, ref_prev = {}, {}
    prev_entry = None
    for round_no in range(25):
        mutated = set()
        for k in list(state):
            if rng.random() < 0.4:
                state[k] = state[k] + rng.standard_normal()
                mutated.add(k)
        entry, digests = migration.stream_round(store, state, prev)
        ref_entry, ref_digests = r_migration.stream_round(ref_store, state,
                                                          ref_prev)
        assert entry == ref_entry and digests == ref_digests, round_no
        # every leaf is listed; exactly the mutated ones were shipped
        assert set(entry["leaves"]) == set(state)
        expected_dirty = mutated if prev else set(state)  # round 1: all
        assert set(entry["dirty_leaves"]) == expected_dirty
        assert entry["shipped_bytes"] == sum(
            entry["leaves"][k]["bytes"] for k in expected_dirty)
        assert entry["total_bytes"] == sum(
            p["bytes"] for p in entry["leaves"].values())
        # unchanged leaves kept their digest; every chunk is in the store
        for k, name in digests.items():
            if k not in expected_dirty:
                assert prev[k] == name
            assert store.has(name)
        if prev_entry is not None:
            clean = set(state) - expected_dirty
            for k in clean:
                assert entry["leaves"][k] == prev_entry["leaves"][k]
        prev, prev_entry, ref_prev = digests, entry, ref_digests


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=25, deadline=None)
@given(st.lists(st.dictionaries(
    st.sampled_from(["a", "b", "c", "d"]), st.binary(max_size=64),
    min_size=1), min_size=1, max_size=6))
def test_round_manifest_property(states):
    """For any sequence of leaf states each round's dirty set is exactly
    the keys whose bytes differ from the previous round (new keys
    included), both packages ship the same entry, and split/join stays a
    bijection."""
    root = Path(tempfile.mkdtemp(prefix="mig-prop-"))
    store, ref_store = ChunkStore(root / "chunks"), RChunkStore(root / "ref")
    prev_digests, ref_digests = {}, {}
    prev_state = None
    for state in states:
        entry, digests = migration.stream_round(store, state, prev_digests)
        ref_entry, ref_digests = r_migration.stream_round(ref_store, state,
                                                          ref_digests)
        assert entry == ref_entry
        expect = {k for k, v in state.items()
                  if prev_state is None or prev_state.get(k) != v
                  or k not in prev_digests}
        assert set(entry["dirty_leaves"]) == expect
        assert migration.join_state(migration.split_state(state)) == state
        prev_digests, prev_state = digests, dict(state)


def test_round_manifest_write_load_latest(tmp_path):
    """The port writes round manifests the reference loads, and loads the
    reference's."""
    entries = {0: {"leaves": {"w": {"chunk": "x.bin", "bytes": 3}},
                   "shipped_bytes": 3, "total_bytes": 3,
                   "dirty_leaves": ["w"]}}
    migration.write_round_manifest(tmp_path, 1, entries, generation=4)
    migration.write_round_manifest(tmp_path, 2, entries, generation=4,
                                   store_spec="remote://h:1/ns")
    assert migration.latest_round(tmp_path) == 2
    man = migration.load_round_manifest(tmp_path, 2)
    assert man["generation"] == 4 and man["store"] == "remote://h:1/ns"
    assert man["ranks"]["0"]["dirty_leaves"] == ["w"]
    assert migration.entries_chunks(entries) == {"x.bin"}
    assert migration.latest_round(tmp_path / "nope") is None
    assert r_migration.latest_round(tmp_path) == 2
    for i in (1, 2):
        assert r_migration.load_round_manifest(tmp_path, i) == \
            migration.load_round_manifest(tmp_path, i)
    ref_dir = tmp_path / "ref"
    r_migration.write_round_manifest(ref_dir, 1, entries, generation=4)
    assert migration.load_round_manifest(ref_dir, 1) == \
        migration.load_round_manifest(tmp_path, 1)


# ------------------------------------------------- the pause and commits

def test_migrate_pause_pays_only_final_delta(tmp_path):
    """With a mostly cold state the converged final round ships a small
    fraction of the checkpoint: pre-copy staged the rest while the world
    ran.  The world's results are the reference's unmigrated run's."""
    job = MPIJob(N, step_fn, init_fn, transport="shm")
    box = _run_async(job, STEPS)
    time.sleep(0.3)
    rep = job.migrate(tmp_path / "ck", ranks=(0,), max_rounds=5,
                      timeout=60.0)
    out = _finish(job, box)
    assert rep["converged"]
    # cold is 8192 float64s per rank; it must never re-ship after round 1
    assert rep["final_fraction"] < 0.9
    dirty = [r["dirty_bytes"] for r in rep["rounds"]]
    assert dirty[-1] < dirty[0], "dirty set never shrank"
    _equal(out, _control())


def test_mid_round_death_leaves_previous_checkpoint_restorable(tmp_path):
    """Round files are staging: a migration killed mid-round (a committed
    round manifest and torn tmp files, the on-disk states a SIGKILL can
    leave, since os.replace is atomic) leaves the committed checkpoint as
    it was, and it restarts in the port and in the reference to the
    unmigrated results."""
    ck = tmp_path / "ck"
    job = MPIJob(N, step_fn, init_fn, transport="shm")
    job.checkpoint_at(20, ck, resume=True)
    box = _run_async(job, STEPS)
    job.wait_checkpoint()
    _finish(job, box)
    man_before = (ck / "MANIFEST.json").read_bytes()
    assert checkpoint_valid(ck)

    # a migration died mid-round: one committed round file, one torn tmp
    store = ChunkStore(ck / "chunks")
    blob = pickle.dumps(np.arange(16))
    entry, _ = migration.stream_round(store, {"w": 1}, {})
    migration.write_round_manifest(ck, 1, {0: entry}, generation=0)
    (ck / "ROUND_0002.json.tmp99-99").write_text('{"torn')
    (ck / "chunks" / f"{content_digest(blob)}.bin.tmp-dead").write_bytes(
        blob[: len(blob) // 2])

    assert (ck / "MANIFEST.json").read_bytes() == man_before
    assert checkpoint_valid(ck, deep=True)
    control = _control()
    for cls in (MPIJob, RJob):
        job2 = cls.restart(ck, step_fn, init_fn, transport="shm")
        out = job2.run(STEPS, timeout=120.0)
        job2.stop()
        _equal(out, control)


def test_migrated_checkpoint_restarts_like_any_other(tmp_path):
    """The manifest a migration commits is an ordinary checkpoint: the
    port's and the reference's ``MPIJob.restart`` consume it (leaf-split
    images reassemble) and finish as an uninterrupted run does, bit for
    bit."""
    job = MPIJob(N, step_fn, init_fn, transport="shm")
    box = _run_async(job, STEPS)
    time.sleep(0.3)
    job.migrate(tmp_path / "ck", ranks=(0,), max_rounds=3, timeout=60.0)
    _finish(job, box)
    man = load_manifest(tmp_path / "ck")
    ent = man["ranks"]["0"]
    leaf_parts = [k for k in ent["parts"] if k.startswith("app/")]
    assert sorted(leaf_parts) == ["app/acc", "app/cold", "app/hot"]
    control = _control()
    for cls in (MPIJob, RJob):
        job2 = cls.restart(tmp_path / "ck", step_fn, init_fn,
                           transport="shm")
        out = job2.run(STEPS, timeout=120.0)
        job2.stop()
        _equal(out, control)
