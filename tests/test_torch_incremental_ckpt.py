"""Incremental (content-addressed) rank images in the port: twins of
tests/test_incremental_ckpt.py.

The same steady application runs the same sequence in both packages, each
into its own chunk store: two checkpoints at N = 3 sharing their app
chunks, a kill of rank 2 and a restart at N - 1, a third checkpoint.  The
port's images then name the same app chunks the reference's do,
checkpoint for checkpoint and rank for rank, and the generation-stale
checkpoints are collected from the port's store without touching a chunk
the surviving one references."""
import pickle
import shutil

import numpy as np
import pytest

from repro.checkpoint.chunkstore import ChunkStore as RChunkStore
from repro.core import MPIJob as RJob
from repro.core import ckpt_protocol as r_proto
from repro.core.coordinator import Membership as RMembership
from repro_torch.checkpoint.chunkstore import ChunkStore
from repro_torch.core import MPIJob
from repro_torch.core import ckpt_protocol as t_proto
from repro_torch.core.ckpt_protocol import (checkpoint_valid, live_chunks,
                                            load_manifest, load_rank_image,
                                            manifest_chunks)
from repro_torch.core.coordinator import Membership

PKG = {"port": (MPIJob, Membership, t_proto),
       "ref": (RJob, RMembership, r_proto)}


def _steady_app():
    """An app whose state never changes (the steady-payload extreme):
    steps allreduce a scratch buffer and return the state untouched, so
    every rank's app payload pickles to the same bytes at every
    checkpoint."""
    def init_fn(mpi):
        return {"x": np.arange(1000, dtype=np.float64) * (mpi.rank + 1)}

    def step_fn(mpi, st, k):
        mpi.Allreduce(np.ones(8) * mpi.rank)
        return st
    return init_fn, step_fn


def _bin_files(store_root):
    return {p.name for p in store_root.iterdir() if p.suffix == ".bin"}


def _app_chunk(ckpt_dir, rank):
    return load_manifest(ckpt_dir)["ranks"][str(rank)]["parts"]["app"]["chunk"]


def _sequence(pkg, root):
    """ck_a and ck_b at N = 3 (ck_b restarted from ck_a), then ck_c at
    N = 2 after rank 2's death, all into one store; the manifests."""
    job_cls, ms_cls, proto = PKG[pkg]
    store_root = root / "store"
    ck_a, ck_b, ck_c = (root / n for n in ("ck_a", "ck_b", "ck_c"))
    init_fn, step_fn = _steady_app()
    job = job_cls(3, step_fn, init_fn, ckpt_store=store_root)
    job.checkpoint_at(3, ck_a, resume=False)
    job.run(8, timeout=60)
    job.stop()
    files_a = _bin_files(store_root)
    job = job_cls.restart(ck_a, step_fn, init_fn, ckpt_store=store_root)
    job.checkpoint_at(5, ck_b, resume=False)
    job.run(8, timeout=60)
    job.stop()
    files_b = _bin_files(store_root)
    ms = ms_cls(3)
    ms.bump(dead=[2])
    job = job_cls.restart(ck_b, step_fn, init_fn, world_size=2,
                          dead_ranks=[2], membership=ms,
                          ckpt_store=store_root)
    job.checkpoint_at(7, ck_c, resume=False)
    job.run(9, timeout=60)
    job.stop()
    return ((ck_a, ck_b, ck_c), (files_a, files_b, _bin_files(store_root)),
            [proto.load_manifest(d) for d in (ck_a, ck_b, ck_c)])


def test_incremental_rank_images_across_elastic_reshape(tmp_path):
    (ck_a, ck_b, ck_c), (files_a, files_b, files_c), mans = _sequence(
        "port", tmp_path / "port")
    _, _, ref_mans = _sequence("ref", tmp_path / "ref")
    store_root = tmp_path / "port" / "store"
    assert checkpoint_valid(ck_a)
    assert len(files_a) == 6            # 3 distinct app + 3 mpi parts
    # unchanged app payloads were referenced, not rewritten: only the
    # three remapped/advanced mpi parts are new
    for r in range(3):
        assert _app_chunk(ck_b, r) == _app_chunk(ck_a, r)
    assert files_a <= files_b
    assert len(files_b - files_a) == 3
    assert checkpoint_valid(ck_c)
    man_c = mans[2]
    assert man_c["n_ranks"] == 2 and man_c["generation"] == 1
    # survivor app payloads keep their hashes across the reshape
    for r in range(2):
        assert _app_chunk(ck_c, r) == _app_chunk(ck_b, r)
    assert len(files_c - files_b) == 2      # only 2 remapped mpi parts
    # the reference's images hold the same parts, and name the same app
    # chunks (an mpi part carries the rank's wait-time telemetry, so its
    # bytes differ from run to run within either package)
    for man, ref in zip(mans, ref_mans):
        assert man["n_ranks"] == ref["n_ranks"]
        assert man["generation"] == ref["generation"]
        for r, ent in man["ranks"].items():
            assert set(ent["parts"]) == set(ref["ranks"][r]["parts"])
            assert ent["parts"]["app"] == ref["ranks"][r]["parts"]["app"]

    # the port's images restore bit for bit, in the port and the reference
    for r in range(2):
        want = np.arange(1000, dtype=np.float64) * (r + 1)
        for load in (load_rank_image, r_proto.load_rank_image):
            st = pickle.loads(load(ck_c, r).app_state)
            assert np.array_equal(st["x"], want)

    # gen-stale dirs (gen 0) refcount-collected: their unique chunks go,
    # chunks the surviving generation references stay
    store = ChunkStore(store_root)
    dead_unique = (manifest_chunks(mans[0]) | manifest_chunks(mans[1])) \
        - manifest_chunks(man_c)
    assert dead_unique                       # the stale mpi parts
    shutil.rmtree(ck_a)
    shutil.rmtree(ck_b)
    removed = store.gc(live_chunks([ck_c]))
    assert removed == len(dead_unique)
    assert _bin_files(store_root) == set(manifest_chunks(man_c))
    assert checkpoint_valid(ck_c, deep=True)
    assert r_proto.checkpoint_valid(ck_c, deep=True)
    with pytest.raises(FileNotFoundError):
        load_manifest(ck_a)


def test_self_contained_checkpoint_without_shared_store(tmp_path):
    """ckpt_store=None keeps every checkpoint dir self-contained (chunks
    inside the dir); the reference restarts it as the port does."""
    init_fn, step_fn = _steady_app()
    job = MPIJob(2, step_fn, init_fn)
    job.checkpoint_at(2, tmp_path / "ck", resume=False)
    job.run(4, timeout=60)
    job.stop()
    assert checkpoint_valid(tmp_path / "ck", deep=True)
    assert (tmp_path / "ck" / "chunks").is_dir()
    assert RChunkStore(tmp_path / "ck" / "chunks").has(
        _app_chunk(tmp_path / "ck", 1))
    for cls in (MPIJob, RJob):
        job2 = cls.restart(tmp_path / "ck", step_fn, init_fn)
        out = job2.run(4, timeout=60)
        job2.stop()
        assert np.array_equal(out[1]["x"], np.arange(1000) * 2.0)
