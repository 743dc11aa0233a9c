"""The port's chunk service (``repro_torch.checkpoint.chunkservice``) on
the CPU: twins of tests/test_chunk_service.py and tests/test_store_spec.py
(all but the MPIJob ones), then the two packages over one wire — each
package's client drives the other's server over every command, single
and sharded; saving values the other package already stored uploads 0
bytes; a step directory written by either package over a remote store
restores bit-equal in the other, cold cache included; and the port's
client decodes a reference server's error without importing the
reference."""
import os
import pickle
import shutil
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import chunkservice as jcs
from repro.checkpoint import chunkstore as jstore
from repro.checkpoint import serialization as jser
from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint import chunkservice as tcs
from repro_torch.checkpoint import chunkstore as tstore
from repro_torch.checkpoint import serialization as tser
from repro_torch.checkpoint.chunkservice import (CHUNK_PROTOCOL_VERSION,
                                                 CachingChunkStore,
                                                 ChunkServer,
                                                 ChunkServiceError,
                                                 RemoteChunkStore,
                                                 ShardedChunkStore,
                                                 make_spec, parse_spec)
from repro_torch.checkpoint.chunkstore import (ChunkReader, ChunkStore,
                                               StoreSpec, content_digest)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import tunables
from repro_torch.core.transport import read_frame
from repro_torch.models.params import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PKG = {"torch": (tcs, tstore), "jax": (jcs, jstore)}


@pytest.fixture
def server(tmp_path):
    srv = ChunkServer(tmp_path / "server").start()
    yield srv
    srv.stop()


@pytest.fixture
def shard_servers(tmp_path):
    srvs = [ChunkServer(tmp_path / f"srv{i}").start() for i in range(3)]
    yield srvs
    for s in srvs:
        s.stop()


def _chunk(payload: bytes):
    return f"{content_digest(payload)}.bin", payload


def _endpoints(servers):
    return tuple(f"{s.host}:{s.port}" for s in servers)


def _sharded(servers, ns="", replicas=2, cache=None):
    sp = StoreSpec(scheme="remote", endpoints=_endpoints(servers),
                   namespace=ns, replicas=replicas,
                   cache=None if cache is None else str(cache))
    return tstore.open_store(sp)


def _fixed_chunks(prefix, count, width=50):
    """Deterministic content -> deterministic digests -> deterministic
    shard placement."""
    return dict(_chunk(f"{prefix}-{k}".encode() * width)
                for k in range(count))


# ------------------------------------------------------------ spec grammar

CANONICAL = [
    "remote://127.0.0.1:9000",
    "remote://10.0.0.7:1234/jobA",
    "remote://127.0.0.1:9000/n-1?cache=/tmp/c",
    "remote://a:1,b:2,c:3",
    "remote://a:1,b:2,c:3/ns?cache=/tmp/x&replicas=2",
    "remote://h:1?replicas=1",
]


def test_spec_round_trip():
    for host, port, ns, cache in [("127.0.0.1", 9000, "", None),
                                  ("10.0.0.7", 1234, "jobA", None),
                                  ("127.0.0.1", 9000, "n-1", "/tmp/c")]:
        spec = make_spec(host, port, ns, cache)
        assert parse_spec(spec) == (host, port, ns, cache)
        assert spec == jcs.make_spec(host, port, ns, cache)
    for bad in ("remote://nohostport", "remote://h:1/../escape",
                "remote://h:1?bogus=1", "remote://a:1,b:2"):
        with pytest.raises(ValueError):
            parse_spec(bad)


def test_parse_canonical_round_trip():
    for text in CANONICAL:
        sp = StoreSpec.parse(text)
        assert sp.canonical() == text
        assert StoreSpec.parse(sp.canonical()) == sp
        assert StoreSpec.parse(sp) is sp
        assert str(sp) == text
        assert jstore.StoreSpec.parse(text).canonical() == text
    sp = StoreSpec.parse("/data/chunks")
    assert sp.scheme == "local" and sp.canonical() == "/data/chunks"


def test_canonical_normalizes_query_order_and_quotes_cache():
    sp = StoreSpec.parse("remote://h:1?replicas=2&cache=/c")
    assert sp.canonical() == "remote://h:1?cache=/c&replicas=2"
    weird = "/tmp/c&x?y=1"
    sp = StoreSpec(scheme="remote", endpoints=("h:1",), cache=weird)
    assert StoreSpec.parse(sp.canonical()).cache == weird
    assert sp.canonical() == jstore.StoreSpec(
        scheme="remote", endpoints=("h:1",), cache=weird).canonical()


def test_spec_validation_errors():
    for bad in ["remote://nohostport", "remote://h:1/../escape",
                "remote://h:1?bogus=1", "remote://h:1,h:1", "remote://"]:
        with pytest.raises(ValueError):
            StoreSpec.parse(bad)
    with pytest.raises(ValueError):
        StoreSpec(scheme="local", path=None)
    with pytest.raises(ValueError):
        StoreSpec(scheme="local", path="/x", cache="/y")
    with pytest.raises(ValueError):
        StoreSpec(scheme="remote", endpoints=("h:1",), replicas=0)
    with pytest.raises(ValueError):
        StoreSpec(scheme="ftp", path="/x")


def test_composition_helpers():
    sp = StoreSpec.parse("remote://a:1,b:2/ns")
    assert sp.sharded
    assert not StoreSpec.parse("remote://a:1").sharded
    c = sp.with_cache("/tmp/c")
    assert c.cache == "/tmp/c" and c.without_cache() == sp
    assert (sp.with_replicas(3).canonical()
            == "remote://a:1,b:2/ns?replicas=3")
    assert sp.with_namespace("other").namespace == "other"


def test_sharded_default_replicas_resolved_at_open(monkeypatch):
    monkeypatch.setattr(tunables, "SHARD_REPLICAS", 5)
    st = ShardedChunkStore(("a:1", "b:2", "c:3"))      # lazy: never dialed
    assert st.replicas == 3                            # clamped
    assert st.spec_obj.replicas == 3
    assert st.spec == "remote://a:1,b:2,c:3?replicas=3"
    st.close()
    st = ShardedChunkStore(("a:1", "b:2", "c:3"), replicas=1)
    assert st.replicas == 1 and "replicas=1" in st.spec
    st.close()


def test_env_knob_helpers_first_name_wins(monkeypatch):
    monkeypatch.delenv("X_MAIN", raising=False)
    monkeypatch.delenv("X_ALIAS", raising=False)
    assert tunables.env_int("X_MAIN", 7, aliases=("X_ALIAS",)) == 7
    monkeypatch.setenv("X_ALIAS", "11")
    assert tunables.env_int("X_MAIN", 7, aliases=("X_ALIAS",)) == 11
    monkeypatch.setenv("X_MAIN", "13")
    assert tunables.env_int("X_MAIN", 7, aliases=("X_ALIAS",)) == 13
    monkeypatch.setenv("X_FLOAT", "0.25")
    assert tunables.env_float("X_FLOAT", 1.0) == 0.25
    monkeypatch.setenv("X_BYTES", str(1 << 20))
    assert tunables.env_bytes("X_BYTES", 0) == 1 << 20
    assert tunables.SHARD_REPLICAS >= 1
    assert tunables.SHARD_FANOUT >= 1
    assert tunables.SHARD_RETRY_S > 0


def test_knobs_read_the_reference_environment_names():
    """One setting governs both packages: the port reads the reference's
    variable names, REPRO_SHARD_REPLICAS included as REPRO_REPLICAS's
    alias."""
    code = ("from repro_torch.core import tunables as t; "
            "print(t.CHUNK_RETRIES, t.CHUNK_OOB_MIN, t.SHARD_REPLICAS, "
            "t.SHARD_RETRY_S)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_CHUNK_RETRIES": "7", "REPRO_CHUNK_OOB_MIN": "1024",
           "REPRO_SHARD_REPLICAS": "3", "REPRO_SHARD_RETRY_S": "0.5"}
    env.pop("REPRO_REPLICAS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.split() == ["7", "1024", "3", "0.5"], out.stderr


# ----------------------------------------------------- open_store resolution

def test_open_store_resolves_every_spec_kind(tmp_path, server):
    local = tstore.open_store(tmp_path / "local")
    assert type(local) is ChunkStore
    assert tstore.open_store(local) is local             # pass-through
    sp = StoreSpec.parse(server.spec_for("ns"))
    for spec in (sp, sp.canonical(), server.spec_for("ns")):
        got = tstore.open_store(spec)
        assert isinstance(got, RemoteChunkStore)
        assert got.spec == sp.canonical()
    caching = tstore.open_store(server.spec_for("ns1",
                                                cache=tmp_path / "cache"))
    assert isinstance(caching, CachingChunkStore)
    assert caching.fetch_spec == server.spec_for("ns1")
    again = tstore.open_store(caching.spec)             # spec round trip
    assert isinstance(again, CachingChunkStore)
    assert again.remote.namespace == "ns1"
    assert again.cache.root == tmp_path / "cache"


def test_manager_accepts_one_grammar(tmp_path, server):
    sp = StoreSpec.parse(server.spec_for("uni", cache=tmp_path / "cache"))
    for spec in (sp, sp.canonical()):
        mgr = CheckpointManager(tmp_path / "root", async_write=False,
                                store=spec)
        assert isinstance(mgr.store, CachingChunkStore)
        assert mgr.store.spec == sp.canonical()
    mgr = CheckpointManager(tmp_path / "root", async_write=False,
                            store=sp.with_namespace("mgr"))
    assert mgr.store.spec == sp.with_namespace("mgr").canonical()
    mgr.save(1, {"x": torch.arange(8, dtype=torch.float32)})
    man = tser.load_manifest(tmp_path / "root" / "step_0000000001")
    assert man["store"] == sp.with_namespace("mgr").without_cache().canonical()


# --------------------------------------------------------- protocol basics

def test_server_put_get_ref_gc_list(server):
    st = tstore.open_store(server.spec)
    name_a, blob_a = _chunk(b"alpha" * 100)
    name_b, blob_b = _chunk(b"beta" * 100)
    assert st.put(name_a, blob_a)
    assert not st.put(name_a, blob_a)        # idempotent: second is a ref
    assert st.put(name_b, blob_b)
    assert st.get(name_a) == blob_a
    assert st.has(name_a) and not st.has("00ff.bin")
    assert st.size(name_b) == len(blob_b)
    assert st.has_many([name_a, name_b, "00ff.bin"]) == {
        name_a: len(blob_a), name_b: len(blob_b)}
    st.ref(name_a, 500)
    assert st.list_chunks() == {name_a, name_b}
    assert st.gc([name_a]) == 0              # automatic gc: lease only
    assert st.list_chunks() == {name_a, name_b}
    assert st.gc_remote([name_a]) == 1
    assert st.list_chunks() == {name_a}
    srv_stats = st.server_stats()
    assert srv_stats["chunks_written"] == 2
    assert srv_stats["chunks_removed"] == 1


@pytest.mark.parametrize("shape", [(1 << 17,), (64, 1024), (4, 8, 1024)],
                         ids=["flat", "2d", "3d"])
def test_put_counts_bytes_of_array_buffers_not_elements(server, shape):
    """A blob may be a numpy array or a memoryview of one, of any rank:
    the client and the server's store count and write its bytes.  A torch
    tensor exports no buffer and is refused."""
    st = tstore.open_store(server.spec)
    arr = np.random.default_rng(0).random(shape, dtype=np.float32)
    name = f"{content_digest(arr.tobytes())}.raw"
    assert st.put(name, memoryview(arr), raw_bytes=arr.nbytes)
    assert st.stats["bytes_uploaded"] == arr.nbytes
    assert st.size(name) == arr.nbytes
    assert st.get(name) == arr.tobytes()
    assert server.backing().get(name) == arr.tobytes()
    with pytest.raises(TypeError):
        st.put(name, torch.from_numpy(arr))


def test_namespaces_are_disjoint(server):
    a = tstore.open_store(server.spec_for("jobA"))
    b = tstore.open_store(server.spec_for("jobB"))
    name, blob = _chunk(b"shared-content")
    a.put(name, blob)
    assert not b.has(name)
    assert b.list_chunks() == set()
    b.put(name, blob)
    assert b.gc_remote([]) == 1              # B's gc cannot touch A
    assert a.has(name)
    with pytest.raises(ValueError):          # "." would alias the default ns
        tstore.open_store(make_spec("127.0.0.1", server.port, "."))


# --------------------------------------------------------------- gc leases

def test_gc_leases_protect_other_writers(server):
    a = tstore.open_store(server.spec_for("shared"))
    b = tstore.open_store(server.spec_for("shared"))
    name_a, blob_a = _chunk(b"a-live" * 50)
    name_b, blob_b = _chunk(b"b-live" * 50)
    name_dead, blob_dead = _chunk(b"garbage" * 50)
    a.put(name_a, blob_a)
    b.put(name_b, blob_b)
    b.put(name_dead, blob_dead)
    assert a.gc([name_a]) == 0               # no removal; registers lease
    assert b.gc_remote([name_b]) == 1        # only name_dead collected
    assert a.has(name_a) and b.has(name_b) and not b.has(name_dead)
    assert "chunks" in next(iter(a.leases().values()))
    assert a.unlease()
    assert b.gc_remote([name_b]) == 1
    assert not a.has(name_a)


def test_gc_lease_expiry_and_named_pins(server):
    st = tstore.open_store(server.spec_for("ttl"))
    other = tstore.open_store(server.spec_for("ttl"))
    name, blob = _chunk(b"short-lived" * 30)
    st.put(name, blob)
    st.lease([name], ttl=0.05, lease_id="round-0")
    assert other.gc_remote([]) == 0          # pinned: survives
    time.sleep(0.12)
    assert other.gc_remote([]) == 1          # lease expired: collected


def test_server_sweep_honors_leases_and_grace(server):
    st = tstore.open_store(server.spec_for("sweep"))
    leased, lb = _chunk(b"leased" * 40)
    fresh, fb = _chunk(b"fresh" * 40)
    stale, sb = _chunk(b"stale" * 40)
    for n, payload in [(leased, lb), (fresh, fb), (stale, sb)]:
        st.put(n, payload)
    st.lease([leased], lease_id="round-1")
    old = time.time() - 3600
    os.utime(server.backing("sweep").root / stale, (old, old))
    assert server.sweep(grace=60.0) == 1     # only the aged unleased chunk
    assert st.has(leased) and st.has(fresh) and not st.has(stale)
    assert server.sweep(grace=0.0) == 1      # fresh now eligible...
    assert st.has(leased) and not st.has(fresh)   # ...lease still pins


def test_auto_sweep_thread(tmp_path):
    srv = ChunkServer(tmp_path / "srv", auto_gc_interval=0.05,
                      gc_grace=0.0).start()
    try:
        st = tstore.open_store(srv.spec_for("auto"))
        keep, kb = _chunk(b"keep-me" * 20)
        drop, db = _chunk(b"drop-me" * 20)
        st.put(keep, kb)
        st.put(drop, db)
        st.lease([keep], lease_id="pin")
        deadline = time.time() + 5.0
        while st.has(drop) and time.time() < deadline:
            time.sleep(0.05)
        assert not st.has(drop)
        assert st.has(keep)
    finally:
        srv.stop()


def _cli_server(pkg, root):
    """One chunk server as its own process, through the package's CLI;
    returns (process, port)."""
    module = "repro_torch" if pkg == "torch" else "repro"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{module}.checkpoint.chunkservice",
         str(root), "--port", "0"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line.startswith(f"chunkserver: {root} on 127.0.0.1:"), line
    return proc, int(line.rsplit(":", 1)[1])


def _kill(proc):
    proc.kill()
    proc.wait(30)
    proc.stdout.close()


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_protocol_version_mismatch_rejected(tmp_path, monkeypatch,
                                            server_pkg):
    """Either package's server (started by its CLI, so that only this
    process's client speaks another version) refuses another protocol
    version, and the port's client raises the port's ChunkServiceError
    for both (a server-raised error: no retry).  The reference's CLI
    pickles its error as ``__main__.ChunkServiceError``; the port's
    reply decoder maps that name as well."""
    cs, _ = PKG[server_pkg]
    proc, port = _cli_server(server_pkg, tmp_path / "srv")
    try:
        s = socket.create_connection(("127.0.0.1", port))
        bad = pickle.dumps((CHUNK_PROTOCOL_VERSION + 1, "", [("list", ())]))
        s.sendall(struct.pack("!q", len(bad)) + bad)
        reply = read_frame(s)
        s.close()
        ok, err = tcs._loads_reply(reply)
        assert not ok and type(err) is ChunkServiceError
        assert str(err) == "client speaks chunk protocol v2, server v1"
        if server_pkg == "torch":
            # the port's CLI pickles its error under the module path
            assert type(pickle.loads(reply)[1]) is tcs.ChunkServiceError
        monkeypatch.setattr(tcs, "CHUNK_PROTOCOL_VERSION",
                            CHUNK_PROTOCOL_VERSION + 1)
        client = RemoteChunkStore("127.0.0.1", port)
        with pytest.raises(ChunkServiceError, match="protocol v2, server v1"):
            client.list_chunks()
        assert client.stats["reconnects"] == 0
        client.close()
    finally:
        _kill(proc)


def test_unreachable_server_is_an_oserror(tmp_path):
    srv = ChunkServer(tmp_path / "gone").start()
    spec = srv.spec
    srv.stop()
    st = tstore.open_store(spec)
    with pytest.raises(OSError):             # ChunkServiceError is one
        st.has("aa.bin")


def test_bounced_server_transparent_reconnect(tmp_path):
    srv = ChunkServer(tmp_path / "srv").start()
    port = srv.port
    st = RemoteChunkStore(srv.host, port)
    name, blob = _chunk(os.urandom(1 << 14))
    assert st.put(name, blob)
    assert st.get(name) == blob              # socket is now warm
    srv.stop()
    srv2 = ChunkServer(tmp_path / "srv", port=port).start()
    try:
        assert st.get(name) == blob          # the retry path re-dials
        assert st.stats["reconnects"] >= 1
        name2, blob2 = _chunk(os.urandom(1 << 14))
        assert st.put(name2, blob2)          # idempotent, safe to replay
        assert srv2.backing().has(name2)
    finally:
        st.close()
        srv2.stop()


def test_retries_exhausted_raise_and_server_errors_never_retry(tmp_path,
                                                               server):
    srv = ChunkServer(tmp_path / "dead").start()
    spec = srv.spec
    srv.stop()
    st = tstore.open_store(spec)
    with pytest.raises(ChunkServiceError):
        st.has("aa.bin")
    assert st.stats["reconnects"] == max(1, tunables.CHUNK_RETRIES) - 1
    live = RemoteChunkStore(server.host, server.port)
    with pytest.raises(ValueError):
        live._call("no_such_command")
    assert live.stats["reconnects"] == 0
    live.close()


def test_torn_put_frame_never_becomes_a_chunk(server):
    name, blob = _chunk(os.urandom(1 << 16))
    payload = pickle.dumps(
        (CHUNK_PROTOCOL_VERSION, "", [("put", (name, blob, len(blob)))]),
        protocol=pickle.HIGHEST_PROTOCOL)
    s = socket.create_connection((server.host, server.port))
    s.sendall(struct.pack("!q", len(payload)) + payload[:len(payload) // 2])
    s.close()
    time.sleep(0.2)                          # let the server notice EOF
    st = tstore.open_store(server.spec)
    assert not st.has(name)
    assert st.list_chunks() == set()
    backing = server.backing()
    if backing.root.is_dir():
        assert not any(".tmp" in p.name for p in backing.root.iterdir())
    assert st.put(name, blob)                # the service survived
    assert st.get(name) == blob


# ------------------------------------------------------------ caching store

def test_caching_store_uploads_only_missing_and_pins_on_fetch(tmp_path,
                                                              server):
    a = CachingChunkStore(tmp_path / "cacheA",
                          RemoteChunkStore(server.host, server.port))
    name1, blob1 = _chunk(b"one" * 1000)
    name2, blob2 = _chunk(b"two" * 1000)
    a.put(name1, blob1)
    assert a.stats["bytes_uploaded"] == len(blob1)
    b = CachingChunkStore(tmp_path / "cacheB",
                          RemoteChunkStore(server.host, server.port))
    assert not b.put(name1, blob1)
    assert b.stats["bytes_uploaded"] == 0
    assert b.stats["bytes_referenced_remote"] == len(blob1)
    assert b.cache.has(name1)
    b.put(name2, blob2)
    c = CachingChunkStore(tmp_path / "cacheC",
                          RemoteChunkStore(server.host, server.port))
    assert c.get(name2) == blob2
    assert c.stats["bytes_fetched"] == len(blob2)
    assert c.get(name2) == blob2
    assert c.stats["cache_hits"] == 1 and c.stats["cache_misses"] == 1
    assert c.stats["bytes_fetched"] == len(blob2)      # no second fetch
    assert c.gc([]) == 1                     # the CACHE only
    assert not c.cache.has(name2)
    assert c.remote.has(name2)
    assert c.get(name2) == blob2


# ----------------------------------------- the manager: fresh-host restores

N_LEAVES, CHANGED = 16, 3


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {f"w{i}": torch.from_numpy(rng.random((64, 64), dtype=np.float32))
            for i in range(N_LEAVES)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_fresh_host_restore_transfers_only_missing_chunks(tmp_path, server):
    state1 = _leaves()
    mgr_a = CheckpointManager(tmp_path / "root", async_write=False,
                              store=server.spec_for("job",
                                                    cache=tmp_path / "hostA"))
    mgr_a.save(1, state1)
    assert mgr_a.stats["last_bytes_uploaded"] > 0
    assert mgr_a.remote_transfer_fraction() == 1.0     # cold server
    # "host B": same manifests, EMPTY cache
    store_b = tstore.open_store(server.spec_for("job",
                                                cache=tmp_path / "hostB"))
    mgr_b = CheckpointManager(tmp_path / "root", async_write=False,
                              store=store_b)
    out1, meta = mgr_b.restore(_leaves(), device="cpu")
    assert meta["step"] == 1 and _equal(out1, state1)
    fetched_cold = store_b.stats["bytes_fetched"]
    assert fetched_cold == store_b.stats["bytes_read"]  # everything moved
    state2 = dict(state1)
    for i in range(CHANGED):
        state2[f"w{i}"] = state1[f"w{i}"] + 1.0
    mgr_a.save(2, state2)
    assert mgr_a.delta_write_fraction() == pytest.approx(CHANGED / N_LEAVES)
    assert mgr_a.remote_transfer_fraction() <= 0.30    # ~3/16 on the wire
    r0 = store_b.stats["bytes_read"]
    out2, meta = mgr_b.restore(_leaves(), device="cpu")
    assert meta["step"] == 2 and _equal(out2, state2)
    frac_fetch = ((store_b.stats["bytes_fetched"] - fetched_cold)
                  / (store_b.stats["bytes_read"] - r0))
    assert frac_fetch <= 0.30
    assert mgr_b.stats["restores"] == 2
    for k in ("restore_io_s", "restore_decompress_s", "restore_device_s"):
        assert mgr_b.stats[k] > 0.0


def test_unreachable_server_never_gcs_checkpoints(tmp_path):
    srv = ChunkServer(tmp_path / "srv").start()
    spec = srv.spec_for("gc")                        # PURE remote: no cache
    mgr = CheckpointManager(tmp_path / "root", keep=1, async_write=False,
                            store=spec)
    mgr.save(1, _leaves())
    mgr.save(2, _leaves())                           # keep=1 gc while UP
    assert mgr.list_steps() == [2]
    srv.stop()
    mgr2 = CheckpointManager(tmp_path / "root", keep=1, async_write=False,
                             store=spec)
    mgr2._gc()                                       # outage: a no-op
    assert mgr2.list_steps() == [2]
    assert (tmp_path / "root" / "step_0000000002" / "MANIFEST.json").exists()
    mgr._gc()
    assert mgr.list_steps() == [2]


def test_dead_server_fails_the_save_and_never_writes_locally(tmp_path):
    """No fallback: a save against a dead server fails, commits no
    manifest and leaves no chunk on the local disk."""
    srv = ChunkServer(tmp_path / "srv").start()
    spec = srv.spec_for("dead")
    srv.stop()
    mgr = CheckpointManager(tmp_path / "root", async_write=False, store=spec)
    with pytest.raises(RuntimeError) as info:
        mgr.save(1, _leaves())
    assert isinstance(info.value.__cause__, ChunkServiceError)
    assert not (tmp_path / "root" / "step_0000000001" /
                "MANIFEST.json").exists()
    assert not (tmp_path / "root" / "chunks").exists()


# ----------------------------------------------- ChunkReader resolution

def test_chunkreader_resolution_order(tmp_path, server):
    blob = os.urandom(256)
    name = f"{content_digest(blob)}.bin"
    spec = server.spec_for("reader")
    tstore.open_store(spec).put(name, blob)
    ckpt = tmp_path / "ck"
    (ckpt / "chunks").mkdir(parents=True)
    man = {"chunk_dir": "chunks", "store": spec}
    r3 = ChunkReader(ckpt, man)              # the manifest's spec serves
    assert r3.get(name) == blob
    assert r3.sizes([name]) == {name: len(blob)}
    explicit = tstore.open_store(server.spec_for("reader",
                                                 cache=tmp_path / "cache"))
    explicit.get(name)                       # warm the cache
    r1 = ChunkReader(ckpt, man, explicit)    # an explicit store first
    assert r1.get(name) == blob
    assert explicit.stats["cache_hits"] == 1
    (ckpt / "chunks" / name).write_bytes(blob)
    server.stop()
    r2 = ChunkReader(ckpt, man)              # a local copy beats the spec
    assert r2.get(name) == blob


def test_chunkreader_dead_server_degradation(tmp_path, server):
    blob = os.urandom(128)
    name = f"{content_digest(blob)}.bin"
    spec = server.spec_for("dead")
    tstore.open_store(spec).put(name, blob)
    ckpt = tmp_path / "ck"
    (ckpt / "chunks").mkdir(parents=True)
    man = {"chunk_dir": "chunks", "store": spec}
    reader = ChunkReader(ckpt, man, tstore.open_store(spec))
    server.stop()
    assert reader.prefetch([name]) == 0      # degrades to the ladder
    with pytest.raises(ConnectionError):     # the outage, not "missing"
        reader.get(name)
    with pytest.raises(ConnectionError):
        reader.sizes([name])
    (ckpt / "chunks" / name).write_bytes(blob)
    assert reader.get(name) == blob
    assert reader.sizes([name]) == {name: len(blob)}


# ------------------------------------------- sharded store

def test_sharded_placement_replication_and_balance(shard_servers):
    st = _sharded(shard_servers, "place")
    assert isinstance(st, ShardedChunkStore) and st.replicas == 2
    chunks = _fixed_chunks("place", 30)
    for name, blob in chunks.items():
        assert st.put(name, blob)
        assert not st.put(name, blob)
    backing = [s.backing("place") for s in shard_servers]
    for name in chunks:
        want = set(st._replica_ids(name))
        got = {i for i, b in enumerate(backing) if b.has(name)}
        assert got == want, name
    assert all(b.list_chunks() for b in backing)
    assert sum(len(b.list_chunks()) for b in backing) == 2 * len(chunks)
    assert st.get_many(list(chunks)) == chunks
    assert st.has_many(list(chunks)) == {n: len(b)
                                         for n, b in chunks.items()}
    assert st.stats["degraded_puts"] == 0
    assert st.stats["replicas"] == 2 and st.stats["shards"] == 3


def test_sharded_placement_matches_the_reference(shard_servers):
    """The shard map is a pure function of the name in both packages."""
    eps = _endpoints(shard_servers)
    mine = ShardedChunkStore(eps, replicas=2)
    ref = jcs.ShardedChunkStore(eps, replicas=2)
    names = list(_fixed_chunks("map", 50)) + ["not-a-digest.bin"]
    assert [mine._replica_ids(n) for n in names] == \
        [ref._replica_ids(n) for n in names]
    mine.close()
    ref.close()


def test_sharded_failover_read_and_degraded_put(shard_servers):
    st = _sharded(shard_servers, "fail")
    chunks = _fixed_chunks("fail", 30)
    assert {st._home(n) for n in chunks} == {0, 1, 2}
    for n, b in chunks.items():
        st.put(n, b)
    victim = 1
    shard_servers[victim].stop()
    for n, b in chunks.items():
        assert st.get(n) == b
    assert st.stats["failover_reads"] > 0
    health = {h["endpoint"]: h for h in st.health()}
    ep = st.shards[victim].endpoint
    assert not health[ep]["up"] and health[ep]["cooldown_s"] > 0
    assert all(h["up"] for e, h in health.items() if e != ep)
    before = st.stats["chunks_written"]
    fresh = _fixed_chunks("fresh", 8)
    for n, b in fresh.items():
        assert st.put(n, b)
    assert st.stats["chunks_written"] == before + len(fresh)
    assert st.stats["degraded_puts"] > 0
    assert st.stats["shards_down"] == 1
    assert st.get_many(list(fresh)) == fresh


def test_sharded_presence_vs_validation_under_outage(shard_servers):
    st = _sharded(shard_servers, "sem")
    name, blob = _chunk(b"present" * 64)
    st.put(name, blob)
    ghost, _ = _chunk(b"never-written" * 64)
    assert st.sizes([name, ghost]) == {name: len(blob), ghost: None}
    shard_servers[0].stop()
    shard_servers[1].stop()
    assert ghost not in st.has_many([name, ghost])
    with pytest.raises(ChunkServiceError):   # "can't tell" != "missing"
        st.sizes([ghost])


def test_sharded_mark_down_cooldown_and_rejoin(tmp_path, monkeypatch):
    monkeypatch.setattr(tunables, "SHARD_RETRY_S", 0.2)
    srvs = [ChunkServer(tmp_path / f"s{i}").start() for i in range(3)]
    try:
        st = _sharded(srvs, "bounce")
        chunks = _fixed_chunks("bounce", 20)
        for n, b in chunks.items():
            st.put(n, b)
        victim = 2
        port = srvs[victim].port
        srvs[victim].stop()
        for n, b in chunks.items():          # first failure marks it down
            assert st.get(n) == b
        assert st.stats["shards_down"] == 1
        srvs[victim] = ChunkServer(tmp_path / f"s{victim}",
                                   port=port).start()
        deadline = time.time() + 10
        while st.stats["shards_down"] and time.time() < deadline:
            time.sleep(0.05)
            st.has_many(list(chunks))        # ordinary ops carry the probe
        assert st.stats["shards_down"] == 0
        assert all(h["up"] for h in st.health())
        assert st.get_many(list(chunks)) == chunks
    finally:
        for s in srvs:
            s.stop()


def test_sharded_gc_is_lease_only_and_gc_remote_sweeps_all_shards(
        shard_servers):
    st = _sharded(shard_servers, "gc")
    live, lb = _chunk(b"live" * 60)
    dead, db = _chunk(b"dead" * 60)
    st.put(live, lb)
    st.put(dead, db)
    assert st.gc([live]) == 0
    assert "chunks" in next(iter(st.leases().values()))
    other = _sharded(shard_servers, "gc")
    assert other.gc_remote([]) == 2          # the unleased chunk's 2 copies
    assert st.has(live) and not st.has(dead)
    assert st.unlease()
    assert other.gc_remote([]) == 2
    assert not st.has(live)


def test_sharded_spec_round_trips_through_open_store(tmp_path,
                                                     shard_servers):
    eps = ",".join(_endpoints(shard_servers))
    st = tstore.open_store(f"remote://{eps}/ns1?replicas=2")
    assert isinstance(st, ShardedChunkStore)
    assert st.spec == f"remote://{eps}/ns1?replicas=2"
    assert st.spec_obj.sharded
    caching = tstore.open_store(
        st.spec_obj.with_cache(tmp_path / "c").canonical())
    assert isinstance(caching, CachingChunkStore)
    assert isinstance(caching.remote, ShardedChunkStore)
    assert "cache=" in caching.spec and "cache=" not in caching.fetch_spec
    again = tstore.open_store(caching.spec)
    assert isinstance(again, CachingChunkStore)
    assert again.remote.endpoints == st.endpoints
    assert again.remote.replicas == 2


def test_sharded_caching_prefetch_pins_working_set(tmp_path, shard_servers):
    writer = _sharded(shard_servers, "pre")
    chunks = _fixed_chunks("pre", 10, width=200)
    for n, b in chunks.items():
        writer.put(n, b)
    reader = _sharded(shard_servers, "pre", cache=tmp_path / "cache")
    assert isinstance(reader, CachingChunkStore)
    total = sum(len(b) for b in chunks.values())
    assert reader.prefetch(list(chunks)) == total
    assert reader.stats["chunks_prefetched"] == len(chunks)
    assert all(reader.cache.has(n) for n in chunks)
    before = reader.stats["bytes_fetched"]
    assert {n: reader.get(n) for n in chunks} == chunks
    assert reader.stats["bytes_fetched"] == before     # all local now
    assert reader.prefetch(list(chunks)) == 0          # idempotent


def test_prefetch_fetches_a_name_listed_twice_once(tmp_path, server,
                                                    monkeypatch):
    """Leaves with equal bytes list one chunk several times in a restore's
    working set; across prefetch batches it still crosses the wire once
    (the reference's prefetch fetches it again in each later batch)."""
    monkeypatch.setattr(tunables, "CHUNK_PREFETCH_BATCH", 2)
    writer = tstore.open_store(server.spec_for("dup"))
    chunks = _fixed_chunks("dup", 3)
    for n, b in chunks.items():
        writer.put(n, b)
    a, b, c = chunks
    reader = tstore.open_store(server.spec_for("dup",
                                               cache=tmp_path / "cache"))
    total = sum(len(x) for x in chunks.values())
    assert reader.prefetch([a, b, c, a, c]) == total
    assert reader.stats["bytes_fetched"] == total
    assert reader.stats["chunks_prefetched"] == 3


def test_manager_over_sharded_store_restores_and_reports_health(
        tmp_path, shard_servers):
    state = _leaves()
    sp = StoreSpec(scheme="remote", endpoints=_endpoints(shard_servers),
                   namespace="mgr", replicas=2,
                   cache=str(tmp_path / "hostA"))
    mgr = CheckpointManager(tmp_path / "root", async_write=False, store=sp)
    mgr.save(1, state)
    health = mgr.store_health()
    assert health is not None and len(health) == 3
    assert all(h["up"] for h in health)
    # "fresh host" with one shard DARK: empty cache, bit-equal restore
    shard_servers[0].stop()
    mgr_b = CheckpointManager(tmp_path / "root", async_write=False,
                              store=sp.with_cache(tmp_path / "hostB"))
    out, meta = mgr_b.restore(_leaves(), device="cpu")
    assert meta["step"] == 1 and _equal(out, state)
    assert sum(1 for h in mgr_b.store_health() if not h["up"]) == 1


# ------------------------------------------------------------------ fork

@pytest.mark.timeout(60)
def test_remote_store_fork_safe_lazy_reconnect(server):
    """A RemoteChunkStore used before a fork opens its OWN connection in
    the child.  torch is imported in this process; the child runs no torch
    op, only the chunk client."""
    import multiprocessing

    ns = "forksafe"
    store = RemoteChunkStore(server.host, server.port, namespace=ns)
    pname, pblob = _chunk(b"parent" * 1000)
    assert store.put(pname, pblob) is True        # parent socket now live
    parent_sock = store._sock
    assert parent_sock is not None
    cname, cblob = _chunk(b"child" * 40000)       # large: rides out-of-band

    def child():
        ok = store.put(cname, cblob)              # must lazily reconnect
        good = (ok is True
                and store.get(cname) == cblob
                and store.get(pname) == pblob
                and store._sock is not parent_sock)
        os._exit(0 if good else 13)

    p = multiprocessing.get_context("fork").Process(target=child)
    p.start()
    p.join(30)
    if p.is_alive():
        p.kill()
        p.join(5)
    assert p.exitcode == 0
    assert store._sock is parent_sock
    assert store.get(pname) == pblob
    backing = server.backing(ns)
    assert backing.has(pname) and backing.has(cname)
    assert backing.get(cname) == cblob
    store.close()


# ------------------------------------------------------------------- CLI

def test_cli_serves_a_shard_until_killed(tmp_path):
    """``python -m repro_torch.checkpoint.chunkservice DIR`` serves one
    shard; once it is SIGKILLed its clients raise, they do not fall back."""
    proc, port = _cli_server("torch", tmp_path / "cli")
    try:
        st = tstore.open_store(f"remote://127.0.0.1:{port}/cli")
        name, blob = _chunk(os.urandom(1 << 17))
        assert st.put(name, blob) and st.get(name) == blob
        assert (tmp_path / "cli" / "cli" / name).read_bytes() == blob
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        with pytest.raises(ChunkServiceError):
            st.get(name)
    finally:
        _kill(proc)


# ======================================================= across packages

def _servers(pkg, tmp_path, layout, tag="srv"):
    cs, _ = PKG[pkg]
    n = 3 if layout == "sharded" else 1
    return [cs.ChunkServer(tmp_path / f"{tag}{i}").start() for i in range(n)]


def _spec(servers, ns, cache=None):
    return StoreSpec(scheme="remote", endpoints=_endpoints(servers),
                     namespace=ns,
                     replicas=2 if len(servers) > 1 else None,
                     cache=None if cache is None else str(cache)).canonical()


def _stop(servers):
    for s in servers:
        s.stop()


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("client", ["torch", "jax"])
def test_client_drives_the_other_packages_server(tmp_path, client, layout):
    """Each package's client against the other's servers, over every
    command: has_many, put (in-band and out-of-band), get, get_many, size,
    ref, list, gc (a lease), lease, leases, unlease, gc_remote and
    stats."""
    server_pkg = "jax" if client == "torch" else "torch"
    servers = _servers(server_pkg, tmp_path, layout)
    try:
        _, store = PKG[client]
        st = store.open_store(_spec(servers, "x"))
        cs, _ = PKG[client]
        assert type(st) is (cs.ShardedChunkStore if layout == "sharded"
                            else cs.RemoteChunkStore)
        big, big_blob = _chunk(os.urandom(1 << 17))       # out-of-band
        small, small_blob = _chunk(b"small" * 100)        # in-band
        assert st.has_many([big, small]) == {}
        assert st.put(big, big_blob) and st.put(small, small_blob)
        assert not st.put(big, big_blob)
        assert st.get(big) == big_blob and st.get(small) == small_blob
        assert st.get_many([big, small, "00ff.bin"]) == {
            big: big_blob, small: small_blob}
        assert st.size(big) == len(big_blob)
        assert st.has_many([big, small, "00ff.bin"]) == {
            big: len(big_blob), small: len(small_blob)}
        st.ref(big, 123)
        assert st.list_chunks() == {big, small}
        assert st.gc([big]) == 0                          # lease only
        assert st.lease([small], ttl=30.0, lease_id="pin-small") == 1
        leases = st.leases()
        # one automatic lease a shard client (each has its own id)
        assert "pin-small" in leases and len(leases) == 1 + len(servers)
        assert all(set(v) == {"ttl", "chunks"} for v in leases.values())
        assert st.unlease("pin-small") and st.unlease()
        assert st.leases() == {}
        copies = 2 if layout == "sharded" else 1
        assert st.gc_remote([big]) == copies              # small's copies
        assert st.list_chunks() == {big}
        stats = st.server_stats()
        per_server = list(stats.values()) if layout == "sharded" else [stats]
        assert all(type(v) is dict and all(type(x) is int for x in v.values())
                   for v in per_server)
        assert sum(v["chunks_written"] for v in per_server) == 2 * copies
        # the other package's servers hold the chunks, named by content
        held = [s.backing("x") for s in servers if s.backing("x").has(big)]
        assert len(held) == copies
        assert all(content_digest(b.get(big)) == big.split(".")[0]
                   for b in held)
        if layout == "sharded":
            assert all(h["up"] for h in st.health())
        st.close()
    finally:
        _stop(servers)


def _mixed_tree():
    """fp32 normal (stored raw) and uniform (shuffled), bf16 uniform and
    zeros, int32 scalar and vector; bf16 as JAX's ml_dtypes array."""
    rng = np.random.default_rng(3)
    u = rng.uniform(1, 2, (64, 64)).astype(np.float32)
    words = (u.view(np.uint32) >> 16).astype(np.uint16)
    return {"w": {"normal": rng.standard_normal((64, 64), dtype=np.float32),
                  "uniform": u, "uniform_bf16": words.view(jnp.bfloat16),
                  "zeros_bf16": np.zeros((64,), jnp.bfloat16)},
            "step": np.int32(7), "ids": np.arange(10, dtype=np.int32)}


def _raw(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return (tser.dtype_name(x.dtype), tuple(x.shape), t.numpy().tobytes())
    a = np.asarray(x)
    return (a.dtype.name, a.shape, a.tobytes())


def _raw_tree(tree, pkg):
    paths = tser._leaf_paths if pkg == "torch" else jser._leaf_paths
    return {k: _raw(v) for k, v in paths(tree)}


def _manager(pkg, root, store=None):
    if pkg == "torch":
        return CheckpointManager(root, async_write=False, store=store)
    return JManager(root, async_write=False, store=store)


def _values(pkg, tree):
    if pkg == "torch":
        return params_from_numpy(tree, "cpu")
    return jax.tree.map(jnp.asarray, tree)


def _restore(pkg, mgr, tree):
    if pkg == "torch":
        return mgr.restore(_values(pkg, tree), device="cpu")
    return mgr.restore(_values(pkg, tree))


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
@pytest.mark.parametrize("first", ["jax", "torch"])
def test_same_values_upload_nothing_for_the_other_package(
        tmp_path, first, server_pkg, layout):
    """One package's manager saves; the other's saves the same values into
    the same namespace from a fresh cache: 0 bytes cross the wire, every
    chunk is a reference to what the first uploaded."""
    second = "torch" if first == "jax" else "jax"
    servers = _servers(server_pkg, tmp_path, layout)
    try:
        tree = _mixed_tree()
        m1 = _manager(first, tmp_path / "a",
                      _spec(servers, "dedup", tmp_path / "cacheA"))
        m1.save(1, _values(first, tree))
        assert m1.stats["last_bytes_uploaded"] > 0
        m2 = _manager(second, tmp_path / "b",
                      _spec(servers, "dedup", tmp_path / "cacheB"))
        m2.save(1, _values(second, tree))
        assert m2.stats["last_bytes_uploaded"] == 0
        assert m2.stats["last_bytes_referenced_remote"] == \
            m1.stats["last_bytes_uploaded"]
        assert m2.remote_transfer_fraction() == 0.0
        names = [set(tser.manifest_chunks(tser.load_manifest(
            d / "step_0000000001"))) for d in (tmp_path / "a", tmp_path / "b")]
        assert names[0] == names[1]
    finally:
        _stop(servers)


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_step_dir_restores_in_the_other_package_over_the_wire(
        tmp_path, writer, layout):
    """A step directory written over a remote store by either package (to
    the other package's servers) restores bit-equal in the other: through
    a fresh empty cache, and with no store at all once every cache is
    gone, from the manifest's recorded ``store`` spec alone."""
    reader = "torch" if writer == "jax" else "jax"
    servers = _servers(reader, tmp_path, layout)
    try:
        tree = _mixed_tree()
        want = _raw_tree(_values(writer, tree), writer)
        w = _manager(writer, tmp_path / "root",
                     _spec(servers, "cross", tmp_path / "wcache"))
        w.save(3, _values(writer, tree))
        man = tser.load_manifest(tmp_path / "root" / "step_0000000003")
        assert man["store"] == _spec(servers, "cross")
        fresh = PKG[reader][1].open_store(
            _spec(servers, "cross", tmp_path / "rcache"))
        out, meta = _restore(reader, _manager(reader, tmp_path / "root",
                                              fresh), tree)
        assert meta["step"] == 3 and _raw_tree(out, reader) == want
        assert fresh.stats["bytes_fetched"] == sum(
            s["clen"] for e in man["leaves"].values() for s in e["shards"])
        shutil.rmtree(tmp_path / "wcache")
        shutil.rmtree(tmp_path / "rcache")
        cold = JManager(tmp_path / "root") if reader == "jax" else \
            CheckpointManager(tmp_path / "root")
        if reader == "jax":
            # a local store that holds nothing, whatever the CI storage leg
            cold.store = jstore.ChunkStore(tmp_path / "root" / "chunks")
        out, meta = _restore(reader, cold, tree)
        assert meta["step"] == 3 and _raw_tree(out, reader) == want
        assert not (tmp_path / "wcache").exists()
    finally:
        _stop(servers)


_BLOCKED_CLIENT = textwrap.dedent("""
    import pickle, sys
    sys.modules["repro"] = None            # the reference cannot be imported
    from repro_torch.checkpoint import chunkservice as cs
    from repro_torch.core.transport import loads_body
    client = cs.RemoteChunkStore("127.0.0.1", int(sys.argv[1]))
    assert client.list_chunks() == set()    # version 1: a healthy reply
    cs.CHUNK_PROTOCOL_VERSION = 2
    try:
        client.list_chunks()
    except cs.ChunkServiceError as e:
        got = f"port:{e}"
    except Exception as e:
        got = f"other:{type(e).__name__}:{e}"
    try:
        loads_body(client._attempt([("list", ())]))
        plain = "decoded"
    except ImportError as e:
        plain = type(e).__name__
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] == "repro" and sys.modules[n] is not None)
    print(got, plain, bad, sep="|")
""")


def test_port_client_decodes_reference_error_without_the_reference(tmp_path):
    """A reference server's ChunkServiceError reaches a port client where
    ``repro`` cannot be imported as the port's own ChunkServiceError; a
    plain unpickle of the same reply would need the reference."""
    srv = jcs.ChunkServer(tmp_path / "srv").start()
    try:
        out = subprocess.run(
            [sys.executable, "-c", _BLOCKED_CLIENT, str(srv.port)],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=60)
    finally:
        srv.stop()
    got, plain, bad = out.stdout.strip().split("|")
    assert got == "port:client speaks chunk protocol v2, server v1", out.stderr
    assert plain == "ModuleNotFoundError"
    assert bad == "[]"


def _grammar_app():
    def init_fn(mpi):
        return {"acc": np.zeros(3, np.float64)}

    def step_fn(mpi, st, k):
        st["acc"] = st["acc"] + mpi.Allreduce(
            np.full(3, mpi.Comm_rank() + k, np.float64), "sum")
        return st
    return init_fn, step_fn


def test_job_restart_and_manager_accept_one_grammar(tmp_path, server):
    """The port's MPIJob, its restart and its CheckpointManager take one
    store grammar: a StoreSpec object, or its canonical string, resolved
    once; the manifest records the portable form, which the reference's
    restart reads as well."""
    from repro.core import MPIJob as RJob
    from repro_torch.core import MPIJob
    from repro_torch.core.ckpt_protocol import load_manifest
    sp = StoreSpec.parse(server.spec_for("uni", cache=tmp_path / "cache"))
    init_fn, step_fn = _grammar_app()
    job = MPIJob(2, step_fn, init_fn, ckpt_store=sp)   # a StoreSpec object
    job.checkpoint_at(3, tmp_path / "ck", resume=False)
    job.run(6, timeout=60)
    job.stop()
    # one resolution point: the job memoized a single backend
    assert isinstance(job._store_backend(), CachingChunkStore)
    assert job._store_backend() is job._store_backend()
    # the manifest records the portable canonical form (no cache dir):
    # a cold-cache validate/restore needs no side channel
    man = load_manifest(tmp_path / "ck")
    assert man["store"] == sp.without_cache().canonical()
    # the restart takes the canonical string for the same store
    job2 = MPIJob.restart(tmp_path / "ck", step_fn, init_fn,
                          ckpt_store=sp.canonical())
    out = job2.run(6, timeout=60)
    job2.stop()
    ref = MPIJob.restart(tmp_path / "ck", step_fn, init_fn, ckpt_store=sp)
    refout = ref.run(6, timeout=60)
    ref.stop()
    theirs = RJob.restart(tmp_path / "ck", step_fn, init_fn,
                          ckpt_store=sp.canonical())
    theirout = theirs.run(6, timeout=60)
    theirs.stop()
    for r in range(2):
        assert np.array_equal(out[r]["acc"], refout[r]["acc"])
        assert np.array_equal(out[r]["acc"], theirout[r]["acc"])
    # CheckpointManager speaks the same grammar
    mgr = CheckpointManager(tmp_path / "root", async_write=False,
                            store=sp.with_namespace("mgr"))
    assert mgr.store.spec == sp.with_namespace("mgr").canonical()
