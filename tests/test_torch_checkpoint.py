"""The port's checkpoint layer (``repro_torch.checkpoint``) on the CPU:
twins of tests/test_checkpoint.py, and step directories and serving
snapshots crossing between the two packages in both directions, bit for
bit.  The JAX managers write to a local store (``_jmgr``).

The twins run in three storage legs (the ``store`` fixture): ``local``, a
manager's own chunk directory; ``remote``, one port ChunkServer; and
``sharded``, three with replicas=2.  The remote legs keep the chunk
directory as the client's cache (path-shaped assertions keep holding) and
give every manager root its own server namespace.  As tests/conftest.py
does for the reference, REPRO_CKPT_STORE=remote|sharded runs the
``local`` leg through that kind of store too, so the CI storage matrix
covers the port."""
import hashlib
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serialization as jser
from repro.checkpoint.chunkstore import ChunkStore as JChunkStore
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ARCHS, reduce_for_smoke
from repro.distributed.sharding import make_variant
from repro.launch.mesh import make_local_mesh
from repro.models.layers import Policy as JPolicy
from repro.models.params import init_params as j_init_params
from repro.models.registry import get_api as j_get_api
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.checkpoint import chunkservice as tcs
from repro_torch.checkpoint import chunkstore as tstore
from repro_torch.checkpoint import serialization as tser
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.checkpoint.resharding import plan_summary, restore_resharded
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.core import metrics as tmetrics
from repro_torch.core import trace as ttrace
from repro_torch.launch import serve as t_serve
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.models.params import is_pm, params_from_numpy, tree_leaves
from repro_torch.models.params import tree_map as tmap
from repro_torch.models.registry import get_api as t_get_api
from repro_torch.serve.engine import ServeEngine as TServeEngine
from test_torch_serve import (_agree_up_to_ties, _arch_setup,
                              _deepseek_setup, _fp32_forward_logits,
                              _hybrid_setup, _setup)

T32 = TPolicy(compute=torch.float32)

_FORCED_STORE = os.environ.get("REPRO_CKPT_STORE") or None


@pytest.fixture(scope="module")
def chunk_servers(tmp_path_factory):
    """Three port ChunkServers for the remote legs of this module."""
    root = tmp_path_factory.mktemp("chunk-servers")
    srvs = [tcs.ChunkServer(root / f"srv{i}").start() for i in range(3)]
    yield srvs
    for srv in srvs:
        srv.stop()


@pytest.fixture(params=["local", "remote", "sharded"])
def store(request, chunk_servers):
    """``store(root)``: the store spec a manager at `root` gets in this
    leg (None: its own local chunk directory)."""
    kind = request.param
    if kind == "local" and _FORCED_STORE:
        if _FORCED_STORE not in ("remote", "sharded"):
            pytest.fail(f"REPRO_CKPT_STORE={_FORCED_STORE!r} not understood "
                        f"(only 'remote' or 'sharded')")
        kind = _FORCED_STORE
    if kind == "local":
        return lambda root: None
    servers = chunk_servers if kind == "sharded" else chunk_servers[:1]

    def spec(root):
        ns = hashlib.blake2b(str(root.resolve()).encode(),
                             digest_size=8).hexdigest()
        return tstore.StoreSpec(
            scheme="remote",
            endpoints=tuple(f"{s.host}:{s.port}" for s in servers),
            namespace=ns, replicas=2 if kind == "sharded" else None,
            cache=str(root / "chunks")).canonical()
    return spec


def _state(seed=0):
    """Twin of tests/test_checkpoint.py::_state (int32 as jnp's default)."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(32, 16, generator=g),
                   "b": torch.zeros(16, dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.arange(5, dtype=torch.int32),
                   {"x": torch.tensor(1.5)}],
    }


def _raw(x):
    """(dtype name, shape, raw bytes) of a tensor, JAX array or numpy
    array: bit-identity, dtype included."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return (tser.dtype_name(x.dtype), tuple(x.shape), t.numpy().tobytes())
    a = np.asarray(x)
    return (a.dtype.name, a.shape, a.tobytes())


def _raw_tree(tree, paths=tser._leaf_paths):
    return {k: _raw(leaf) for k, leaf in paths(tree)}


def _assert_same(a, b):
    assert _raw_tree(a) == _raw_tree(b)


# ------------------------------------------------ twins of test_checkpoint

def test_save_restore_roundtrip_exact(tmp_path, store):
    mgr = TManager(tmp_path, keep=2, store=store(tmp_path))
    st = _state()
    mgr.save(10, st)
    mgr.wait()
    out, meta = mgr.restore(_state(), device="cpu")
    assert meta["step"] == 10 and meta["world"] == {"n_devices": 1}
    _assert_same(st, out)


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_shard_codec_roundtrip(tmp_path, codec):
    if codec == "zstd" and not tser.HAVE_ZSTD:
        pytest.skip("zstandard not installed")
    st = _state()
    tser.save_shards(tmp_path, st, codec=codec)
    man = tser.load_manifest(tmp_path)
    assert man["codec"] == codec
    assert tser.validate(tmp_path)
    _assert_same(st, tser.restore_tree(tmp_path, _state()))


def test_async_write_is_donation_safe(tmp_path, monkeypatch, store):
    """The host snapshot is a copy taken before save() returns: an
    in-place update of a CPU tensor right after it (what the next decode
    step does to the serving cache) must not reach the checkpoint, though
    ``.cpu()`` of a CPU tensor would be the same storage.  The writer is
    held until the update is done."""
    gate, real = threading.Event(), tser.save_shards

    def held(*args, **kwargs):
        assert gate.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(tser, "save_shards", held)
    mgr = TManager(tmp_path, keep=2, async_write=True, store=store(tmp_path))
    x = torch.arange(1000, dtype=torch.float32)
    mgr.save(1, {"x": x})
    x.mul_(0).sub_(99)
    gate.set()
    mgr.wait()
    out, _ = mgr.restore({"x": x}, device="cpu")
    assert torch.equal(out["x"], torch.arange(1000, dtype=torch.float32))


def _chunks_of(ckpt_dir):
    return set(tser.manifest_chunks(tser.load_manifest(ckpt_dir)))


def test_corruption_detected_and_skipped(tmp_path, store):
    mgr = TManager(tmp_path, keep=5, store=store(tmp_path))
    mgr.save(1, _state(1)); mgr.wait()
    mgr.save(2, _state(2)); mgr.wait()
    newest = tmp_path / "step_0000000002"
    only2 = _chunks_of(newest) - _chunks_of(tmp_path / "step_0000000001")
    assert only2
    victim = tmp_path / "chunks" / sorted(only2)[0]
    victim.write_bytes(victim.read_bytes()[:-3])
    assert not tser.validate(newest)
    assert mgr.latest_valid().name == "step_0000000001"
    _, meta = mgr.restore(_state(), device="cpu")
    assert meta["step"] == 1


def test_restore_falls_back_past_size_preserving_bitflip(tmp_path, store):
    mgr = TManager(tmp_path, keep=5, store=store(tmp_path))
    mgr.save(1, _state(1)); mgr.wait()
    mgr.save(2, _state(2)); mgr.wait()
    only2 = _chunks_of(tmp_path / "step_0000000002") \
        - _chunks_of(tmp_path / "step_0000000001")
    victim = tmp_path / "chunks" / sorted(only2)[0]
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))
    assert tser.validate(tmp_path / "step_0000000002")   # fast path fooled
    out, meta = mgr.restore(_state(), device="cpu")
    assert meta["step"] == 1                             # ...restore wasn't
    _assert_same(_state(1), out)


def test_bitflip_detected_by_deep_validate_and_restore(tmp_path, store):
    mgr = TManager(tmp_path, keep=5, store=store(tmp_path))
    mgr.save(1, _state(1)); mgr.wait()
    d = tmp_path / "step_0000000001"
    assert tser.validate(d, deep=True)
    victim = tmp_path / "chunks" / sorted(_chunks_of(d))[0]
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))
    assert tser.validate(d)
    assert not tser.validate(d, deep=True)
    with pytest.raises(IOError):
        tser.restore_tree(d, _state())


def test_keep_k_gc(tmp_path, store):
    mgr = TManager(tmp_path, keep=2, store=store(tmp_path))
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
        mgr.wait()
    assert mgr.list_steps() == [3, 4]
    assert mgr.stats["gc_removed"] == 2


def test_refcount_gc_keeps_shared_chunks(tmp_path, store):
    mgr = TManager(tmp_path, keep=1, async_write=False,
                   store=store(tmp_path))
    st = _state(0)
    mgr.save(1, st)
    st2 = dict(st, step=torch.tensor(8, dtype=torch.int32))
    mgr.save(2, st2)                        # gc drops step 1
    assert mgr.list_steps() == [2]
    assert mgr.stats["chunks_gc_removed"] >= 1
    live = _chunks_of(mgr.latest_valid())
    assert live == set(p.name for p in (tmp_path / "chunks").iterdir())
    out, _ = mgr.restore(_state(), device="cpu")
    _assert_same(st2, out)


def test_incremental_save_references_unchanged_chunks(tmp_path, store):
    mgr = TManager(tmp_path, keep=3, store=store(tmp_path))
    st = _state(0)
    mgr.save(1, st)
    mgr.wait()
    assert mgr.stats["last_bytes_written"] > 0
    assert mgr.delta_write_fraction() == 1.0
    st2 = dict(st, step=torch.tensor(8, dtype=torch.int32))
    mgr.save(2, st2)
    mgr.wait()
    assert mgr.stats["last_bytes_referenced"] > 0
    assert mgr.delta_write_fraction() < 0.25
    mgr.save(3, st2)                       # unchanged: references only
    mgr.wait()
    assert mgr.stats["last_bytes_written"] == 0
    assert mgr.delta_write_fraction() == 0.0
    out, meta = mgr.restore(_state(), device="cpu")
    assert meta["step"] == 3
    _assert_same(st2, out)


# ------------------------------------------------ stats, spans, no fallback

def test_manager_stats_keys_match_reference(tmp_path):
    """Twin of test_observability.py::test_ckpt_manager_stats_keys_pinned."""
    mgr = TManager(tmp_path / "torch", keep=2)
    ref = _jmgr(tmp_path / "jax")
    assert set(mgr.stats.keys()) == set(ref.stats.keys())
    assert isinstance(mgr.stats, tmetrics.MetricGroup)
    assert mgr.stats in [g for g in tmetrics.REGISTRY._objs]
    mgr.stats["hash_s"] = mgr.stats.get("hash_s", 0.0) + 0.5
    assert mgr.stats["hash_s"] == 0.5 and mgr.stats.add("saves", 2) == 2


def test_save_and_restore_record_the_reference_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(ttrace, "ENABLED", True)
    ttrace.clear()
    mgr = TManager(tmp_path)
    mgr.save(1, _state())
    mgr.wait()
    mgr.restore(_state(), device="cpu")
    spans = {e.name: e for e in ttrace.events()}
    assert set(spans) == {"ckptmgr.save", "ckptmgr.drain", "ckptmgr.snapshot",
                          "ckptmgr.write", "ckptmgr.restore"}
    save = spans["ckptmgr.save"]
    assert save.args["outcome"] == "ok" and save.args["step"] == 1
    for name in ("ckptmgr.drain", "ckptmgr.snapshot", "ckptmgr.write"):
        assert (spans[name].trace_id, spans[name].parent_id) == \
            (save.trace_id, save.span_id)
    monkeypatch.setattr(ttrace, "ENABLED", False)
    ttrace.clear()
    mgr.save(2, _state())
    mgr.wait()
    assert ttrace.events() == []
    null = ttrace.begin("ckptmgr.save")      # opened while tracing was off
    monkeypatch.setattr(ttrace, "ENABLED", True)
    with ttrace.span("ckptmgr.drain", parent=null):
        pass
    assert [(e.name, e.parent_id) for e in ttrace.events()] == [
        ("ckptmgr.drain", None)]


def test_remote_store_and_absent_card_raise(tmp_path, monkeypatch):
    """No fallback: each remote spec kind resolves to its chunk-service
    client (as the reference's open_store does; nothing is dialed until
    the first call), never to a local store; and a restore onto CUDA
    without a card does not land on the CPU."""
    cache = tmp_path / "cache"
    for spec, want in [
            ("remote://localhost:1", tcs.RemoteChunkStore),
            ("remote://localhost:1/ns?cache=" + str(cache),
             tcs.CachingChunkStore),
            ("remote://h1:1,h2:2/ns?replicas=2", tcs.ShardedChunkStore),
            ("remote://h1:1,h2:2/ns?cache=" + str(cache) + "&replicas=2",
             tcs.CachingChunkStore)]:
        st = tstore.open_store(spec)
        assert type(st) is want and st.spec == spec
        if want is tcs.CachingChunkStore:
            assert type(st.remote) is (tcs.ShardedChunkStore if "," in spec
                                       else tcs.RemoteChunkStore)
        assert type(TManager(tmp_path / "m", store=spec).store) is want
    with pytest.raises(OSError):            # refused: it raises, no fallback
        tstore.open_store("remote://127.0.0.1:1").has("00ff.bin")
    mgr = TManager(tmp_path)
    mgr.save(1, _state())
    mgr.wait()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mgr.restore(_state(), device="cuda")
    with pytest.raises(NotImplementedError, match="item 6"):
        restore_resharded(mgr.latest_valid(), _state(), device="cpu",
                          mesh=object())


# ----------------------------------------------------------------- keys

@pytest.mark.parametrize("name", ["smollm-135m", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_leaf_paths_match_reference_on_params(name):
    jc = reduce_for_smoke(ARCHS[name])
    jp = j_init_params(j_get_api(jc).param_defs(jc, 32), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert [k for k, _ in tser._leaf_paths(tp)] == \
        [k for k, _ in jser._leaf_paths(jp)]
    assert _raw_tree(tp) == _raw_tree(jp, jser._leaf_paths)


def test_leaf_paths_match_reference_on_nested_lists_and_none():
    def tree(leaf):
        return {"z": [leaf(1), [leaf(2), {"b": leaf(3), "a": None}]],
                "a": (leaf(4), None, [[leaf(5)]]), "m": None,
                "k": {"10": leaf(6), "9": leaf(7), "x": []}}
    j = tree(lambda i: np.full((i,), i, np.int32))
    t = tree(lambda i: torch.full((i,), i, dtype=torch.int32))
    keys = [k for k, _ in tser._leaf_paths(t)]
    assert keys == [k for k, _ in jser._leaf_paths(j)]
    assert keys == ["a/0", "a/2/0/0", "k/10", "k/9", "z/0", "z/1/0", "z/1/1/b"]
    restored = tser._unflatten(t, range(7))
    assert restored["z"][1][1] == {"a": None, "b": 6} and restored["m"] is None


# ------------------------------------------------- across the two packages

def _mixed_tree():
    """fp32 normal (stored raw), fp32 and bf16 uniform in [1, 2) (the
    shuffled encoding), bf16 zeros, int32 scalars and vectors; numpy, with
    bf16 as JAX's ml_dtypes array."""
    rng = np.random.default_rng(3)
    u = rng.uniform(1, 2, (64, 64)).astype(np.float32)
    words = (u.view(np.uint32) >> 16).astype(np.uint16)
    return {"w": {"normal": rng.standard_normal((64, 64), dtype=np.float32),
                  "uniform": u, "uniform_bf16": words.view(jnp.bfloat16),
                  "zeros_bf16": np.zeros((64,), jnp.bfloat16)},
            "step": np.int32(7),
            "ids": [np.arange(10, dtype=np.int32), {"k": np.int32(-3)}]}


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _as_torch(tree):
    return params_from_numpy(tree, "cpu")


def _codec(monkeypatch, codec):
    if codec == "zstd" and not (jser.HAVE_ZSTD and tser.HAVE_ZSTD):
        pytest.skip("zstandard not installed")
    monkeypatch.setattr(jser, "DEFAULT_CODEC", codec)
    monkeypatch.setattr(tser, "DEFAULT_CODEC", codec)


def _jmgr(root, **kw):
    """The reference's manager over a local store under every
    REPRO_CKPT_STORE leg too: tests/conftest.py reroutes whatever store
    open_store is handed, a local ChunkStore instance included."""
    mgr = JManager(root, **kw)
    mgr.store = JChunkStore(root / "chunks")
    return mgr


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_step_dir_restores_in_the_other_package(tmp_path, monkeypatch,
                                                writer, codec):
    _codec(monkeypatch, codec)
    tree = _mixed_tree()
    if writer == "jax":
        jm = _jmgr(tmp_path)
        jm.save(5, _as_jax(tree))
        jm.wait()
        out, meta = TManager(tmp_path).restore(_as_torch(tree), device="cpu")
    else:
        mgr = TManager(tmp_path)
        mgr.save(5, _as_torch(tree))
        mgr.wait()
        out, meta = _jmgr(tmp_path).restore(_as_jax(tree))
    assert meta["step"] == 5
    assert tser.load_manifest(tmp_path / "step_0000000005")["codec"] == codec
    assert _raw_tree(out, jser._leaf_paths if writer == "torch"
                     else tser._leaf_paths) == _raw_tree(tree, jser._leaf_paths)


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_manifests_and_chunk_names_agree(tmp_path, monkeypatch, codec):
    """The same state saved by each package: equal manifests but for
    meta.time (so equal chunk names, shuffled encodings included), and a
    save of it into the other package's store writes 0 bytes."""
    _codec(monkeypatch, codec)
    tree = _mixed_tree()
    jm, tm = _jmgr(tmp_path / "jax"), TManager(tmp_path / "torch")
    jm.save(1, _as_jax(tree))
    jm.wait()
    tm.save(1, _as_torch(tree))
    tm.wait()
    man = [tser.load_manifest(m.root / "step_0000000001") for m in (jm, tm)]
    for m in man:
        del m["meta"]["time"]
    assert man[0] == man[1]
    ext = "zst" if codec == "zstd" else "zz"
    chunk = {k: e["shards"][0]["chunk"] for k, e in man[0]["leaves"].items()}
    assert chunk["w/normal"].endswith(".raw")
    assert chunk["w/uniform"].endswith(f".{ext}s4")
    assert chunk["w/uniform_bf16"].endswith(f".{ext}s2")
    assert chunk["w/zeros_bf16"].endswith(f".{ext}")
    assert man[0]["leaves"]["w/uniform_bf16"]["dtype"] == "bfloat16"
    # each package saves the same state into the other's store: 0 bytes
    tm2 = TManager(tmp_path / "jax")
    tm2.save(2, _as_torch(tree))
    tm2.wait()
    jm2 = _jmgr(tmp_path / "torch")
    jm2.save(2, _as_jax(tree))
    jm2.wait()
    for m in (tm2, jm2):
        assert m.stats["last_bytes_written"] == 0
        assert m.stats["last_bytes_referenced"] > 0


def test_jax_saved_params_give_equal_logits_in_the_port(tmp_path):
    """A JAX-saved reduced smollm param tree, restored by the port, is
    bit-equal to params_from_numpy of the same arrays, so the port's
    forward gives equal logits."""
    jc = reduce_for_smoke(ARCHS["smollm-135m"])
    tc = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    jp = j_init_params(j_get_api(jc).param_defs(jc, 32), jax.random.PRNGKey(0))
    jm = _jmgr(tmp_path)
    jm.save(4, jp)
    jm.wait()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    restored, _ = TManager(tmp_path).restore(tp, device="cpu")
    _assert_same(restored, tp)
    toks = {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, jc.vocab_size, (2, 16)))}
    api = t_get_api(tc)
    assert torch.equal(api.forward(tc, restored, toks, T32)[0],
                       api.forward(tc, tp, toks, T32)[0])


# ------------------------------------------------------ serving snapshots

def _t_continue(eng, cache, generated, pos, n):
    """n greedy decode steps of the port from a snapshot: the last token
    goes in at pos - 1 (pos is one past the next slot)."""
    tok = torch.as_tensor(np.asarray(generated)[:, -1:], dtype=torch.long)
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.long) - 1
    toks, logits = [], []
    with torch.inference_mode():
        for _ in range(n):
            lg, cache = eng.api.decode(eng.cfg, eng.params, cache, tok, pos,
                                       eng.policy)
            tok = torch.argmax(lg, dim=-1)[:, None]
            pos = pos + 1
            toks.append(tok)
            logits.append(lg)
    return torch.cat(toks, dim=1).numpy(), torch.stack(logits)


def _j_continue(eng, cache, generated, pos, n):
    tok = jnp.asarray(np.asarray(generated)[:, -1:], jnp.int32)
    pos = jnp.asarray(pos, jnp.int32) - 1
    toks = []
    for _ in range(n):
        logits, cache = eng._decode(eng.params, cache, tok, pos)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        pos = pos + 1
        toks.append(np.asarray(tok))
    return np.concatenate(toks, axis=1)


def _payload(eng, pos):
    return {"cache": eng.cache, "pos": pos,
            "generated": np.concatenate(eng.generated, axis=1)}


@pytest.mark.parametrize("setup,prompt_len,max_seq", [
    (_setup, 8, 48), (_hybrid_setup, 20, 40), (_deepseek_setup, 8, 48)],
    ids=["smollm-135m", "recurrentgemma-9b", "deepseek-v2-lite-16b"])
def test_serving_snapshot_crosses_packages(tmp_path, setup, prompt_len,
                                           max_seq):
    """Each engine generates 4 tokens under DEFAULT_POLICY from the same
    weights and snapshots; each snapshot restores in the other package leaf
    for leaf, bit for bit.  From each snapshot both engines decode 4 more
    tokens; they agree up to near ties as
    test_torch_serve.py::test_serve_engines_agree_under_default_policy holds
    them.  In the port, the continuation from its restored snapshot equals
    the live engine's exactly, and the live engine's in-place decode does
    not reach the written snapshot.  deepseek-v2-lite's cache is MLA's
    compressed c_kv and k_rope, with a dense prefix block."""
    jc, tc, jp, tp = setup(max_seq)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, prompt_len)).astype(np.int32)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=max_seq)
    t_eng = TServeEngine(tc, tp, max_seq=max_seq, device="cpu")
    j_eng.generate(prompts, 4)
    t_eng.generate(prompts, 4)
    jm, tm = _jmgr(tmp_path / "jax"), TManager(tmp_path / "torch")
    j_eng.snapshot_service(jm, 1)
    t_eng.snapshot_service(tm, 1)
    j_snap = _payload(j_eng, j_eng.pos)
    t_snap = _payload(t_eng, t_eng.pos.to(torch.int32))
    j_raw = _raw_tree(j_snap, jser._leaf_paths)
    t_raw = _raw_tree(t_snap)
    # the same leaves, shapes and dtypes on both sides, pos int32
    assert {k: v[:2] for k, v in j_raw.items()} == \
        {k: v[:2] for k, v in t_raw.items()}
    assert t_raw["pos"][0] == "int32"
    if tc.mla is not None:      # the compressed cache, the prefix block's too
        assert {"cache/prefix/0/c_kv", "cache/prefix/0/k_rope",
                "cache/units/b0/c_kv", "cache/units/b0/k_rope"} <= set(t_raw)
    metas = [tser.load_manifest(m.root / "step_0000000001")["meta"]
             for m in (jm, tm)]
    assert [(m["kind"], m["arch"]) for m in metas] == \
        [("serve", jc.name), ("serve", tc.name)]

    t_from_j, _ = TManager(jm.root).restore(t_snap, device="cpu")
    assert _raw_tree(t_from_j) == j_raw
    j_from_t, _ = _jmgr(tm.root).restore(j_snap)
    assert _raw_tree(j_from_t, jser._leaf_paths) == t_raw

    # tolerance: the reference's own bf16 error on its prefill logits
    j_logits, _ = j_eng._prefill(j_eng.params, jnp.asarray(prompts), {})
    j_full, _ = j_get_api(jc).forward(jc, jp, {"tokens": jnp.asarray(prompts)},
                                      JPolicy(compute=jnp.float32))
    bf16_err = float(np.abs(np.asarray(j_logits.astype(jnp.float32))
                            - np.asarray(j_full[:, -1])).max())
    assert 0 < bf16_err < 0.5
    forward_logits = _fp32_forward_logits(tc, tp)

    # from the JAX-written snapshot: the port (restored) and JAX (live)
    t_cont, _ = _t_continue(t_eng, t_from_j["cache"], j_snap["generated"],
                            t_from_j["pos"], 4)
    j_cont = _j_continue(j_eng, j_eng.cache, j_snap["generated"],
                         j_eng.pos, 4)
    ctx = np.concatenate([prompts, j_snap["generated"]], axis=1)
    _agree_up_to_ties(t_cont, j_cont, ctx, forward_logits, 2 * bf16_err)

    # from the port-written snapshot: JAX (restored) and the port (live)
    j_cont = _j_continue(j_eng, j_from_t["cache"], t_snap["generated"],
                         j_from_t["pos"], 4)
    live, live_logits = _t_continue(t_eng, t_eng.cache, t_snap["generated"],
                                    t_snap["pos"], 4)
    ctx = np.concatenate([prompts, t_snap["generated"]], axis=1)
    _agree_up_to_ties(live, j_cont, ctx, forward_logits, 2 * bf16_err)

    # the port alone: restored == live, and the live decode left the
    # written snapshot untouched
    t_own, _ = tm.restore(t_snap, device="cpu")
    assert _raw_tree(t_own) == t_raw
    own, own_logits = _t_continue(t_eng, t_own["cache"], t_own["generated"],
                                  t_own["pos"], 4)
    assert np.array_equal(own, live) and torch.equal(own_logits, live_logits)
    assert tser.validate(tm.root / "step_0000000001", deep=True)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "whisper-tiny"])
def test_family_serving_snapshot_crosses_packages(tmp_path, name):
    """The xLSTM (mLSTM C, n, m and conv; sLSTM c, n, h, m) and whisper
    (self and cross K/V) serving snapshots: each engine generates 4 tokens
    under DEFAULT_POLICY (whisper with its stub frames) and snapshots, and
    each snapshot restores in the other package leaf for leaf, bit for
    bit.  Each snapshot is then continued by both packages from the same
    values in fp32 (the cache cast up, the params fp32): greedy tokens
    agree up to fp32 near ties.  (In bf16 the reduced xLSTM's logits are
    ~1 from fp32 in either package,
    test_torch_serve_families.py::test_xlstm_bf16_prefill_error_is_the_references_size,
    so the bf16 engines are not held to each other's tokens.)"""
    jc, tc, jp, tp = _arch_setup(name)(32)
    prompts = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 8)).astype(np.int32)
    extras = t_serve.request_extras(jc, 2)
    j_eng = JServeEngine(jc, jp, make_local_mesh(), make_variant("baseline"),
                         max_seq=32)
    t_eng = TServeEngine(tc, tp, max_seq=32, device="cpu")
    j_eng.generate(prompts, 4, extras=extras)
    t_eng.generate(prompts, 4, extras=extras)
    jm, tm = _jmgr(tmp_path / "jax"), TManager(tmp_path / "torch")
    j_eng.snapshot_service(jm, 1)
    t_eng.snapshot_service(tm, 1)
    j_snap = _payload(j_eng, j_eng.pos)
    t_snap = _payload(t_eng, t_eng.pos.to(torch.int32))
    j_raw, t_raw = _raw_tree(j_snap, jser._leaf_paths), _raw_tree(t_snap)
    assert {k: v[:2] for k, v in j_raw.items()} == \
        {k: v[:2] for k, v in t_raw.items()}
    want = ({"cache/units/b0/C", "cache/units/b7/c"} if name == "xlstm-1.3b"
            else {"cache/dec/cross/k", "cache/dec/self/v"})
    assert want <= set(t_raw) and t_raw["pos"][0] == "int32"
    t_from_j, _ = TManager(jm.root).restore(t_snap, device="cpu")
    assert _raw_tree(t_from_j) == j_raw
    j_from_t, _ = _jmgr(tm.root).restore(j_snap)
    assert _raw_tree(j_from_t, jser._leaf_paths) == t_raw

    japi, j32 = j_get_api(jc), JPolicy(compute=jnp.float32)
    forward_logits = _fp32_forward_logits(tc, tp, extras)
    for t_copy, j_copy in ((t_from_j, j_snap), (t_snap, j_from_t)):
        generated = np.array(j_copy["generated"])
        pos = np.asarray(j_copy["pos"]) - 1
        t_cache = tmap(lambda x: x.float().clone(), t_copy["cache"])
        j_cache = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                               j_copy["cache"])
        t_tok = torch.as_tensor(generated[:, -1:], dtype=torch.long)
        j_tok = jnp.asarray(generated[:, -1:], jnp.int32)
        t_toks, j_toks = [], []
        with torch.inference_mode():
            for i in range(4):
                lg, t_cache = t_eng.api.decode(
                    tc, tp, t_cache, t_tok, torch.as_tensor(pos + i), T32)
                t_tok = torch.argmax(lg, dim=-1)[:, None]
                jl, j_cache = japi.decode(jc, jp, j_cache, j_tok,
                                          jnp.asarray(pos + i, jnp.int32), j32)
                j_tok = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
                t_toks.append(t_tok.numpy())
                j_toks.append(np.asarray(j_tok))
        ctx = np.concatenate([prompts, generated], axis=1)
        _agree_up_to_ties(np.concatenate(t_toks, axis=1),
                          np.concatenate(j_toks, axis=1), ctx,
                          forward_logits)
    assert tser.validate(tm.root / "step_0000000001", deep=True)


def _template(man):
    """A tree whose leaf keys are the manifest's (dicts keyed by the path
    parts): restore needs only the keys."""
    tree: dict = {}
    for key in man["leaves"]:
        *parents, last = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = 0
    return tree


def test_serve_cli_writes_a_snapshot(tmp_path, capsys):
    rows = t_serve.main(["--arch", "smollm-135m", "--reduced", "--batch", "2",
                         "--prompt-len", "16", "--new-tokens", "4",
                         "--device", "cpu", "--snapshot-dir",
                         str(tmp_path / "svc")])
    assert len(rows) == 1
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == {"snapshot": str(tmp_path / "svc"),
                                   "step": 0}
    d = tmp_path / "svc" / "step_0000000000"
    assert tser.validate(d, deep=True)
    cfg = t_reduce_for_smoke(T_ARCHS["smollm-135m"])
    n_cache = len(tree_leaves(t_get_api(cfg).cache_defs(cfg, 2, 16 + 4 + 8),
                              is_leaf=is_pm))
    plan = plan_summary(d)
    assert plan["n_leaves"] == n_cache + 2
    assert plan["meta"]["kind"] == "serve" and plan["meta"]["arch"] == cfg.name
    man = tser.load_manifest(d)
    state, _ = TManager(tmp_path / "svc").restore(_template(man), device="cpu")
    assert state["pos"].dtype == torch.int32
    assert state["pos"].tolist() == [16 + 4] * 2
    assert state["generated"].shape == (2, 4)
