"""The port's production dry-run on the CPU (``repro_torch.launch.dryrun``,
``cost_analysis`` and ``sweep``): each traced cell is rank 0 of a fake
256-rank world on the (16, 16) ``("data", "model")`` mesh, in a process
of its own (a fake world is its process's one process group), against
what the reference and the configs say the cell must be.

The skip set and the parameter counts are the reference's, checked in
this process (no world starts).  Six cells are traced, two at a time:
whisper-tiny decode_32k and train_4k, smollm-135m decode_32k and
train_4k, qwen2-moe-a2.7b decode_32k (16 heads split over the model axis
beside a batch split over data: the layout DTensor cannot cost under fake
tensors unless the attention runs on each rank's own heads) and
xlstm-1.3b decode_32k (4 heads on a 16-wide model axis).  Each is ``ok``;
its argument bytes equal the reference's shard sizes on an
``AbstractMesh``; each decode cell's collectives equal the count its
config implies; the train cell's flops sit within the reference's
analyzer bounds (tests/test_substrate.py) of an analytic count of the
products this rank runs.  A product split over the model axis counts
this rank's local flops, not the global product's."""
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import shape_applicable as j_shape_applicable
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.train import step as jstep
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, sweep
from repro_torch.models import registry as treg

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
CELLS = [("whisper-tiny", "decode_32k"), ("whisper-tiny", "train_4k"),
         ("smollm-135m", "decode_32k"), ("smollm-135m", "train_4k"),
         ("qwen2-moe-a2.7b", "decode_32k"), ("xlstm-1.3b", "decode_32k")]
M = 16                      # the model axis, and the data axis
CELL_TIMEOUT_S = 300

# x (64, 4096) whole on every rank times w (4096, 4096) split over the
# model axis in a fake (16, 16) world: counted on the DTensor op the
# product would be 2 * 64 * 4096 * 4096 = 2.147e9 flops; this rank's own
# product is 64 x 4096 x 256
_PROBE = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import start_fake_world
from repro_torch.launch.mesh import make_mesh
start_fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(64, 4096), mesh,
                           [Replicate(), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 256), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with ca.analyze() as an:
        y = x @ w
        product = {"bytes": an.cost.bytes, "peak": an.peak_temp_bytes}
        y.redistribute(mesh, [Replicate(), Replicate()])
print(json.dumps({"flops": an.cost.flops, "global": tuple(y.shape),
                  "product": product,
                  "by_kind": an.cost.coll_by_kind,
                  "internode": an.cost.coll_internode_bytes,
                  "count": an.cost.coll_count}))
"""


def _name(arch, shape, mesh="pod", variant="auto"):
    return f"{arch}__{shape}__{mesh}__{variant}.json"


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Every cell of CELLS traced (smollm-135m decode_32k with
    ``--save-ops``) and the flop probe, two processes at a time (the
    suite's other workers share the cores)."""
    out = tmp_path_factory.mktemp("dryrun")
    cmds = {}
    for arch, shape in CELLS:
        cmds[(arch, shape)] = [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--variant", "auto", "--device", "cpu",
            "--out", str(out)] + (["--save-ops"] if (arch, shape) == (
                "smollm-135m", "decode_32k") else [])
    cmds["probe"] = [sys.executable, "-c", _PROBE]

    def run(cmd):
        return subprocess.run(cmd, env=ENV, cwd=ROOT, capture_output=True,
                              text=True, timeout=CELL_TIMEOUT_S)
    with ThreadPoolExecutor(2) as pool:
        res = dict(zip(cmds, pool.map(run, cmds.values())))
    recs = {}
    for cell in CELLS:
        path = out / _name(*cell)
        recs[cell] = json.loads(path.read_text()) if path.exists() else {
            "status": "missing", "rc": res[cell].returncode,
            "stderr": res[cell].stderr[-3000:]}
    assert res["probe"].returncode == 0, res["probe"].stderr[-3000:]
    return {"recs": recs, "out": out,
            "probe": json.loads(res["probe"].stdout.strip().splitlines()[-1])}


def test_skips_are_the_references():
    """The (arch, shape) cells ruled out, and why, are the reference's:
    the 524k decode for every pure full-attention arch, 8 of 40; a skip
    is recorded before any world starts."""
    skips = {}
    for arch in ARCHS:
        for shape in SHAPES:
            got = shape_applicable(ARCHS[arch], SHAPES[shape])
            assert got == j_shape_applicable(J_ARCHS[arch], J_SHAPES[shape])
            if not got[0]:
                skips[(arch, shape)] = got[1]
    assert len(skips) == 8 and {s for _, s in skips} == {"long_500k"}
    for (arch, shape), why in skips.items():
        rec = dryrun.run_cell(arch, shape, "pod", "auto", None, Path("."),
                              device="cpu")
        assert rec == {"arch": arch, "shape": shape, "mesh": "pod",
                       "variant": "auto", "status": "skip", "reason": why}
    assert not dist.is_initialized()


def test_a_cell_on_cuda_without_a_card_raises_before_any_world():
    if torch.cuda.is_available():
        pytest.skip("this torch has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("smollm-135m", "decode_32k", "pod", "auto", None,
                        Path("."), device="cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_model_flops_are_the_references(arch):
    """``n_params`` (``count_params`` at the shape's length) and the
    model flops (6·N_active·T, 2·N_active·tokens) of every applicable
    cell equal the reference's."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        n = treg.count_params(cfg, shape.seq_len)
        assert n == jreg.count_params(jcfg, shape.seq_len)
        n_act = n * jreg.active_param_ratio(jcfg)
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        want = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
        assert math.isclose(dryrun.model_flops(cfg, shape), want,
                            rel_tol=1e-12)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_cell_traces_ok_on_the_production_mesh(traced, cell):
    """``ok`` as rank 0 of 256, on the reference's backends, on the CPU;
    the record's keys; the roofline from the cost and the H100 figures."""
    rec = traced["recs"][cell]
    assert rec["status"] == "ok", rec
    kind = SHAPES[cell[1]].kind
    assert rec["chips"] == 256 and rec["device"]["type"] == "cpu"
    assert rec["variant_effective"] == ("fsdp" if kind == "train"
                                        else "baseline")
    assert (rec["attention_backend"], rec["recurrence_backend"]) == (
        "chunked", "scan")
    assert rec["trace_s"] > 0 and rec["fits_80g_hbm"]
    assert rec["bytes_per_device"] == (rec["args_bytes_per_device"]
                                       + rec["peak_temp_bytes_per_device"])
    cost, roof = rec["cost"], rec["roofline"]
    assert cost["collective_dcn_bytes_per_device"] == 0   # one pod
    assert roof["compute_s"] == cost["flops_per_device"] / 989e12
    assert roof["memory_s"] == cost["bytes_per_device"] / 3.35e12
    intra = (cost["collective_bytes_per_device"]
             - cost["collective_internode_bytes_per_device"])
    assert math.isclose(roof["collective_s"], intra / 450e9 + cost[
        "collective_internode_bytes_per_device"] / 50e9, rel_tol=1e-12)
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])
    assert rec["n_params"] == treg.count_params(ARCHS[cell[0]],
                                                SHAPES[cell[1]].seq_len)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_records_name_the_fake_only_paths(traced, cell):
    """``local_paths`` counts the calls whose products ran on each rank's
    own shards because DTensor's plan for them cannot be traced: only
    qwen2-moe-a2.7b's attention, whose 16 heads split over the model axis
    beside a batch split over data, once a layer (its decode step's one
    MoE group leaves the groups whole).  smollm's 9 and whisper's 6 heads
    stay whole on 16 model ranks, and the xLSTM has no attention."""
    arch, shape = cell
    want = ({"attention": ARCHS[arch].n_layers}
            if cell == ("qwen2-moe-a2.7b", "decode_32k") else {})
    assert traced["recs"][cell]["local_paths"] == want


def _reference_arg_bytes(arch, shape) -> int:
    """The bytes of one device's shards of the reference's dry-run
    arguments: its ``dryrun_spec`` on an ``AbstractMesh`` (no devices, no
    compile), each leaf's ``shard_shape`` under its ``NamedSharding``."""
    kind = J_SHAPES[shape].kind
    rules = jsh.make_variant("fsdp" if kind == "train" else "baseline")
    mesh = AbstractMesh((M, M), ("data", "model"))
    _, args, shardings, _ = jstep.dryrun_spec(J_ARCHS[arch], J_SHAPES[shape],
                                              mesh, rules)
    leaves, lays = jax.tree.leaves(args), jax.tree.leaves(shardings)
    assert len(leaves) == len(lays)
    return sum(int(np.prod(s.shard_shape(a.shape))) * np.dtype(a.dtype)
               .itemsize for a, s in zip(leaves, lays))


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_argument_bytes_are_the_references_shards(traced, cell):
    rec = traced["recs"][cell]
    assert rec["args_bytes_per_device"] == _reference_arg_bytes(*cell)


def _div(n: int) -> int:
    """1 where a dim of size n splits over the model axis, else 0."""
    return int(n % M == 0)


def _decode_collectives(arch) -> dict:
    """One decode step's collectives on the (16, 16) mesh, from the
    config: the vocab-parallel embedding's partial sums all-reduced where
    the vocab splits; each row-parallel product's (attention's wo where
    the heads split, the MLP's wo where its ffn splits) all-reduced; an
    MoE block's aux-loss means over the data-split batch (its fraction
    routed and its mean prob, 2); an mLSTM block's up-projection split
    over 2·d_inner and sliced into x and z (gathered, 2), its x gathered
    for the head split where the heads do not divide the model axis, its
    gate products' partial sums reduced once, its wdown all-reduced; an
    sLSTM block's gate pre-activations gathered where the four gates do
    not divide it, and its FFN's wo all-reduced where its width does."""
    cfg = ARCHS[arch]
    ar, ag = _div(cfg.vocab_size), 0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "mlstm":
            di = int(cfg.proj_factor * cfg.d_model)
            ag += 2 * _div(2 * di) + _div(di) * (1 - _div(cfg.n_heads))
            ar += 1 + _div(di)
        elif kind == "slstm":
            f = int(cfg.d_model * 4 / 3) // 2 * 2
            ag += _div(4 * cfg.d_model) * int(4 % M != 0)
            ar += _div(f)
        elif cfg.family == "audio":             # self and cross attention
            ar += 2 * _div(cfg.n_heads) + _div(cfg.d_ff)
        elif cfg.moe is not None and i >= cfg.moe.first_k_dense:
            ar += (_div(cfg.n_heads)
                   + _div(cfg.moe.n_shared * cfg.moe.d_expert) + 2)
        else:
            ar += _div(cfg.n_heads) + _div(cfg.d_ff)
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] == "decode_32k"],
                         ids=lambda c: c[0])
def test_decode_collectives_follow_the_config(traced, cell):
    """smollm-135m: 1 + 30 all-reduces, its 9 heads whole on every rank;
    whisper-tiny: one a decoder block (6 heads and the vocab whole, the
    MLP split); qwen2-moe-a2.7b: 1 + 24 · 4; xlstm-1.3b: 132 all-gathers
    and 1 + 42 · 2 all-reduces.  No other collective, and none leaves the
    node group of its axis: the model axis's 16 ranks span two 8-GPU
    nodes, so every model-axis collective is inter-node."""
    cost = traced["recs"][cell]["cost"]
    want = _decode_collectives(cell[0])
    assert {k: v > 0 for k, v in cost["collective_by_kind"].items()} == {
        k: True for k in want}
    assert cost["collective_count"] == sum(want.values()), (cost, want)
    assert cost["collective_internode_bytes_per_device"] == cost[
        "collective_bytes_per_device"]


def _smollm_train_flops() -> float:
    """This rank's products in one smollm-135m train_4k step under fsdp
    on (16, 16), counted from the config: T = 256 · 4096 / 16 tokens; per
    token each block's q/k/v/o projections and its chunked attention
    (the full S x S scores and values: the q-chunked path masks, it does
    not skip) on every rank, as the 9 heads do not split; the SwiGLU MLP
    split 16 ways; the tied LM head split over the vocab.  The blocks run
    forward, again in the remat recompute, and backward (twice the
    forward), the head forward and backward."""
    cfg = ARCHS["smollm-135m"]
    d, h, kv, hd, s = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 4096
    proj = 2 * d * (2 * h * hd + 2 * kv * hd)
    scores = 2 * 2 * s * h * hd
    mlp = 2 * 3 * d * cfg.d_ff / M
    head = 2 * d * cfg.vocab_size / M
    tokens = 256 * s / M
    return tokens * (4 * cfg.n_layers * (proj + scores + mlp) + 3 * head)


def test_train_flops_are_this_ranks_products(traced):
    """smollm-135m train_4k's flops within 0.9x and 3x of the analytic
    count (the bounds of the reference's analyzer test), and far above
    6NT per device: the attention over 4096 tokens and the heads whole
    on all 16 model ranks cost more than the parameters' products."""
    rec = traced["recs"][("smollm-135m", "train_4k")]
    flops, want = rec["cost"]["flops_per_device"], _smollm_train_flops()
    assert 0.9 * want < flops < 3.0 * want, (flops, want)
    assert flops > 10 * rec["model_flops_per_device"]
    kinds = rec["cost"]["collective_by_kind"]
    assert set(kinds) == {"all-gather", "reduce-scatter", "all-reduce"}


def test_flops_are_counted_on_each_ranks_local_ops(traced):
    """The product of a whole x and a w split over the model axis counts
    this rank's 64 x 4096 x 256 product (1.342e8 flops), not the DTensor
    op's global one (2.147e9); its gather over the 16-wide model axis is
    one all-gather of this rank's 64 x 256 fp32, across two nodes.  The
    product's modelled bytes are this rank's fp32 x, w shard and output,
    and its one temporary the output: the global-shape ops of DTensor's
    sharding propagation, were they billed, would show in both."""
    probe = traced["probe"]
    assert probe["flops"] == 2 * 64 * 4096 * 256
    assert probe["product"] == {
        "bytes": 4 * (64 * 4096 + 4096 * 256 + 64 * 256),
        "peak": 4 * 64 * 256}
    assert probe["global"] == [64, 4096]
    assert probe["by_kind"] == {"all-gather": 64 * 256 * 4}
    assert probe["count"] == 1 and probe["internode"] == 64 * 256 * 4


def test_op_table_sums_to_the_cost(traced):
    ops = json.loads((traced["out"] / "ops" / _name(
        "smollm-135m", "decode_32k")).read_text())
    cost = traced["recs"][("smollm-135m", "decode_32k")]["cost"]
    assert sum(r["flops"] for r in ops) == cost["flops_per_device"]
    assert sum(r["bytes"] for r in ops) == cost["bytes_per_device"]
    assert ops[0]["flops"] >= ops[-1]["flops"]
    assert any(r["op"] == "_c10d_functional.all_reduce.default"
               and r["count"] == 31 for r in ops)


def test_roofline_uses_h100_figures_only():
    assert (ca.PEAK_FLOPS, ca.HBM_BW, ca.NVLINK_BW, ca.IB_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    cost = ca.Cost(flops=989e12, bytes=3.35e12 * 2, coll_bytes=450e9 + 50e9,
                   coll_internode_bytes=50e9)
    terms = ca.roofline_terms(cost, 256)
    assert (terms["compute_s"], terms["memory_s"], terms["collective_s"]) \
        == (1.0, 2.0, 2.0)
    assert terms["dominant"] == "memory" and terms["bound_s"] == 2.0


def test_sweep_runs_cells_then_resumes_from_its_records(tmp_path,
                                                        monkeypatch):
    """Two cheap cells (one traced, one skipped) through the sweep's
    subprocesses; run again, both come from their records and no
    subprocess starts; ``--force`` runs them again."""
    cells = (["whisper-tiny"], ["decode_32k", "long_500k"], ["pod"])
    assert sweep.run_sweep(*cells, "auto", tmp_path, device="cpu") == 0
    recs = {s: json.loads((tmp_path / _name("whisper-tiny", s)).read_text())
            for s in cells[1]}
    assert recs["decode_32k"]["status"] == "ok"
    assert recs["long_500k"]["status"] == "skip"

    def refuse(*a, **k):
        raise AssertionError("a cached cell started a subprocess")
    monkeypatch.setattr(sweep.subprocess, "run", refuse)
    assert sweep.run_sweep(*cells, "auto", tmp_path, device="cpu") == 0
    with pytest.raises(AssertionError, match="cached cell"):
        sweep.run_sweep(*cells, "auto", tmp_path, force=True, device="cpu")


def test_kernels_refuse_fake_cuda_tensors():
    """This CPU-only torch makes fake CUDA tensors under
    ``FakeTensorMode``; every kernel wrapper refuses them with a
    ``TypeError`` naming the dry-run's backends (a fake CPU tensor goes
    to the plain version, as any CPU tensor does)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    with FakeTensorMode():
        def cuda(*shape, dtype=torch.float32):
            return torch.empty(*shape, dtype=dtype, device="cuda")
        calls = {
            "flash_attention": lambda: ops.flash_attention(
                cuda(2, 128, 64), cuda(2, 128, 64), cuda(2, 128, 64)),
            "rglru": lambda: ops.rglru(cuda(2, 128, 64), cuda(2, 128, 64),
                                       cuda(2, 64)),
            "quantize_int8": lambda: ops.quantize_int8(cuda(8192)),
            "dequantize_int8": lambda: ops.dequantize_int8(
                cuda(8192, dtype=torch.int8), cuda(32)),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name} got a fake tensor"
                               ".*\"chunked\" attention and \"scan\""):
                call()
        cpu = torch.empty(2, 128, 64)
        assert ops.flash_attention(cpu, cpu, cpu).shape == (2, 128, 64)
