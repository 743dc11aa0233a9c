"""Production dry-run (torch twin of ``repro.launch.dryrun``): trace every
(arch x shape x mesh) cell as one rank of the 256- or 512-GPU world and
extract the roofline terms from the traced step.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
      --shape train_4k --mesh multipod --variant auto --device cpu

The reference lowers and compiles each cell's SPMD program for the
production mesh; its success criterion is that this works on the
production meshes for every cell.  The port has no compiler to ask: this
process is rank 0 of a ``fake`` process group of the production world's
size (256 ranks on the (16, 16) ``("data", "model")`` mesh, 512 on the
(2, 16, 16) ``("pod", "data", "model")`` one), whose collectives move
nothing.  ``dryrun_spec``'s arguments are built as fake DTensors in their
layouts, each rank's window and nothing more, and the step runs once on
them under ``cost_analysis.analyze``, which records the rank's local
flops, its modelled HBM bytes, its collectives and the peak of its
temporaries.  No tensor is allocated, nothing runs on a card, and the
step keeps the reference's backends (``"chunked"`` attention, the
``"scan"`` recurrence), so no hand kernel is reached: the record names
them.  ``--device cuda`` (the default, as the serve and train CLIs)
builds the mesh and the fake tensors on the card's device type; without
a card it raises, there is no fallback.

A cell that ``shape_applicable`` rules out is recorded as a skip before
any world starts.  An error is recorded, not raised, and the process then
exits 1, as the reference's ``main`` does.  Records go to
``results/dryrun_torch`` by default, apart from the reference's.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (lay_out_zeros, local,
                                              make_variant)
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.models.registry import active_param_ratio, count_params
from repro_torch.train.step import default_accum, dryrun_spec

#: HBM of one H100 SXM, bytes (the fits_80g_hbm threshold)
HBM_BYTES = 80e9


def start_fake_world(n: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks:
    every collective returns at once and moves nothing.  Refuses a
    process that already has a group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("this process already has a process group; a "
                           "dry-run cell runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens for a train step, 2·N_active·tokens to serve."""
    n_act = count_params(cfg, shape.seq_len) * active_param_ratio(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str,
             accum: int | None, out_dir: Path, save_ops: bool = False,
             master_fp32: bool = False, device="cuda") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import attention, rglru
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multipod"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "variant": variant, "status": "ok"}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return rec

    dev = resolve_device(device)
    chips = 512 if multi else 256
    start_fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi, device=dev)
    pod_size = chips // dict(zip(mesh.mesh_dim_names, mesh.shape)).get(
        "pod", 1)
    if variant == "auto":
        # FSDP for training (fp32 params and moments exceed HBM otherwise
        # at 10B+), plain data + tensor parallelism for serving
        variant_eff = "fsdp" if shape.kind == "train" else "baseline"
    else:
        variant_eff = variant
    rec["variant_effective"] = variant_eff
    rules = make_variant(variant_eff)
    accum_eff = default_accum(cfg, shape) if accum is None else accum
    rec["accum_steps"] = accum_eff if shape.kind == "train" else 1
    rec["chips"] = chips
    rec["master_fp32"] = master_fp32
    # the reference's backends: its dry-run never switches them
    attention.set_attention_backend("chunked")
    rglru.set_recurrence_backend("scan")
    rec["attention_backend"] = attention.get_attention_backend()
    rec["recurrence_backend"] = rglru.get_recurrence_backend()

    t0 = time.time()
    with FakeTensorMode():
        fn, metas, in_shardings, _ = dryrun_spec(
            cfg, shape, mesh, rules, accum_steps=accum_eff,
            master_fp32=master_fp32)
        args = tree_unflatten(metas, [
            lay_out_zeros(m.shape, m.dtype, lay) for m, lay in
            zip(tree_leaves(metas), tree_leaves(in_shardings))])
        shards = [local(t) for t in tree_leaves(args)]
        sharding.FAKE_LOCAL.clear()
        with ca.analyze(pod_size=pod_size, keep=shards) as an:
            if shape.kind == "train":
                out = fn(*args)
            else:
                with torch.no_grad():
                    out = fn(*args)
        del out
    rec["trace_s"] = round(time.time() - t0, 2)
    # the products that ran on each rank's own shards where DTensor's
    # plan cannot be traced (sharding.fake_strided_split), by site: the
    # costs there are that local plan's
    rec["local_paths"] = dict(sharding.FAKE_LOCAL)

    args_bytes = sum(t.numel() * t.element_size() for t in shards)
    rec["args_bytes_per_device"] = int(args_bytes)
    rec["peak_temp_bytes_per_device"] = int(an.peak_temp_bytes)
    rec["bytes_per_device"] = int(args_bytes + an.peak_temp_bytes)
    rec["fits_80g_hbm"] = bool(rec["bytes_per_device"] < HBM_BYTES)

    cost = an.cost
    rec["cost"] = {
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.coll_bytes,
        "collective_dcn_bytes_per_device": cost.coll_dcn_bytes,
        "collective_internode_bytes_per_device": cost.coll_internode_bytes,
        "collective_by_kind": cost.coll_by_kind,
        "collective_count": cost.coll_count,
    }
    rec["roofline"] = ca.roofline_terms(cost, chips)

    mf = model_flops(cfg, shape)
    rec["n_params"] = int(count_params(cfg, shape.seq_len))
    rec["model_flops_per_device"] = mf / chips
    rec["useful_flops_ratio"] = (mf / chips) / max(cost.flops, 1.0)
    rec["device"] = {"type": dev.type, "torch": torch.__version__,
                     "name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")}

    if save_ops:
        (out_dir / "ops").mkdir(parents=True, exist_ok=True)
        (out_dir / "ops" / f"{arch}__{shape_name}__{mesh_kind}__{variant}"
         ".json").write_text(json.dumps(an.op_table(), indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod"))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-ops", action="store_true",
                    help="write the rank's op table (count, flops, bytes "
                         "by op) under OUT/ops")
    ap.add_argument("--master-fp32", action="store_true",
                    help="bf16 params + sharded fp32 master (halves FSDP "
                         "all-gather bytes)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (perf iterations)")
    ap.add_argument("--device", default="cuda",
                    help="the device type the fake tensors claim; cuda "
                         "without a card raises")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{args.tag}" if args.tag else ""
    name = f"{args.arch}__{args.shape}__{args.mesh}__{args.variant}{tag}.json"
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.variant,
                       args.accum, out_dir, save_ops=args.save_ops,
                       master_fp32=args.master_fp32, device=args.device)
    except Exception as e:  # recorded, not raised: the sweep keeps going
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "variant": args.variant, "status": "error",
               "error": f"{type(e).__name__}: {e}"[:4000],
               "traceback": traceback.format_exc()[-4000:]}
    (out_dir / name).write_text(json.dumps(rec, indent=2, default=float))
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']} compute={r['compute_s']:.4f}s "
                 f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                 f"fits={rec['fits_80g_hbm']} trace={rec['trace_s']}s")
    elif status == "error":
        extra = " " + rec["error"][:200]
    print(f"[dryrun] {name}: {status}{extra}")
    if status == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
