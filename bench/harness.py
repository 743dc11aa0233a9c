"""One run of one cell: the manifest's entries found by name, the cell's
traffic generator, its end-to-end or per-layer metrics, the comparison that
decides ``correct``, and the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json`` (the file the manifest names),
``workloads/<cell>.json`` (the cell's traffic mix: its parameters, its
limits and the ``generator`` that reads them), ``traffic/<generator>.py``
and ``metrics/<metric>.py``, or for a split name such as
``idle_share.train`` the reader of its first part, given the rest.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

from devtrace import Tracer

BENCH = Path(__file__).resolve().parent
#: top-level module names a run may not hold: the JAX stack and the JAX
#: package the program was ported from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own name."""
    name = "bench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict             # the manifest's workload entry
    hf: dict                # the configuration file
    wl: dict                # workloads/<name>.json
    end_to_end: list        # the manifest's metrics this cell reports
    per_layer: list


def applies(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(root: Path, name: str) -> Cell:
    man = load_json(root / "BENCHMARK.json")
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    e2e = [m for m in man["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if applies(m, name, names)]
    return Cell(name, entry, load_json(root / conf["file"]),
                load_json(BENCH / "workloads" / f"{name}.json"), e2e, per)


def reader(metric: str):
    """The reader of ``metric`` and the part of its name it is given."""
    whole = BENCH / "metrics" / f"{metric}.py"
    if whole.exists():
        return load_module(whole), None
    head, _, part = metric.partition(".")
    return load_module(BENCH / "metrics" / f"{head}.py"), part or None


def e2e_value(vals: dict, metric: str):
    """The generator's value of ``metric``, or for a name split by cell, such
    as ``ttft_p95_s.smollm-135m``, the value of its first part."""
    return vals[metric] if metric in vals else vals[metric.partition(".")[0]]


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (by default the
    modules this process holds), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Run:
    """What a traffic generator is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    scratch: Path           # this run's own directory, removed after
    t_start: float          # the process's start, host clock
    tracer: object = None
    fault: str = None       # tests only: a fault planted in the program
    #: the fp8 control in the program's place in the check (never in the
    #: benchmark's own runs): the run has to come out not correct
    control: bool = False


@dataclass
class Outcome:
    """What a traffic generator returns."""
    setup_s: float
    e2e: dict               # metric name -> value
    attempted: int
    failed: int
    checks: dict            # name -> (value, limit)
    memory_peak_bytes: int
    ctx: dict = field(default_factory=dict)   # what the readers read


def device_info(dev, peak: int) -> dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def verdict(checks: dict) -> bool:
    return all(v <= lim and not math.isnan(v) for v, lim in checks.values())


def generator(cell: Cell):
    """The traffic generator that reads the cell's mix."""
    return load_module(BENCH / "traffic" / f"{cell.wl['generator']}.py")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None, control=False) -> dict:
    """Runs ``cell`` and returns its result line (a dict)."""
    import torch
    dev = torch.device(device)
    traffic = generator(cell)
    tmp = Path(tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR")))
    run = Run(cell, seed, seconds, trace, dev, tmp, t_start,
              Tracer(trace, dev), fault, control)
    try:
        out = traffic.run(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the benchmark "
                         f"measures the port alone")
    result = {"correct": verdict(out.checks), "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        s = run.tracer.summary
        metrics = {}
        for m in cell.per_layer:
            mod, part = reader(m["name"])
            val = mod.read(dict(out.ctx, trace=s, hf=cell.hf, wl=cell.wl),
                           part)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dict(device_info(dev, out.memory_peak_bytes),
                                busy_s=s.busy_s, window_s=s.wall_s)
        result["breakdown"] = s.breakdown()
    else:
        vals = dict(out.e2e, setup_s=out.setup_s)
        result["metrics"] = {m["name"]: {"value": e2e_value(vals, m["name"]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_info(dev, out.memory_peak_bytes)
    result["phases"] = out.ctx.get("phases", {})
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def report(result: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

