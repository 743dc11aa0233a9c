"""Dry-run sweep (torch twin of ``repro.launch.sweep``): every (arch x
shape x mesh) cell as a SUBPROCESS (each cell's fake world of 256 or 512
ranks is its process's one process group), with resume-by-JSON caching.

  PYTHONPATH=src python -m repro_torch.launch.sweep --meshes pod multipod \
      --variant auto --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep --archs yi-9b \
      --shapes train_4k --device cpu

A cell whose record says ``ok`` or ``skip`` is not run again unless
``--force``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES

CELL_TIMEOUT_S = 3600


def run_sweep(archs, shapes, meshes, variant: str, out: Path,
              force: bool = False, accum: int | None = None,
              device: str = "cuda") -> int:
    out.mkdir(parents=True, exist_ok=True)
    failures = 0
    todo = [(a, s, m) for a in archs for s in shapes for m in meshes]
    for i, (arch, shape, mesh) in enumerate(todo):
        name = f"{arch}__{shape}__{mesh}__{variant}.json"
        path = out / name
        if path.exists() and not force:
            rec = json.loads(path.read_text())
            if rec.get("status") in ("ok", "skip"):
                print(f"[{i+1}/{len(todo)}] {name}: cached ({rec['status']})")
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--variant", variant, "--out", str(out), "--device", device]
        if accum is not None:
            cmd += ["--accum", str(accum)]
        t0 = time.time()
        try:
            r = subprocess.run(cmd, timeout=CELL_TIMEOUT_S,
                               capture_output=True, text=True)
            tail = (r.stdout.strip().splitlines() or [""])[-1]
            print(f"[{i+1}/{len(todo)}] {tail}  ({time.time()-t0:.0f}s)")
            if r.returncode != 0:
                failures += 1
                if not path.exists():
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh,
                        "variant": variant, "status": "error",
                        "error": (r.stderr or "")[-2000:]}))
        except subprocess.TimeoutExpired:
            failures += 1
            path.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "variant": variant, "status": "error",
                "error": f"timeout after {CELL_TIMEOUT_S}s"}))
            print(f"[{i+1}/{len(todo)}] {name}: TIMEOUT")
    return failures


def _cell(rec: dict | None) -> str:
    if rec is None:
        return "not run"
    if rec.get("status") != "ok":
        return rec.get("status", "?")
    c, r = rec["cost"], rec["roofline"]
    return (f"{rec['trace_s']} · {rec['args_bytes_per_device']} · "
            f"{c['flops_per_device']:.6g} · {c['collective_count']} · "
            f"{int(c['collective_bytes_per_device'])} "
            f"({int(c['collective_internode_bytes_per_device'])}; "
            f"{int(c['collective_dcn_bytes_per_device'])}) · "
            f"{r['dominant']} {r['bound_s']:.6g}"
            + "".join(f" · local {site} {n}" for site, n in
                      sorted(rec.get("local_paths", {}).items())))


def table(archs, shapes, meshes, variant: str, out: Path) -> str:
    """The records as one markdown row per (arch, shape), a column per
    mesh: trace_s · argument bytes · flops · collectives · their bytes
    (inter-node; DCN) · the dominant roofline term and its seconds, all
    per device, and the sites whose products ran on each rank's own
    shards (the record's ``local_paths``).  Cells skipped on every mesh
    get no row."""
    rows = [f"| cell | {' | '.join(meshes)} |",
            "| --- |" + " --- |" * len(meshes)]
    for arch in archs:
        for shape in shapes:
            recs = []
            for mesh in meshes:
                path = out / f"{arch}__{shape}__{mesh}__{variant}.json"
                recs.append(json.loads(path.read_text())
                            if path.exists() else None)
            if all(r is not None and r.get("status") == "skip"
                   for r in recs):
                continue
            rows.append(f"| {arch} {shape} | "
                        + " | ".join(_cell(r) for r in recs) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=sorted(ARCHS))
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--meshes", nargs="*", default=["pod", "multipod"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="passed to each cell (dryrun --device)")
    ap.add_argument("--table", action="store_true",
                    help="print the records as a markdown table; run "
                         "nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.archs, args.shapes, args.meshes, args.variant,
                    Path(args.out)))
        return
    n = run_sweep(args.archs, args.shapes, args.meshes, args.variant,
                  Path(args.out), force=args.force, accum=args.accum,
                  device=args.device)
    print(f"sweep done; {n} failures")
    raise SystemExit(1 if n else 0)


if __name__ == "__main__":
    main()
