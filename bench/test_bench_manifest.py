"""BENCHMARK.json against the benchmark's contract, every entry found by
name, the configuration files against the program's registry, and the
harness's isolation from the JAX package."""
import ast
import json
import re
import sys
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parents[1]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert MAN["paths"] == ["bench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert ((MAN["run_seconds"] + 60) * runs + 24 * 180 + 1200) <= 43200


def test_names_units_and_entries():
    seen = set()
    for sec, keys in (("configs", {"name", "source", "file", "reduced",
                                   "why"}),
                      ("workloads", {"name", "config", "traffic", "chips",
                                     "why"})):
        for e in MAN[sec]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for sec in ("end_to_end", "per_layer"):
        for m in MAN[sec]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert [m["name"] for m in MAN["end_to_end"]].count("setup_s") == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.entry["chips"] == 1
    assert c.wl["config"] == c.entry["config"]
    assert cell == f"{c.entry['config']}.{c.entry['traffic']}"
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        mod, _ = harness.reader(m["name"])
        assert callable(mod.read)
    traffic = harness.generator(c)
    assert callable(traffic.run) and callable(traffic.readings)
    assert set(c.wl["limits"]) <= {"max_gap", "loss_gap", "grad_gap",
                                   "change_gap"}


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_a_split_end_to_end_name_reads_its_first_part():
    vals = {"ttft_p95_s": 0.5, "serve_tok_per_s": 9.0, "setup_s": 3.0}
    assert harness.e2e_value(vals, "ttft_p95_s.smollm-135m") == 0.5
    assert harness.e2e_value(vals, "serve_tok_per_s.decode") == 9.0
    assert harness.e2e_value(vals, "setup_s") == 3.0
    with pytest.raises(KeyError):
        harness.e2e_value(vals, "train_tok_per_s")


def test_every_config_used_and_its_file_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/configs/")
        hf = json.loads((ROOT / c["file"]).read_text())
        assert hf["reduced"] == c["reduced"] and hf["source"] == c["source"]


@pytest.mark.parametrize("name", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_config_file_is_the_registry_model(name):
    """The file's published sizes give the program's own entry: every width
    equal, and only ``reduced`` keys or the file's own epsilon differ.
    deepseek's file states YaRN, which the program lacks: it is refused,
    and its sizes are held with plain RoPE."""
    import dataclasses

    from repro_torch.configs import get_arch

    import system
    hf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    if hf["rope_scaling"] is not None:
        with pytest.raises(ValueError, match="rope_scaling"):
            system.program_cfg(hf)
        hf = dict(hf, rope_scaling=None)
    got, want = system.program_cfg(hf), get_arch(name)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "hd", "tie_embeddings", "mla"):
        assert getattr(got, f) == getattr(want, f), f
    if want.moe is not None:
        assert got.moe == dataclasses.replace(want.moe)


def test_program_cfg_refuses_what_the_program_cannot_run():
    import system
    import tiny
    bad = dict(tiny.DEEPSEEK, rope_scaling={"type": "yarn", "factor": 40})
    with pytest.raises(ValueError, match="rope_scaling"):
        system.program_cfg(bad)
    with pytest.raises(ValueError, match="norm_topk_prob"):
        system.program_cfg(dict(tiny.DEEPSEEK, norm_topk_prob=True))
    with pytest.raises(ValueError, match="moe_group_size"):
        system.program_cfg(dict(tiny.DEEPSEEK, moe_group_size=128))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    ref = {m for p in (ROOT / "bench" / "reference").glob("*.py")
           for m in _imports(p)}
    assert "repro_torch" not in ref


def test_forbidden_modules_compare_whole_top_level_names():
    held = ["torch", "repro_torch", "repro_torch.serve.engine", "jaxtyping",
            "reproducible"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core.api"]) == ["repro"]
    assert harness.forbidden_modules(held + ["jaxlib.xla", "flax"]) == [
        "flax", "jaxlib"]
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))


def test_the_harness_reads_nothing_of_the_old_benchmarks():
    for path in (ROOT / "bench").rglob("*.py"):
        if path.name.startswith("test_bench_"):
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks" not in text, path
