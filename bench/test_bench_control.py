"""The fp8 control put in the program's place in a whole run of each
traffic mix at smoke widths on the CPU: the harness's own verdict reads
it as not correct, as ``run.py --control 1`` does on the card, where the
program's run of the same cell reads correct."""
import time

import pytest

import harness
import tiny

BIG_SEED = 2 ** 33 + 54321


@pytest.fixture(autouse=True)
def _this_process_may_hold_jax(monkeypatch):
    """Other test files of this process import the JAX package; the check
    of a run's modules is tested on its own (``test_bench_manifest.py``)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def _run(hf, wl, control):
    return harness.run_cell(tiny.cell(hf, wl), BIG_SEED, 0.3, False, "cpu",
                            time.perf_counter(), control=control)


@pytest.mark.parametrize("name,hf,wl", tiny.CONTROL,
                         ids=[c[0] for c in tiny.CONTROL])
def test_the_control_in_the_programs_place_is_not_correct(name, hf, wl):
    res = _run(hf, wl, True)
    assert res["correct"] is False, res["checks"]
    failed = [k for k, c in res["checks"].items()
              if c["value"] > c["limit"]]
    assert failed and not {"restore_mismatch",
                           "snapshot_mismatch"} & set(failed), failed
    if name != "train":             # the program's train cell: test_bench_cells
        sound = _run(hf, wl, False)
        assert sound["correct"] is True, sound["checks"]
