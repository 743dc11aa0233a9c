"""The port's training loop on a mesh, on the CPU: ``train.loop.train(cfg,
mesh, rules)`` in a 4-rank ``gloo`` world at (2, 2), the train CLI's
``--model-parallel 2`` there, and a checkpoint written by the (2, 2) run
that crashed resuming on another mesh and in the other package.

The world runs the CLI, an uninterrupted fp32 run that saves every
``EVERY`` steps, and the same run crashed after step ``FAIL`` (its last
checkpoint: step ``EVERY``), then resumes a copy of the crashed run's
directory on (2, 2).  A 2-rank world then resumes another copy at (1, 2);
this process resumes one on one device and one in the reference's
``repro.train.loop.train``.  Each resumed run saves its last step, and the
final TrainStates are compared through those checkpoints.

Tolerances.  The resume on the mesh that wrote the checkpoint repeats the
uninterrupted run's arithmetic, so its state is held bit for bit.  A
resume on another mesh sums the row-parallel products, the vocab shards
and the batch in another order, and the reference in another framework:
those are held at fp32 1e-5 of each leaf's largest element (``v``, the
squared gradient, at 2e-5), the losses at 1e-5 relative.  The loop's
smollm-135m is untamed (its attention's wq and wk as drawn), and the
untamed smoke stack's own fp32 gradient noise floor is 1.5e-5 to 3e-5 of
each leaf's largest element (tests/test_torch_train.py::
_tame_attention): across the frameworks, where the summation orders
differ most, the state is held at twice that floor, ``CROSS``.  The CLI
computes in bf16, where a row-parallel product is rounded on each rank
before the partial sums are added: its losses are held within twice the
bf16 loop's own error against the fp32 loop on one device."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.distributed.sharding import make_variant as j_make_variant
from repro.launch.mesh import make_local_mesh as j_make_local_mesh
from repro.models.layers import Policy as JPolicy
from repro.train.loop import train as j_train
from repro_torch.checkpoint import serialization as tser
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce_for_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as t_launch_train
from repro_torch.models.layers import Policy as TPolicy
from repro_torch.train.loop import train as t_train
from repro_torch.train.state import train_state_template
from test_torch_sharded_forward import ENV, ROOT, WORLD_TIMEOUT_S

TOL = 1e-5
CROSS = 6e-5
ARCH = "smollm-135m"
STEPS, EVERY, FAIL = 6, 3, 4
LOOP = dict(n_steps=STEPS, global_batch=4, seq_len=16, log_every=1, seed=5,
            base_lr=1e-3, warmup=2)
CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
       "--batch", "4", "--seq", "16", "--lr", "1e-3", "--warmup", "2"]

_COMMON = r'''
import json, shutil, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.distributed.sharding import make_variant
from repro_torch.launch.mesh import join_world, make_mesh
from repro_torch.models.layers import Policy
from repro_torch.train.loop import train
args = json.loads(sys.argv[1])
rank = join_world()
cfg = reduce_for_smoke(ARCHS[args["arch"]])
kw = dict(args["loop"], policy=Policy(compute=torch.float32))
'''

# the (2, 2) world: the CLI, the uninterrupted run, the crash, the copies
# of the crashed run's directory, the resume on (2, 2)
_WORLD = _COMMON + r'''
import torch.distributed as dist
from repro_torch.launch import train as cli
cli.main(args["cli"])
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
rules = make_variant("baseline")
out = {"rank": rank, "coord": mesh.get_coordinate()}
ref = train(cfg, mesh, rules, ckpt_root=args["dirs"]["uninterrupted"],
            ckpt_every=args["every"], **kw)
try:
    train(cfg, mesh, rules, ckpt_root=args["dirs"]["crashed"],
          ckpt_every=args["every"], fail_at_step=args["fail"], **kw)
    out["crashed"] = False
except RuntimeError as e:
    out["crashed"] = "injected failure" in str(e)
dist.barrier()
if rank == 0:
    for name in ("2x2", "1x2", "one", "jax"):
        shutil.copytree(args["dirs"]["crashed"], args["dirs"][name])
dist.barrier()
res = train(cfg, mesh, rules, ckpt_root=args["dirs"]["2x2"],
            ckpt_every=args["every"], **kw)
out["uninterrupted"] = ref.losses
out["resumed"] = {"from": res.resumed_from, "steps": res.steps_run,
                  "losses": res.losses}
print(json.dumps(out))
'''

# the 2-rank world: the resume on (1, 2)
_WORLD_1X2 = _COMMON + r'''
mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
res = train(cfg, mesh, make_variant("baseline"),
            ckpt_root=args["dirs"]["1x2"], ckpt_every=args["every"], **kw)
print(json.dumps({"rank": rank, "from": res.resumed_from,
                  "steps": res.steps_run, "losses": res.losses}))
'''


def _world(n, code, args):
    outs = tmesh.run_world(
        n, f"import sys; sys.argv[1:] = [{json.dumps(json.dumps(args))}]\n"
        + code, timeout_s=WORLD_TIMEOUT_S, env=ENV, cwd=ROOT)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded-loop")
    dirs = {k: str(d / k) for k in ("uninterrupted", "crashed", "2x2", "1x2",
                                    "one", "jax")}
    args = {"arch": ARCH, "loop": LOOP, "every": EVERY, "fail": FAIL,
            "dirs": dirs, "cli": CLI + ["--model-parallel", "2"]}
    outs = _world(4, _WORLD, args)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    cli_rows = [json.loads(ln) for ln in outs[0].strip().splitlines()[:-1]
                if ln.startswith("{")]
    one_by_1x2 = [json.loads(o.strip().splitlines()[-1])
                  for o in _world(2, _WORLD_1X2, args)]
    tc = t_reduce_for_smoke(T_ARCHS[ARCH])
    one = t_train(tc, None, None, ckpt_root=dirs["one"], ckpt_every=EVERY,
                  policy=TPolicy(compute=torch.float32), device="cpu",
                  **LOOP)
    jc = j_reduce_for_smoke(J_ARCHS[ARCH])
    jres = j_train(jc, j_make_local_mesh(), j_make_variant("baseline"),
                   policy=JPolicy(compute=jax.numpy.float32),
                   ckpt_root=dirs["jax"], ckpt_every=EVERY, **LOOP)
    return dict(reports=reports, cli_rows=cli_rows,
                rank1_lines=len(outs[1].strip().splitlines()),
                resumed={"2x2": reports[0]["resumed"],
                         "1x2": one_by_1x2[0],
                         "one": {"from": one.resumed_from,
                                 "steps": one.steps_run,
                                 "losses": one.losses},
                         "jax": {"from": jres.resumed_from,
                                 "steps": jres.steps_run,
                                 "losses": jres.losses}},
                dirs=dirs, tc=tc)


def _restore(root, step, tc):
    template = {"train": train_state_template(tc, LOOP["seq_len"]),
                "data": {"seed": 0, "cursor": 0}}
    mgr = TManager(root)
    state, meta = mgr.restore(template, ckpt_dir=mgr.root
                              / f"step_{step:010d}", device="cpu")
    return state, meta


def _leaves(state):
    return {k: v for k, v in tser._leaf_paths(state)}


def test_resume_on_the_same_mesh_is_bit_equal(runs):
    """The (2, 2) run crashed after step FAIL, resumed on (2, 2) from its
    step-EVERY checkpoint: every loss after the resume and every leaf of
    its last checkpoint equal the uninterrupted run's bit for bit (a save
    and a restore across the ranks change nothing); the crash and the
    uninterrupted run agree on the step-EVERY checkpoint leaf for leaf."""
    rep = runs["reports"][0]
    assert all(r["crashed"] for r in runs["reports"])
    res = runs["resumed"]["2x2"]
    assert (res["from"], res["steps"]) == (EVERY, STEPS - EVERY)
    assert res["losses"] == rep["uninterrupted"][EVERY:]
    tc, dirs = runs["tc"], runs["dirs"]
    for step, other in ((EVERY, "crashed"), (STEPS, "2x2")):
        got = _leaves(_restore(dirs[other], step, tc)[0])
        want = _leaves(_restore(dirs["uninterrupted"], step, tc)[0])
        assert list(got) == list(want)
        for k, w in want.items():
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(w)), k


@pytest.mark.parametrize("where", ["1x2", "one", "jax"])
def test_resume_on_another_mesh_and_package(runs, where):
    """The crashed (2, 2) run's checkpoint resumed at (1, 2) in a 2-rank
    world, on one device, and in the reference's ``repro.train.loop.train``
    (its own local mesh): each restores the step-EVERY state, runs the
    last STEPS − EVERY steps and ends at the uninterrupted (2, 2) run's
    losses at 1e-5 relative and its final TrainState at fp32 1e-5 of each
    leaf's largest element (``v`` 2e-5; the reference: ``CROSS``, twice
    the untamed stack's noise floor); the counters, the rng key and the
    pipeline's cursor exact."""
    res, rep = runs["resumed"][where], runs["reports"][0]
    assert (res["from"], res["steps"]) == (EVERY, STEPS - EVERY)
    np.testing.assert_allclose(res["losses"], rep["uninterrupted"][EVERY:],
                               rtol=TOL)
    tc, dirs = runs["tc"], runs["dirs"]
    got = _leaves(_restore(dirs[where], STEPS, tc)[0])
    want = _leaves(_restore(dirs["uninterrupted"], STEPS, tc)[0])
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = torch.as_tensor(got[k]), torch.as_tensor(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if not w.is_floating_point():
            assert torch.equal(g, w), k
            continue
        tol = CROSS if where == "jax" else TOL
        tol = 2 * tol if k.startswith("train/opt/v/") else tol
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.double() - w.double()).abs().max()) <= tol * scale, k


def test_checkpoint_meta_names_the_rules_and_the_mesh(runs):
    """The (2, 2) run's manifest meta records its rules and mesh, and the
    world of 4 ranks, with the keys the reference's loop writes (its
    resume's own checkpoint: the reference's local mesh)."""
    tc, dirs = runs["tc"], runs["dirs"]
    _, meta = _restore(dirs["uninterrupted"], EVERY, tc)
    assert meta["rules"] == "baseline"
    assert meta["mesh"] == {"data": 2, "model": 2}
    assert meta["world"] == {"n_devices": 4}
    assert (meta["step"], meta["arch"]) == (EVERY, tc.name)
    _, j_meta = _restore(dirs["jax"], STEPS, tc)
    assert set(j_meta) == set(meta)
    assert j_meta["rules"] == "baseline"
    assert j_meta["mesh"] == dict(j_make_local_mesh().shape)
    _, one_meta = _restore(dirs["one"], STEPS, tc)
    assert one_meta["rules"] == "baseline"
    assert one_meta["mesh"] == {"data": 1, "model": 1}


def test_train_cli_model_parallel_2_prints_the_losses_of_1(runs):
    """``launch/train.py --model-parallel 2`` in the 4-rank world trains
    on mesh (2, 2) and prints the reference's two lines from rank 0 only:
    the first names the mesh and the variant, the second's losses are
    those of ``--model-parallel 1`` in a 1-rank world within twice the
    bf16 loop's own error (its losses against the fp32 loop's, one
    device, the same seed)."""
    assert runs["rank1_lines"] == 1                 # rank 1: its report only
    head, row = runs["cli_rows"]
    assert head["mesh"] == {"data": 2, "model": 2}
    assert head["variant"] == "baseline" and head["device"] == "cpu"
    one = t_launch_train.main(CLI)
    tc = runs["tc"]
    kw = dict(n_steps=4, global_batch=4, seq_len=16, log_every=10, seed=0,
              base_lr=1e-3, warmup=2, device="cpu")
    b16 = t_train(tc, None, None, **kw).losses
    f32 = t_train(tc, None, None, policy=TPolicy(compute=torch.float32),
                  **kw).losses
    assert [one["first_loss"], one["final_loss"]] == [b16[0], b16[-1]]
    bf16_err = max(abs(a - b) for a, b in zip(b16, f32))
    assert 0 < bf16_err < 0.1
    for key in ("first_loss", "final_loss"):
        assert abs(row[key] - one[key]) <= 2 * bf16_err, (key, row, one)
    assert row["steps_run"] == one["steps_run"] == 4


def test_train_cli_refuses_a_model_axis_the_world_cannot_hold(capsys):
    """``--model-parallel 2`` in a 1-rank world fails with the world's
    size, as the serve CLI does; an unknown variant part fails by name."""
    with pytest.raises(SystemExit):
        t_launch_train.main(CLI + ["--model-parallel", "2"])
    assert "world of 1 rank" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_launch_train.main(CLI + ["--variant", "nosuch"])
    assert "nosuch" in capsys.readouterr().err
