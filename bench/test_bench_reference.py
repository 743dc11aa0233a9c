"""The plain reference against the program at smoke widths, float32 on
both sides: logits through the prefill and the full forward (MoE
capacity drops included), one training step's loss, first gradients and
change; and the fp8 rounding of the control."""
import pytest
import torch

import system
import tiny
from reference import model as ref
from reference import train as rtrain


def _program(hf, s):
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import get_api
    cfg = system.program_cfg(hf)
    api = get_api(cfg)
    params = system.make_weights(api.param_defs(cfg, s), 11, 0.2,
                                 torch.float32, "cpu")
    return cfg, api, params, Policy(compute=torch.float32)


@pytest.mark.parametrize("hf", [tiny.LLAMA, tiny.DEEPSEEK],
                         ids=["llama", "deepseek_v2"])
def test_reference_logits_match_the_program(hf):
    s = 512 if hf is tiny.DEEPSEEK else 64     # two MoE groups of 256
    cfg, api, params, pol = _program(hf, s)
    toks = torch.randint(0, hf["vocab_size"], (2, s),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        last, _ = api.prefill(cfg, params, toks, {}, s, pol)
        full, _ = api.forward(cfg, params, {"tokens": toks}, pol, False)
    groups = ref.groups(hf, s)
    got = ref.logits_at(hf, params, toks, list(range(s)), groups, rows=1)
    scale = float(full.abs().max())
    assert float((got - full).abs().max()) <= 1e-5 * scale
    assert float((got[:, -1] - last).abs().max()) <= 1e-5 * scale


def test_reference_training_step_matches_the_program():
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.train.step import make_train_step
    hf, wl = tiny.LLAMA, tiny.TRAIN
    cfg, api, params, pol = _program(hf, wl["seq"])
    opt = wl["optimizer"]
    init = rtrain._map(params, torch.clone)
    step, _ = make_train_step(cfg, None, None, base_lr=1e-2,
                              warmup=opt["warmup"],
                              total_steps=opt["total_steps"], policy=pol,
                              adamw=AdamWCfg(b1=opt["b1"], b2=opt["b2"]))
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32),
             "rng": torch.zeros((2,), dtype=torch.uint32),
             "data_cursor": torch.zeros((), dtype=torch.int32)}
    batches = [tuple(torch.as_tensor(x) for x in rtrain.token_batch(
        5, i, hf["vocab_size"], 2, wl["seq"])) for i in range(2)]
    losses = []
    for i, (tok, tgt) in enumerate(batches):
        state, m = step(state, {"tokens": tok, "targets": tgt})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = rtrain.norms(rtrain._map(state["opt"]["m"],
                                             lambda x: x / (1 - opt["b1"])))
    got = rtrain.train(hf, init, batches, dict(opt, lr=1e-2))
    assert got["losses"] == pytest.approx(losses, rel=1e-5)
    for k, v in got["grads"].items():
        assert v == pytest.approx(grads[k], rel=1e-4, abs=1e-9), k
    change = rtrain.norms(rtrain._map2(state["params"], init,
                                       lambda a, b: a - b))
    for k, v in got["change"].items():
        assert v == pytest.approx(change[k], rel=1e-3, abs=1e-9), k


def test_fp8_rounds_forward_in_e4m3_and_gradients_in_e5m2():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.q8(x)
    err = float((y - x).detach().abs().max())
    assert 0 < err <= 3 * 2 ** -4
    g = torch.linspace(0.5, 1.5, 101)
    y.backward(g)
    assert float((x.grad - g).abs().max()) > 0
    assert float((x.grad - g).abs().max()) <= 1.5 * 2 ** -3
    p = ref.Prec("fp8")
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert float((p.mm(a, b) - a @ b).abs().max()) > 0


def test_capacity_drops_the_late_tokens_of_a_group():
    hf = tiny.DEEPSEEK
    assert ref.capacity(256, hf) == int(256 * 2 * 1.25 / 8) + 1
    assert ref.capacity(1, hf) == 1
