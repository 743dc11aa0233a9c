"""The port's sharded forward under every rules variant besides baseline
and FSDP (``sharding.make_variant``), in a 2-rank ``gloo`` world at mesh
(1, 2): prefill logits, 4 decode steps and the whole-sequence forward
against the one-device path in fp32 (``assert_parity`` of tests/test_torch_sharded_forward.py).
``kvseq`` splits the K/V cache over its sequence (each rank writes the
slots of its window, ``attention._write_slots``); ``seqshard`` the
activations over theirs; ``sp_saves`` only the remat saves of a training
forward, so it serves as baseline; ``expert_ff`` the MoE's expert FFN dim
in place of its experts; ``dponly`` and ``dponly_fsdp`` the batch over
every axis, FSDP over both."""
import pytest

from test_torch_sharded_forward import assert_parity, parity_world

CASES = {   # name: (arch, kv heads (0: the config's), backend, variant)
    "kvseq": ("smollm-135m", 2, "chunked", "kvseq"),
    "seqshard": ("smollm-135m", 2, "chunked", "seqshard"),
    "sp_saves": ("smollm-135m", 2, "chunked", "sp_saves"),
    "expert_ff": ("qwen2-moe-a2.7b", 0, "chunked", "expert_ff"),
    "dponly": ("smollm-135m", 2, "chunked", "dponly"),
    "dponly_fsdp": ("smollm-135m", 2, "chunked", "dponly_fsdp"),
}


@pytest.fixture(scope="module")
def reports():
    return parity_world((1, 2), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_forward_matches_one_device_at_1x2(reports, case):
    for rep in reports:
        assert_parity(rep[case])
