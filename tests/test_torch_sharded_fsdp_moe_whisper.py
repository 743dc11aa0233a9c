"""The port's sharded forward under FSDP (``make_variant("fsdp")``) in a
4-rank ``gloo`` world at mesh (2, 2), for the MoE family (qwen2-moe's
routed and shared experts, deepseek's MLA) and the encoder-decoder
(whisper): each param's largest replicated dim split over data as well,
gathered a layer at a time for its use; prefill logits, 4 decode steps
and the whole-sequence forward against the one-device path in fp32
(``assert_parity`` of tests/test_torch_sharded_forward.py)."""
import pytest

from test_torch_sharded_forward import assert_parity, parity_world

CASES = {   # name: (arch, kv heads (0: the config's), backend, variant)
    "moe": ("qwen2-moe-a2.7b", 0, "chunked", "fsdp"),
    "mla": ("deepseek-v2-lite-16b", 0, "chunked", "fsdp"),
    "whisper": ("whisper-tiny", 0, "chunked", "fsdp"),
}


@pytest.fixture(scope="module")
def reports():
    return parity_world((2, 2), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_forward_matches_one_device_at_2x2(reports, case):
    for rep in reports:
        assert_parity(rep[case])
