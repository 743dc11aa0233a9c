"""The port's sharded forward under FSDP (``make_variant("fsdp")``) in a
4-rank ``gloo`` world at mesh (2, 2): each param's largest replicated dim
split over data as well, gathered a layer at a time for its use
(``sharding.gather_fsdp``, ZeRO-3's gather); prefill logits, 4 decode
steps and the whole-sequence forward against the one-device path in
fp32, for both GQA branches and the hybrid (``assert_parity`` of
tests/test_torch_sharded_forward.py; the MoE family and whisper:
tests/test_torch_sharded_fsdp_moe_whisper.py)."""
import pytest

from test_torch_sharded_forward import assert_parity, parity_world

CASES = {   # name: (arch, kv heads (0: the config's), backend, variant)
    "fold": ("smollm-135m", 2, "chunked", "fsdp"),
    "expand": ("smollm-135m", 1, "chunked", "fsdp"),
    "hybrid": ("recurrentgemma-9b", 0, "chunked", "fsdp"),
}


@pytest.fixture(scope="module")
def reports():
    return parity_world((2, 2), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_forward_matches_one_device_at_2x2(reports, case):
    for rep in reports:
        assert_parity(rep[case])
