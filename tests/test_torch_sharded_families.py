"""The port's sharded forward for the last two families, in a 2-rank
``gloo`` world at mesh (1, 2) under the baseline rules: xLSTM (the
chunkwise mLSTM over heads split over model, its inner width and conv
split over the ffn axis; the sLSTM's four gates of each rank's own heads,
its loop over time on DTensors; decode updating the split state in place)
and whisper (the encoder over split heads inside the prefill, the frames
laid out at the reference's ``shard_act``, the decoder's self and cross
K/V split over the kv heads).  Prefill logits, 4 decode steps and the
whole-sequence forward against the one-device path in fp32 (``assert_parity`` of
tests/test_torch_sharded_forward.py)."""
import pytest

from test_torch_sharded_forward import assert_parity, parity_world

CASES = {   # name: (arch, kv heads, backend, variant[, batch, prompt])
    # B=2, an 8-token prompt: the sLSTM loops over time, op by op
    "xlstm": ("xlstm-1.3b", 0, "chunked", "baseline", 2, 8),
    "whisper": ("whisper-tiny", 0, "chunked", "baseline"),
}


@pytest.fixture(scope="module")
def reports():
    return parity_world((1, 2), CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_forward_matches_one_device_at_1x2(reports, case):
    for rep in reports:
        assert_parity(rep[case], split_cache=True)
