"""``dp_over_model`` on the recurrent and the encoder-decoder archs, against
JAX's GSPMD (``tests/torch_fsdp.py``'s bounds), at (data 1, model 2):
rwkv6-1.6b-reduced (time-mix and channel-mix projections split over
``model``, the untied embedding and head too) and whisper-small-reduced
(the encoder stack gathers as the decoder's does; cross-attention's
projections too).  Neither plan has remat, so each group runs with its
gathered weights kept as shards for the backward and gathered again
there."""
import pytest

from torch_fsdp import check_against_jax

CASES = ["rwkv6-1.6b", "whisper-small"]


@pytest.mark.parametrize("arch", CASES)
def test_dp_over_model_archs_match_jax_gspmd(tmp_path, arch):
    res, jx = check_against_jax(tmp_path, arch, {}, {"data": 1, "model": 2}, {},
                                {"dp_over_model": True})
    assert not jx["remat"]
    for r in res:
        assert r["calls"]["fsdp_regather"] > 0
        if arch == "whisper-small":
            assert any(k.startswith("encoder|") and v != list(r["params"][k].shape)
                       for k, v in r["local_shapes"].items())
