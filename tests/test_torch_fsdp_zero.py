"""ZeRO weights against JAX's GSPMD (``tests/torch_fsdp.py``'s bounds), on
four gloo ranks at (data 2, model 2), SPATIAL forced, ``zero_weights`` set
on both packages' plan: with tensor parallelism on qwen3-1.7b-reduced (4
query / 2 KV heads: each column-parallel projection's rows split over
``data`` under its ``model`` columns, the fused ``wqkv`` cut head-aligned
over ``model``; each row-parallel one's columns over ``data``; the tied
embedding cut over the vocabulary), and with MoE on mixtral-8x7b-reduced
(the attention ZeRO'd the same way, the experts split over ``model`` as
the plan's ``ep`` says and never over ``data``, the router whole).  And
plain data parallelism of the MoE arch, whose aux loss spans the ranks."""
import pytest

from torch_fsdp import check_against_jax
from torch_tp import HEADS

ZERO = {"zero_weights": True}
CASES = {"tp": "qwen3-1.7b", "moe ep": "mixtral-8x7b"}


@pytest.mark.parametrize("case", list(CASES))
def test_zero_steps_match_jax_gspmd(tmp_path, case):
    res, jx = check_against_jax(tmp_path, CASES[case], HEADS, {"data": 2, "model": 2},
                                {"force_mode": "spatial"}, ZERO)
    for r in res:
        calls = r["calls"]
        # ZeRO's gathers and scatters over data, Megatron's pair over model
        assert calls["fsdp_gather"] > 0 and calls["fsdp_scatter"] > 0
        assert calls["tp_row_sum"] > 0 and calls["tp_grad_sum"] > 0
    shapes = jx["shard_shapes"]
    assert shapes["blocks|stack|0|attn|wo"][-1] == res[0]["params"][
        "blocks|stack|0|attn|wo"].shape[-1] // 2  # the data split of the row-parallel leaf
    if case == "moe ep":  # experts never split over data
        w1 = res[0]["params"]["blocks|stack|0|ffn|w1"].shape
        assert shapes["blocks|stack|0|ffn|w1"] == [w1[0], w1[1] // 2, w1[2], w1[3]]


def test_moe_aux_loss_covers_the_whole_batch(tmp_path):
    """Data parallelism of an MoE arch, (data 2, model 1), no ZeRO: each
    rank routes its own rows, and the load-balance aux loss must still be
    the whole batch's (its mean probabilities and expert shares averaged
    over the ranks before their product), as JAX's is; taken per rank, the
    first loss sat 3.4e-4 from JAX's."""
    res, _ = check_against_jax(tmp_path, "mixtral-8x7b", HEADS, {"data": 2, "model": 1},
                               {"force_mode": "spatial"}, {})
    for r in res:
        assert r["calls"]["batch_mean"] > 0
