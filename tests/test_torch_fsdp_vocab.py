"""The embedding and LM head cut over the vocabulary under tensor and
sequence parallelism (``embed_shard == "vocab"``), against JAX's GSPMD
(``tests/torch_fsdp.py``'s bounds), at model 2 on qwen3-1.7b-reduced (4
query / 2 KV heads): each rank looks its tokens up in its own rows (the
rest zeroed, then summed by g) and takes the cross-entropy's logsumexp and
target logit across the ranks.  TP with an untied head (its columns cut)
and Megatron-SP with the tied one."""
import pytest

from torch_fsdp import check_against_jax
from torch_tp import HEADS

CASES = {
    "tp untied": ({**HEADS, "tie_embeddings": False}, {"force_mode": "spatial"}),
    "sp tied": (HEADS, {"force_mode": "spatial", "seq_parallel": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vocab_split_matches_jax_gspmd(tmp_path, case):
    replace, derive = CASES[case]
    res, jx = check_against_jax(tmp_path, "qwen3-1.7b", replace, {"data": 1, "model": 2},
                                derive, {})
    assert jx["embed_shard"] == "vocab"
    for r in res:
        assert r["local_shapes"]["embed"][0] * 2 == r["params"]["embed"].shape[0]
        if "untied" in case:
            assert r["local_shapes"]["lm_head"][1] * 2 == r["params"]["lm_head"].shape[1]
        calls = r["calls"]
        assert calls["vocab_max"] > 0 and calls["vocab_sum"] > 0
        assert "fsdp_gather" not in calls  # computed on where it lies, never gathered
