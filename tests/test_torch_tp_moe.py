"""MoE under tensor parallelism without SP, against JAX's GSPMD
(``test_torch_tp_train.py``'s bounds: losses within 1e-5 and every
parameter within 1e-4 after three f32 AdamW steps at model 2).
mixtral-8x7b-reduced with 4 query / 2 KV heads: the expert split ``ep``
(4 experts, 2 a rank: the router and its aux loss whole on every rank,
each rank's slice of the combine tensor) and the width split ``tp`` (3
experts widened to ``moe_d_ff`` 512, so ``derive_plan`` picks it: every
rank a column slice of ``w1`` / ``w3`` and a row slice of ``w2``), each
with the GShard dispatch."""
import pytest

from test_torch_tp_train import check_against_jax
from torch_tp import HEADS, MOE_TP

CASES = {"ep": HEADS, "tp": MOE_TP}


@pytest.mark.parametrize("mode", list(CASES))
def test_moe_splits_match_jax_gspmd(tmp_path, mode):
    check_against_jax(tmp_path, "mixtral-8x7b", CASES[mode], 1, mode)
