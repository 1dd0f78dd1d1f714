"""FSDP over the data-parallel axes, against JAX's GSPMD (``tests/torch_fsdp.py``:
three f32 AdamW steps, losses within 1e-5, parameters within 1e-4, each
rank's local leaves the shape of JAX's shards).  ``dp_over_model`` on
qwen3-1.7b-reduced (4 query / 2 KV heads): the model axis folded into data
parallelism at (data 1, model 2), every projection split over ``model`` on
its last dim and the tied embedding over ``model`` on its rows, each
gathered where it is read; at (data 2, model 1) the same split over
``data`` (the embedding stays whole: its split is over ``model``), with
remat on, so each group's gathers repeat in the backward.  The chip
script's two planted controls (the embedding's gradient scatter skipped, a
rank gathering its neighbour's shard) fall outside the bounds."""
import numpy as np
import pytest

from test_torch_dist_ranks import run_ranks
from torch_fsdp import batches, check_against_jax, fsdp_control_rank, fsdp_plan, jax_params
from torch_tp import HEADS, port_cfg

FOLD = {"dp_over_model": True}
CASES = {
    "model 2": ({"data": 1, "model": 2}, FOLD),
    "data 2, remat": ({"data": 2, "model": 1}, {**FOLD, "remat": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dp_over_model_steps_match_jax_gspmd(tmp_path, case):
    shape, plan = CASES[case]
    res, _ = check_against_jax(tmp_path, "qwen3-1.7b", HEADS, shape, {}, plan)
    for r in res:
        calls = r["calls"]
        # every projection gathered (again under remat) and scattered back
        assert calls["fsdp_gather"] > 0 and calls["fsdp_scatter"] > 0
        if "remat" in case:
            assert calls["fsdp_gather"] == 2 * calls["fsdp_scatter"]
        else:  # without remat the saved weights are kept as shards and gathered again
            assert calls["fsdp_regather"] > 0
        # the f32 weights and moments a rank hold: well under the whole
        whole = 3 * 4 * sum(p.numel() for p in r["params"].values())
        assert r["state_bytes"] < 0.75 * whole, (r["state_bytes"], whole)


@pytest.mark.parametrize("control", ["skip_scatter", "neighbour_shard"])
def test_planted_controls_fall_outside(tmp_path, control):
    cfg = port_cfg("qwen3-1.7b", HEADS)
    shape = {"data": 1, "model": 2}
    plan = fsdp_plan(cfg, shape, {}, FOLD)
    good, bad = run_ranks(fsdp_control_rank, 2, tmp_path, cfg, plan, shape,
                          jax_params("qwen3-1.7b", HEADS, plan.fuse_qkv),
                          batches(cfg, seed=81, n=2), control)[0]
    loss_dev = max(abs(a - b) for a, b in zip(bad["losses"], good["losses"]))
    param_dev = max(float(np.abs(bad["params"][k].numpy() - p.numpy()).max())
                    for k, p in good["params"].items())
    assert loss_dev > 1e-5 or param_dev > 1e-4, (control, loss_dev, param_dev)
