"""Tensor parallelism without SP in training, against JAX's GSPMD: the port's
Megatron column / row shards with the all-reduce pair (f and g), on gloo
ranks on the CPU, take three f32 AdamW steps from JAX's weights, and the
losses and every parameter must stay within 1e-5 and 1e-4 of JAX's same
steps on fake devices (``tests/torch_tp.py``).  Cases here:
qwen3-1.7b-reduced (fused, head-aligned ``wqkv``, qk-norm) at model 2 and
on a (data 2, model 2) mesh; MoE's splits are in ``test_torch_tp_moe.py``.
The chip script's planted controls (g skipped after ``wo`` in the first
layer, the replicated leaves' gradients summed over ``model``) fall outside
the bounds."""
import numpy as np
import pytest

from test_torch_dist_ranks import run_ranks
from torch_tp import (HEADS, jax_params, jax_tp_steps, port_cfg, tp_batches, tp_control_rank,
                      tp_plan, tp_train_rank)

CASES = {
    "dense": ("qwen3-1.7b", HEADS, 1, "none"),
    "dense data 2": ("qwen3-1.7b", HEADS, 2, "none"),
}


def check_against_jax(tmp_path, arch, replace, data, moe_mode):
    """Three steps on the port's ranks and on JAX's fake devices: losses
    within 1e-5, every parameter within 1e-4."""
    cfg = port_cfg(arch, replace)
    shape = {"data": data, "model": 2}
    plan = tp_plan(cfg, shape)
    assert plan.moe_mode == moe_mode and plan.fuse_qkv
    batches = tp_batches(cfg, seed=70)
    jax_done = jax_tp_steps(tmp_path / "jax", arch, replace, batches, data=data)
    res = run_ranks(tp_train_rank, 2 * data, tmp_path, cfg, plan, shape,
                    jax_params(arch, replace), batches)
    jx, jp = jax_done()
    assert (jx["moe_mode"], jx["microbatches"], jx["remat"]) == (
        plan.moe_mode, plan.microbatches, plan.remat)
    for r in res:
        assert max(abs(a - b) for a, b in zip(r["losses"], jx["losses"])) < 1e-5, (
            r["losses"], jx["losses"])
        assert r["params"].keys() == jp.keys()
        for k, p in r["params"].items():
            np.testing.assert_allclose(p.numpy(), jp[k], rtol=0, atol=1e-4, err_msg=k)
        assert r["losses"][0] != r["losses"][-1]
        # the pair ran: g after every sharded block's row-parallel product,
        # f's gradient sums in the backward
        assert r["calls"]["tp_row_sum"] > 0 and r["calls"]["tp_grad_sum"] > 0
    assert res[0]["losses"] == res[1]["losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_steps_match_jax_gspmd(tmp_path, case):
    check_against_jax(tmp_path, *CASES[case])


@pytest.mark.parametrize("control", ["skip_g", "sum_replicated"])
def test_planted_controls_fall_outside(tmp_path, control):
    """The chip script's two controls at the dense case's bounds: each moves
    the losses or the parameters past them (against the unplanted run)."""
    arch, replace, _, _ = CASES["dense"]
    cfg = port_cfg(arch, replace)
    shape = {"data": 1, "model": 2}
    plan = tp_plan(cfg, shape)
    batches = tp_batches(cfg, seed=71, n=2)
    np_params = jax_params(arch, replace)
    good, bad = run_ranks(tp_control_rank, 2, tmp_path, cfg, plan, shape, np_params, batches,
                          control)[0]
    loss_dev = max(abs(a - b) for a, b in zip(bad["losses"], good["losses"]))
    param_dev = max(float(np.abs(bad["params"][k].numpy() - p.numpy()).max())
                    for k, p in good["params"].items())
    assert loss_dev > 1e-5 or param_dev > 1e-4, (control, loss_dev, param_dev)
