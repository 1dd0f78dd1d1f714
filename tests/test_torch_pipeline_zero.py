"""ZeRO weights under the GPipe pipeline against JAX's GSPMD pipeline
(``tests/torch_fsdp.py``'s recipe and bounds: three f32 AdamW steps from
JAX's weights, losses within 1e-5, every parameter within 1e-4, each rank's
local leaf shapes equal to JAX's shard shapes), on four gloo ranks at (pod
2, data 2, model 1), ``pod_role="pipeline"``: two stages, each stage's
slice of the stack sharded over ``data`` on its ZeRO dim, gathered at the
stage's entry and its gradient reduce-scattered.  The reduced archs are
too small for ``derive_plan`` to pick ZeRO, so every case sets
``zero_weights`` with ``dataclasses.replace`` on both packages' plan:
smollm-135m-reduced at 4 layers (2 groups a stage), remat on and off, and
TEMPORAL with ``dp_over_model`` (the full-size launcher's layout for
phi4-mini-3.8b); recurrentgemma-9b-reduced at 7 layers (a group a stage
and a ZeRO'd tail layer, gathered where it is read).  Each case also
round-trips checkpoints bit for bit across the pipeline + ZeRO layout, one
process and plain FSDP on the same ranks.  Every case's JAX steps run in
one subprocess.  The chip script's two planted controls (the stage
gradients' scatter skipped, a rank gathering its neighbour's shard) fall
outside the bounds."""
import numpy as np
import pytest
import torch

from test_torch_dist_ranks import run_ranks
from torch_fsdp import (batches, check_against_jax, fsdp_control_rank, fsdp_plan,
                        fsdp_train_rank, jax_cases, jax_params)
from torch_tp import port_cfg

MESH = {"pod": 2, "data": 2, "model": 1}
PIPELINE = {"pod_role": "pipeline"}
ZERO = {"zero_weights": True}
CASES = {
    "smollm remat": ("smollm-135m", {"n_layers": 4}, PIPELINE, {**ZERO, "remat": True}),
    "smollm": ("smollm-135m", {"n_layers": 4}, PIPELINE, {**ZERO, "remat": False}),
    "smollm temporal": ("smollm-135m", {"n_layers": 4}, {**PIPELINE, "force_mode": "temporal"},
                        {**ZERO, "dp_over_model": True}),
    "recurrentgemma tail": ("recurrentgemma-9b", {"n_layers": 7}, PIPELINE, ZERO),
}
SEED = 95
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Every case's JAX steps, started once in one subprocess at the
    module's first test."""
    done = jax_cases(tmp_path_factory.mktemp("jax"), [
        (arch, replace, MESH, derive, fields, batches(port_cfg(arch, replace), SEED, STEPS))
        for arch, replace, derive, fields in CASES.values()])
    return {case: (lambda i=i: done()[i]) for i, case in enumerate(CASES)}


def _equal(a, b) -> bool:
    from repro_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _pipeline_zero_rank(rank, cfg, plan, shape, np_params, batch_list, ckpt_dir):
    """``fsdp_train_rank``'s steps, then checkpoints across layouts on the
    same ranks: the trained pipeline + ZeRO state (gathered, rank 0 writes)
    restored onto its own layout, onto one process and onto plain ZeRO at
    (data 4, model 1), and a one-process state restored onto pipeline +
    ZeRO; each compared bit for bit."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.dist.sharding import NamedSharding, Shardings, gather, place
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.optimizer import TrainState, init_state, tree_leaves

    out = fsdp_train_rank(rank, cfg, plan, shape, np_params, batch_list, keep_state=True)
    state, shard, mesh, full = (out.pop(k) for k in ("state", "shard", "mesh", "full"))

    def state_shardings(m, sh):
        return TrainState(step=NamedSharding(m, ()), params=sh, m=sh, v=sh, residual=None)

    state_sh = state_shardings(mesh, shard)
    whole = gather(state, state_sh)
    one = init_state(full, with_residual=False)
    if rank == 0:
        save_checkpoint(f"{ckpt_dir}/pipeline", STEPS, whole)
        save_checkpoint(f"{ckpt_dir}/one", 0, one)
    torch.distributed.barrier()
    flat = Mesh({"data": 4, "model": 1})
    fplan = fsdp_plan(cfg, dict(flat.shape), {}, ZERO)
    flat_sh = state_shardings(flat, Shardings(flat, fplan, cfg).manual_param_shardings(full))
    flat_local = restore_checkpoint(f"{ckpt_dir}/pipeline", STEPS, place(whole, flat_sh),
                                    shardings=flat_sh)
    out["ckpt"] = {
        "own layout": _equal(restore_checkpoint(f"{ckpt_dir}/pipeline", STEPS, state,
                                                shardings=state_sh), state),
        "one process": _equal(restore_checkpoint(f"{ckpt_dir}/pipeline", STEPS, whole), whole),
        "plain ZeRO": _equal(gather(flat_local, flat_sh), whole),
        "one onto pipeline": _equal(restore_checkpoint(f"{ckpt_dir}/one", 0, state,
                                                       shardings=state_sh),
                                    place(one, state_sh)),
    }
    # the flat layout cuts the same leaves another way: other local shapes
    out["flat_differs"] = any(a.shape != b.shape for a, b in zip(
        tree_leaves(flat_local.params), tree_leaves(state.params)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_zero_steps_match_jax_gspmd(tmp_path, jax_runs, case):
    arch, replace, derive, fields = CASES[case]
    cfg = port_cfg(arch, replace)
    plan = fsdp_plan(cfg, MESH, derive, fields)
    assert plan.pod_role == "pipeline" and plan.zero_weights and plan.pod_axis == 2
    res, jx = check_against_jax(tmp_path, arch, replace, MESH, derive, fields, seed=SEED,
                                jax_run=jax_runs[case], rank_fn=_pipeline_zero_rank,
                                rank_args=(str(tmp_path / "ckpt"),))
    shapes = jx["shard_shapes"]
    wqkv = res[0]["params"]["blocks|stack|0|attn|wqkv" if arch == "smollm-135m"
                            else "blocks|stack|2|attn|wqkv"].shape
    # the stage slice: half the groups (pod) and, in JAX's layout, half the
    # ZeRO dim (data), the one the plan's mode picks
    zdim = -1 if derive.get("force_mode") == "temporal" else -2
    want = [wqkv[0] // 2, *wqkv[1:]]
    want[zdim] //= 2
    assert shapes["blocks|stack|0|attn|wqkv" if arch == "smollm-135m"
                  else "blocks|stack|2|attn|wqkv"] == want
    if arch == "recurrentgemma-9b":  # the tail layer's ZeRO'd leaves, whole groups of one
        assert shapes["blocks|tail|0|attn|w_x"] != list(res[0]["params"][
            "blocks|tail|0|attn|w_x"].shape)
    for r in res:
        calls = r["calls"]
        # ZeRO's gathers and scatters over data, the ticks' permutes over pod
        assert calls["fsdp_gather"] > 0 and calls["fsdp_scatter"] > 0 and calls["permute"] > 0
        assert all(r["ckpt"].values()), r["ckpt"]
        assert r["flat_differs"]


@pytest.mark.parametrize("control", ["skip_stage_scatter", "neighbour_shard"])
def test_planted_controls_fall_outside(tmp_path, control):
    arch, replace, derive, fields = CASES["smollm"]
    cfg = port_cfg(arch, replace)
    plan = fsdp_plan(cfg, MESH, derive, fields)
    good, bad = run_ranks(fsdp_control_rank, 4, tmp_path, cfg, plan, MESH,
                          jax_params(arch, replace, plan.fuse_qkv),
                          batches(cfg, seed=SEED + 1, n=2), control)[0]
    loss_dev = max(abs(a - b) for a, b in zip(bad["losses"], good["losses"]))
    param_dev = max(float(np.abs(bad["params"][k].numpy() - p.numpy()).max())
                    for k, p in good["params"].items())
    assert loss_dev > 1e-5 or param_dev > 1e-4, (control, loss_dev, param_dev)
