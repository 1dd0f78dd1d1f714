"""The port's training launcher over ranks (``repro_torch.launch.train``):
``main`` with JAX's mesh flags on 2 and 4 gloo ranks on the CPU (each rank
calls it as ``torchrun`` would, the process group started from a
``file://`` rendezvous under ``tmp_path``), one real ``torchrun`` launch
(``python -m torch.distributed.run --standalone``: the OS picks its port),
the gradient exchange's route (f32 sums, or the int8 wire's max and
int32 sums), the refusals that remain, each matched on its message, and a checkpoint
saved by one rank restored onto a 2-rank Megatron-SP layout, whose next
steps equal the one-rank resumed run's."""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_dist_ranks import run_ranks

ARGS = ["--device", "cpu", "--steps", "3", "--batch", "8", "--seq", "32"]


def _main_rank(rank, runs):
    from repro_torch.launch.train import main

    out = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = main(argv)
        out.append({"losses": losses, "stdout": buf.getvalue()})
    return out


def test_two_ranks_train_dp_wire_and_sp(tmp_path):
    runs = [["--arch", "smollm-135m-reduced", *ARGS, "--dp", "2"],
            ["--arch", "smollm-135m-reduced", *ARGS, "--dp", "2", "--compression", "int8"],
            ["--arch", "bert-base-reduced", *ARGS, "--seq-parallel", "--force-mode", "spatial"]]
    res = run_ranks(_main_rank, 2, tmp_path, runs)
    for i in range(len(runs)):
        a, b = res[0][i], res[1][i]
        assert a["losses"] == b["losses"] and len(a["losses"]) == 3
        assert all(np.isfinite(a["losses"])) and a["losses"][0] != a["losses"][-1]
        assert "backend gloo" in a["stdout"] and "final loss" in a["stdout"]
        assert b["stdout"] == ""  # only rank 0 prints
    assert "'data': 2, 'model': 1" in res[0][0]["stdout"]
    assert "'data': 1, 'model': 2" in res[0][2]["stdout"]
    assert "infeasible" not in res[0][2]["stdout"]
    # the int8 wire against the f32 mean: the same steps to int8 precision
    np.testing.assert_allclose(res[0][1]["losses"], res[0][0]["losses"], rtol=0, atol=1e-3)


def test_pipeline_matches_data_parallel(tmp_path):
    """JAX's ``test_pipeline_train_matches_data_parallel_subprocess`` on 4
    ranks: 2 stages x dp 2 against dp 4, losses within 1e-4."""
    runs = [["--arch", "smollm-135m-reduced", *ARGS, "--pipeline", "2"],
            ["--arch", "smollm-135m-reduced", *ARGS, "--dp", "4"]]
    res = run_ranks(_main_rank, 4, tmp_path, runs)
    pipe, base = res[0][0], res[0][1]
    assert "pipeline: 2 stages x 4 microbatches (bubble 20.0%)" in pipe["stdout"]
    assert max(abs(a - b) for a, b in zip(pipe["losses"], base["losses"])) < 1e-4
    assert pipe["losses"][0] != pipe["losses"][-1]
    assert all(r[0]["losses"] == pipe["losses"] for r in res)


def _exchange_rank(rank, flags):
    from repro_torch.dist import collectives as C
    from repro_torch.launch.train import run
    from repro_torch.train.optimizer import tree_leaves

    C.reset_stats()
    _, state = run("smollm-135m-reduced", steps=2, batch=8, seq=32, log_every=0, device="cpu",
                   **flags)
    return dict(C.STATS["reduce_ops"]), len(tree_leaves(state.params))


@pytest.mark.parametrize("flags, route", [
    ({"dp": 2}, "f32"),
    ({"dp": 2, "force_mode": "spatial", "compression": "int8"}, "int8"),
])
def test_gradient_exchange_takes_its_route(tmp_path, flags, route):
    """The all-reduces of 2 steps on 2 ranks, by operation and word type
    (what the chip script checks on each rank): data parallelism sums every
    gradient leaf in f32, the int8 wire takes a max (the shared scale) and
    an int32 sum a leaf and sums nothing else but the loss's mean; each
    step means the loss once."""
    for ops, n_leaves in run_ranks(_exchange_rank, 2, tmp_path, flags):
        if route == "int8":
            assert ops == {"max:float32": 2 * n_leaves, "sum:int32": 2 * n_leaves,
                           "sum:float32": 2}
        else:
            assert ops == {"sum:float32": 2 * n_leaves + 2}


def _refusals_rank(rank):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import unexecuted_layout
    from repro_torch.launch import train as LT
    from repro_torch.models.transformer import check_pipeline_supported

    out = {}
    for name, arch, kw in [("moe", "qwen3-moe-30b-a3b-reduced", {"pipeline": 2}),
                           ("enc_dec", "whisper-small-reduced", {"pipeline": 2}),
                           ("tp", "rwkv6-1.6b-reduced", {"force_mode": "spatial"}),
                           ("sp_zero", "bert-base-reduced",
                            {"dp": 2, "seq_parallel": True, "force_mode": "spatial"})]:
        orig = plan_for = LT.launch_plan
        if name == "sp_zero":  # the SP plan with ZeRO set by hand: no planner makes it
            def plan_for(*a, **k):
                shape, plan = orig(*a, **k)
                assert plan.seq_parallel_acts and not plan.zero_weights
                return shape, dataclasses.replace(plan, zero_weights=True)
        LT.launch_plan = plan_for
        try:
            LT.run(arch, steps=1, batch=8, seq=32, device="cpu", log_every=0, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        finally:
            LT.launch_plan = orig
    # the launcher's ZeRO pipeline plan of a full-size arch (only planned:
    # too large to run here) is executed, not refused
    cfg = get_config("mistral-large-123b")
    _, plan = LT.launch_plan(cfg, 4, batch=8, seq=32, pipeline=2, dp=2)
    check_pipeline_supported(cfg, plan, 8)
    out["zero"] = (plan.zero_weights, unexecuted_layout(plan, cfg))
    return out


def test_refusals_that_remain(tmp_path):
    """On 4 ranks: the pipeline refuses MoE and encoder-decoder archs; ZeRO
    under the pipeline is a plan the launcher executes (ZeRO elsewhere runs
    as FSDP); ZeRO under Megatron-SP, a plan built by hand, is refused with
    the reference's own reason; TP of recurrent layers trains (rwkv6-reduced's
    2 heads do not divide over model 4, so its time-mix runs whole beside
    the sharded channel-mix)."""
    res = run_ranks(_refusals_rank, 4, tmp_path)
    for r in res:
        assert "MoE aux losses do not cross stage boundaries" in r["moe"]
        assert "enc-dec/frontends keep non-stack state" in r["enc_dec"]
        assert r["tp"] is None
        assert r["zero"] == (True, None)
        assert "ZeRO weights" in r["sp_zero"] and "Megatron-SP" in r["sp_zero"]
        assert "sp_feasible" in r["sp_zero"] and "ROADMAP" not in r["sp_zero"]


def test_torchrun_launches_the_cli(tmp_path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": "src",
           "OMP_NUM_THREADS": "1", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "smollm-135m-reduced", "--device",
           "cpu", "--steps", "2", "--batch", "4", "--seq", "16", "--dp", "2", "--compression",
           "int8"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=env, cwd=".")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("final loss") == 1 and "backend gloo" in r.stdout


def _resume_rank(rank, ckpt_dir):
    from repro_torch.launch.train import run

    losses, state = run("bert-base-reduced", steps=4, batch=4, seq=32, ckpt_dir=ckpt_dir,
                        ckpt_every=100, resume=True, seq_parallel=True, force_mode="spatial",
                        log_every=0, device="cpu")
    return losses


def test_one_rank_checkpoint_resumes_on_sp_ranks(tmp_path):
    """Two steps on one rank with the SP plan's unfused q / k / v, saved;
    the one-rank run resumed for two more, and the same checkpoint resumed
    on a 2-rank Megatron-SP layout (each rank keeps its model shards): the
    same losses, to f32 reduction order."""
    from repro_torch.ckpt.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_plan
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("bert-base-reduced")
    plan = derive_plan(cfg, {"data": 1, "model": 1}, batch=4, seq_len=32, fuse_qkv=False)
    gen = torch.Generator().manual_seed(0)
    state = init_state(init_params(cfg, plan, torch.float32, generator=gen, device="cpu"))
    step = make_train_step(cfg, plan, OptimizerConfig(peak_lr=3e-4, warmup_steps=5,
                                                      total_steps=4), device="cpu")
    data = DataIterator(DataConfig(cfg.vocab_size, 32, 4, seed=0), device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    losses = []
    for i in range(4):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
        if i == 1:
            save_checkpoint(ckpt_dir, 2, state)
    res = run_ranks(_resume_rank, 2, tmp_path, ckpt_dir)
    for r in res:
        assert len(r) == 2
        np.testing.assert_allclose(r, losses[2:], rtol=0, atol=1e-5)
