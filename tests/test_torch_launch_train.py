"""The port's training launcher (``repro_torch.launch.train``): the JAX
end-to-end descent tests (``tests/test_system.py``) through
``run(..., device="cpu")``, the CLI with its checkpoint flags, the mesh
flags the port refuses with their ROADMAP item, a step of every arch, and
the step watchdog."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import derive_execution_plan
from repro_torch.launch.train import StepWatchdog, main, run
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import OptimizerConfig, init_state, tree_leaves
from repro_torch.train.train_step import make_train_step
from test_torch_train import numpy_batch


def test_training_loss_descends():
    losses, state = run("smollm-135m-reduced", steps=40, batch=4, seq=64, lr=1e-3, log_every=0,
                        device="cpu")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.05, f"loss did not descend: {first:.3f} -> {last:.3f}"
    assert int(state.step) == 40 and state.residual is None


def test_gradient_compression_still_descends():
    losses, state = run("smollm-135m-reduced", steps=30, batch=4, seq=64, lr=1e-3,
                        compression="int8", log_every=0, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert state.residual is not None  # error feedback carried in the state


def test_cli_trains_on_the_cpu(capsys):
    losses = main(["--arch", "smollm-135m-reduced", "--device", "cpu", "--steps", "3",
                   "--batch", "2", "--seq", "16", "--compression", "bf16"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out


@pytest.mark.parametrize("kw,item", [
    ({"pipeline": 2}, "item 7"), ({"dp": 2}, "item 7"), ({"seq_parallel": True}, "item 7"),
    ({"force_mode": "spatial"}, "item 7"),
])
def test_run_refuses_what_is_not_ported(kw, item):
    with pytest.raises(ValueError, match=item):
        run("smollm-135m-reduced", steps=1, batch=2, seq=16, device="cpu", **kw)


@pytest.mark.parametrize("flags,item", [
    (["--pipeline", "2"], "item 7"), (["--dp", "2"], "item 7"),
    (["--seq-parallel"], "item 7"), (["--force-mode", "temporal"], "item 7"),
])
def test_cli_refuses_what_is_not_ported(flags, item):
    with pytest.raises(ValueError, match=item):
        main(["--arch", "smollm-135m-reduced", "--device", "cpu", "--steps", "1", *flags])


def test_run_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run("smollm-135m-reduced", steps=1, batch=2, seq=16)
    cfg = get_config("smollm-135m-reduced")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, derive_execution_plan(cfg), OptimizerConfig())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m", "qwen3-moe-30b-a3b",
                                  "whisper-small", "bert-base", "vit-base", "rwkv6-1.6b",
                                  "recurrentgemma-9b", "paligemma-3b"])
def test_every_arch_builds_and_takes_a_step(arch):
    """No arch is refused (every kernel on the card has a backward since
    the WKV one): each reduced arch builds its step and takes one on the
    CPU, with finite loss and parameters and the step counted."""
    cfg = get_config(arch + "-reduced")
    plan = derive_execution_plan(cfg, training=True, batch=2, seq_len=16)
    step = make_train_step(cfg, plan, OptimizerConfig(), device="cpu")
    state = init_state(init_params(cfg, plan, torch.float32, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(cfg, batch=2, seq=16).items()}
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and int(state.step) == 1
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


def test_checkpoint_defaults_match_jax():
    """``ckpt_every`` defaults to JAX's 50 in ``run`` and on the CLI."""
    assert inspect.signature(run).parameters["ckpt_every"].default == 50
    import repro.launch.train as jax_train

    assert inspect.signature(jax_train.run).parameters["ckpt_every"].default == 50


@pytest.mark.parametrize("first,second,saved,resumed", [
    (["--steps", "4", "--ckpt-every", "2"], ["--steps", "6", "--ckpt-every", "2", "--resume"],
     [2, 4, 6], 4),
    (["--steps", "3", "--ckpt-every", "2"], ["--steps", "4", "--ckpt-every", "3", "--resume"],
     [2, 3], 2),
    (["--steps", "2"], ["--steps", "3", "--resume"], [], None),
])
def test_cli_checkpoints_and_resumes(tmp_path, capsys, first, second, saved, resumed):
    """``--ckpt-dir`` saves every ``--ckpt-every`` steps (the default, 50,
    saves nothing in a few steps); ``--resume`` restarts from the latest
    one, or from step 0 without one, and returns the steps it ran."""
    from repro_torch.ckpt.checkpoint import latest_step

    base = ["--arch", "smollm-135m-reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    a = main(base + first)
    b = main(base + second)
    steps = [int(p.name.split("_")[1]) for p in tmp_path.iterdir() if p.name.startswith("step_")]
    assert sorted(steps) == saved
    assert latest_step(str(tmp_path)) == (saved[-1] if saved else None)
    out = capsys.readouterr().out
    n_second = int(second[1])
    if resumed is None:
        assert "resumed" not in out and len(b) == n_second
    else:
        assert f"resumed from step {resumed}" in out and len(b) == n_second - resumed
    assert len(a) == int(first[1]) and all(np.isfinite(a + b))


def test_rwkv_trains_on_the_cpu():
    losses, state = run("rwkv6-1.6b-reduced", steps=2, batch=2, seq=16, log_every=0,
                        device="cpu")
    assert all(np.isfinite(losses))
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


def test_watchdog_flags_a_straggler():
    dog = StepWatchdog(budget_factor=3.0, warmup=2)
    flags = [dog.observe(i, dt) for i, dt in enumerate([5.0, 5.0, 1.0, 1.1, 0.9, 4.0, 1.0])]
    assert flags == [False, False, False, False, False, True, False]
    assert dog.flagged == [5]


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_run_resumes_where_it_stopped(tmp_path, compression):
    """``run(resume=True)`` restores the latest state (the error-feedback
    residual too, under compression) and replays the later steps with the
    uninterrupted run's losses."""
    import shutil

    kw = dict(steps=4, batch=2, seq=16, log_every=0, compression=compression, device="cpu")
    whole, end = run("smollm-135m-reduced", ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    shutil.rmtree(tmp_path / "step_4")
    tail, end2 = run("smollm-135m-reduced", ckpt_dir=str(tmp_path), resume=True, **kw)
    assert tail == whole[2:] and int(end2.step) == 4
    assert (end2.residual is None) == (compression == "none")
    for a, b in zip(tree_leaves(end2), tree_leaves(end)):
        assert torch.equal(a, b)
