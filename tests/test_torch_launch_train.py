"""The port's training launcher (``repro_torch.launch.train``): the JAX
end-to-end descent tests (``tests/test_system.py``) through
``run(..., device="cpu")``, the CLI with its checkpoint flags, the mesh
flags on one rank (the multi-rank runs are ``test_torch_dist_launch.py``'s),
a step of every arch, and the step watchdog."""
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


@pytest.mark.parametrize("kw,flags", [
    ({"pipeline": 2}, "--pipeline 2 --dp 1 need 2 ranks"),
    ({"dp": 2}, "--pipeline 0 --dp 2 need 2 ranks"),
    ({"pipeline": 2, "dp": 2}, "--pipeline 2 --dp 2 need 4 ranks"),
])
def test_run_asks_for_the_ranks_it_needs(kw, flags):
    """One process is a world of one rank: a mesh flag that needs more
    raises and says how to launch them."""
    n = flags.split("need ")[1].split()[0]
    with pytest.raises(ValueError, match=f"{flags}.*torchrun --nproc-per-node {n}"):
        run("smollm-135m-reduced", steps=1, batch=4, seq=16, device="cpu", **kw)


@pytest.mark.parametrize("flags", [["--seq-parallel"], ["--force-mode", "temporal"],
                                   ["--force-mode", "spatial"], ["--pipeline", "1"]])
def test_cli_mesh_flags_train_on_one_rank(flags, capsys):
    """On one rank the mesh flags train as JAX's do on one device: SP is
    infeasible and off (said so), a forced mode and a one-stage pipeline
    change no layout."""
    losses = main(["--arch", "smollm-135m-reduced", "--device", "cpu", "--steps", "2",
                   "--batch", "2", "--seq", "16", *flags])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert ("seq-parallel requested but infeasible" in out) == (flags == ["--seq-parallel"])


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


def test_donated_state_steps_to_the_same_bits():
    """``make_train_step(donate=True)`` (the launcher's: JAX donates the
    state to its step) updates the parameters and moments in place, to the
    same bits as the step that builds new ones, and returns the tensors it
    was given."""
    cfg = get_config("smollm-135m-reduced")
    plan = derive_execution_plan(cfg, training=True, batch=2, seq_len=16)
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    batches = [{k: torch.from_numpy(v) for k, v in numpy_batch(cfg, seed=s, batch=2,
                                                                seq=16).items()}
               for s in range(2)]
    out = {}
    for donate in (False, True):
        step = make_train_step(cfg, plan, opt, device="cpu", donate=donate)
        state = init_state(init_params(cfg, plan, torch.float32, device="cpu"))
        first = tree_leaves(state.params)[0]
        for b in batches:
            state, _ = step(state, b)
        assert (tree_leaves(state.params)[0] is first) == donate
        out[donate] = state
    for a, b in zip(tree_leaves(out[True]), tree_leaves(out[False])):
        assert torch.equal(a, b)


def test_a_held_async_save_keeps_its_step(tmp_path, monkeypatch):
    """The launcher donates its state to the step, so the step after a save
    writes the live tensors in place while the save's writer may still be
    running.  With the writer of step 2's checkpoint held back until step 2
    has updated the state, the checkpoint still holds the state a 2-step run
    ends with (both runs are in warm-up, where the learning rate does not
    depend on the run's length)."""
    import threading

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train as launcher

    go, savez, batches = threading.Event(), np.savez, []

    def held(*args, **kw):
        assert go.wait(timeout=60)
        savez(*args, **kw)

    class Counted(launcher.DataIterator):
        def __next__(self):
            batches.append(1)
            if len(batches) == 4:  # step 2 (the third) has updated the state
                go.set()
            return super().__next__()

    kw = dict(batch=2, seq=16, log_every=0, device="cpu")
    _, two = run("smollm-135m-reduced", steps=2, **kw)
    monkeypatch.setattr(ckpt.np, "savez", held)
    monkeypatch.setattr(launcher, "DataIterator", Counted)
    run("smollm-135m-reduced", steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    want = ckpt._flatten(two)
    with np.load(tmp_path / "step_2" / "arrays.npz") as z:
        assert set(z.files) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)
