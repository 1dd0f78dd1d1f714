"""The port's training launcher (``repro_torch.launch.train``): the JAX
end-to-end descent tests (``tests/test_system.py``) through
``run(..., device="cpu")``, the CLI, the flags the port refuses with their
ROADMAP items, the card-only refusal of the arch whose kernels have no
backward yet, and the step watchdog."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import derive_execution_plan
from repro_torch.launch.train import StepWatchdog, main, run
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.train_step import check_trainable, make_train_step


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
    ({"ckpt_dir": "/nonexistent"}, "item 6"), ({"ckpt_every": 5}, "item 6"),
    ({"resume": True}, "item 6"),
    ({"pipeline": 2}, "item 7"), ({"dp": 2}, "item 7"), ({"seq_parallel": True}, "item 7"),
    ({"force_mode": "spatial"}, "item 7"),
])
def test_run_refuses_what_is_not_ported(kw, item):
    with pytest.raises(ValueError, match=item):
        run("smollm-135m-reduced", steps=1, batch=2, seq=16, device="cpu", **kw)


@pytest.mark.parametrize("flags,item", [
    (["--ckpt-dir", "/nonexistent"], "item 6"), (["--ckpt-every", "5"], "item 6"),
    (["--resume"], "item 6"), (["--pipeline", "2"], "item 7"), (["--dp", "2"], "item 7"),
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


@pytest.mark.parametrize("arch,trainable", [
    ("qwen3-1.7b", True), ("smollm-135m", True), ("qwen3-moe-30b-a3b", True),
    ("whisper-small", True), ("bert-base", True), ("vit-base", True),
    ("rwkv6-1.6b", False), ("recurrentgemma-9b", True), ("paligemma-3b", True),
])
def test_card_refuses_archs_without_backward_kernels(arch, trainable):
    """WKV has no backward kernel: on the card rwkv6-1.6b is refused with
    the ROADMAP item; flash's backward takes d_head 256, so
    recurrentgemma-9b and paligemma-3b pass; on the CPU (plain versions)
    every arch trains."""
    cfg = get_config(arch)
    if trainable:
        check_trainable(cfg)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
            check_trainable(cfg)
    reduced = get_config(arch + "-reduced")
    step = make_train_step(reduced, derive_execution_plan(reduced, training=True),
                           OptimizerConfig(), device="cpu")
    assert callable(step)


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
