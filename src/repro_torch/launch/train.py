"""Training launcher (the port's ``repro/launch/train.py``, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 4 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m-reduced \\
        --device cpu --steps 6 --batch 4 --seq 32

The plan decides, this file executes: ``derive_execution_plan(training=
True)`` sets remat and microbatches for the batch on the card (the H100
entry), ``--compression`` quantizes the gradients at the accumulation
boundary with an error-feedback residual in the train state.  A per-step
watchdog flags stragglers.  On the card the forward and backward run
through the flash-attention, RMSNorm and WKV kernels (every arch trains
there).  ``--ckpt-dir`` saves the train state every ``--ckpt-every`` steps
(on a background thread; ``repro_torch.ckpt``) and ``--resume`` restarts
from the latest one, the data stream at the same step.

Not ported yet, and refused with the ROADMAP item that lists them: the
mesh flags (``--pipeline``, ``--dp``, ``--seq-parallel``, ``--force-mode``:
queue 1, item 7).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_execution_plan
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.models.params import init_params
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import OptimizerConfig, init_state
from repro_torch.train.train_step import make_train_step

MESH_ITEM = "meshes (pipeline, data and sequence parallelism) are ROADMAP queue 1, item 7"


class StepWatchdog:
    """Flags steps that exceed a wall-clock budget (straggler detection)."""

    def __init__(self, budget_factor: float = 3.0, warmup: int = 3):
        self.budget_factor = budget_factor
        self.warmup = warmup
        self.times: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        median = sorted(self.times[self.warmup:])[len(self.times[self.warmup:]) // 2]
        if dt > self.budget_factor * max(median, 1e-6):
            self.flagged.append(step)
            return True
        return False


def refuse_unported(*, pipeline=0, dp=1, seq_parallel=False, force_mode=None) -> None:
    """Raise ``ValueError`` naming the ROADMAP item of any option the port
    does not run yet."""
    if pipeline > 1 or dp > 1 or seq_parallel or force_mode is not None:
        raise ValueError(f"--pipeline / --dp / --seq-parallel / --force-mode: not ported "
                         f"({MESH_ITEM})")


def run(
    arch: str,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    resume: bool = False,
    compression: str = "none",
    pipeline: int = 0,
    dp: int = 1,
    seq_parallel: bool = False,
    force_mode: Optional[str] = None,
    seed: int = 0,
    dtype=torch.float32,
    log_every: int = 10,
    device="cuda",
):
    """Train ``arch`` up to step ``steps`` (AdamW, the synthetic stream);
    returns (the losses of the steps this call ran, the final
    ``TrainState``).  With ``ckpt_dir`` the state is saved after every
    ``ckpt_every`` steps; with ``resume`` too, the run restarts from the
    latest saved step (a run resumed at 4 returns steps 4..steps - 1).
    ``device`` is the card unless the caller asks for ``"cpu"`` (plain
    kernels)."""
    refuse_unported(pipeline=pipeline, dp=dp, seq_parallel=seq_parallel, force_mode=force_mode)
    dev = resolve_device(device)
    cfg = get_config(arch)
    plan = derive_execution_plan(cfg, training=True, batch=batch, seq_len=seq, hw=H100_SXM,
                                 grad_compression=compression)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, plan, dtype, generator=gen, device=dev)
    # the error-feedback residual serves the accumulation-boundary compression
    state = init_state(params, with_residual=compression != "none")
    del params
    opt = OptimizerConfig(peak_lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    step_fn = make_train_step(cfg, plan, opt, compression=CompressionConfig(mode=compression),
                              device=dev)
    start = 0
    if resume and ckpt_dir:
        k = latest_step(ckpt_dir)
        if k is not None:
            state = restore_checkpoint(ckpt_dir, k, state)
            start = k
            print(f"resumed from step {k}")
    data = DataIterator(DataConfig(cfg.vocab_size, seq, batch, seed=seed), start_step=start,
                        device=dev)
    dog = StepWatchdog()
    losses = []
    pending = None
    for step in range(start, steps):
        b = next(data)
        t0 = time.time()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        losses.append(loss)
        if dog.observe(step, dt):
            print(f"[watchdog] step {step} took {dt:.2f}s (straggler)")
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm "
                  f"{float(metrics['grad_norm']):.3f} ({dt * 1e3:.0f} ms)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(ckpt_dir, step + 1, state, meta={"arch": arch},
                                      async_save=True)
    if pending is not None:
        pending.join()
    return losses, state


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    # JAX's flags the port refuses until the ROADMAP item lands
    ap.add_argument("--pipeline", type=int, default=0, help=f"refused: {MESH_ITEM}")
    ap.add_argument("--dp", type=int, default=1, help=f"refused: {MESH_ITEM}")
    ap.add_argument("--seq-parallel", action="store_true", help=f"refused: {MESH_ITEM}")
    ap.add_argument("--force-mode", default=None, choices=["spatial", "temporal"],
                    help=f"refused: {MESH_ITEM}")
    a = ap.parse_args(argv)
    losses, _ = run(
        a.arch, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr, ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every, resume=a.resume, compression=a.compression,
        pipeline=a.pipeline, dp=a.dp, seq_parallel=a.seq_parallel, force_mode=a.force_mode,
        device=a.device,
    )
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
