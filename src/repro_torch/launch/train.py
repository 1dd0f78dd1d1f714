"""Training launcher (the port's ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 4 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m-reduced \\
        --device cpu --steps 6 --batch 4 --seq 32

    # the mesh paths over torch.distributed ranks (torchrun sets the ranks):
    # data parallel, the int8 gradient wire, Megatron-SP, the GPipe pipeline
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch smollm-135m-reduced --device cpu --steps 6 --batch 8 --seq 32 \\
        --dp 2 --compression int8
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch bert-base-reduced --device cpu --steps 6 --batch 8 --seq 32 \\
        --seq-parallel --force-mode spatial
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m-reduced --device cpu --steps 6 --batch 8 --seq 32 \\
        --pipeline 2 --dp 2
    # the pipeline with ZeRO weights: the plan picks them for phi4-mini-3.8b
    # at 18 or more layers on four ranks (each stage's slice sharded over data)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch phi4-mini-3.8b --steps 4 --batch 8 --seq 2048 --pipeline 2
    # Megatron tensor parallelism without SP (column / row shards, MoE's
    # expert or width split; RWKV-6, RG-LRU, an encoder and cross-attention
    # on their local heads) on the mesh (data 1, model N)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-1.7b --steps 4 --batch 4 --seq 2048 --force-mode spatial
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch rwkv6-1.6b --steps 4 --batch 8 --seq 2048 --force-mode spatial

The plan decides, this file executes: ``launch_plan`` maps the flags to
the host mesh over the world's ranks, and ``derive_plan`` on it sets the stage
modes, remat, microbatches, Megatron-SP and the pipeline for the batch on
the card (the H100 entry); ``pod_role="pipeline"`` routes the step through
``dist.pipeline`` (its bubble is printed at start), ``--compression``
rides the ``compressed_psum`` wire on a pure data-parallel mesh and falls
back to the accumulation-dtype quantization with an error-feedback
residual otherwise.  Without layout flags the mesh is (data 1, model N), as
JAX's ``make_host_mesh`` gives it: a SPATIAL model axis that SP does not
take runs Megatron tensor parallelism, and one that ``derive_plan`` folds
into data parallelism (``dp_over_model``: qwen3-1.7b and phi4-mini-3.8b at
B 4 or 8 on the H100 entry) shards the weights and their AdamW moments
over the data-parallel axes (FSDP: gathered where a layer reads them), as
ZeRO's ``zero_weights`` does, under the pipeline too (each stage's slice
over the data axes, gathered at the stage's entry).  Each rank holds its
shards (``Shardings.manual_param_shardings``) and prints the layout and its
state bytes against the replicated figure (and, under tensor parallelism,
which blocks run on their shards and which whole); ZeRO weights under
Megatron-SP, a plan no ``derive_plan`` makes and the reference cannot run,
is refused with that reason (``unexecuted_layout``).  Ranks use NCCL when each
has a card, gloo when they share one or run on the CPU
(``launch.mesh.init_distributed``); rank r computes on
``cuda:(LOCAL_RANK % device_count)``, and only rank 0 prints.  A per-step
watchdog flags stragglers.  ``--ckpt-dir`` saves the train state (the
shards gathered, written by rank 0) every ``--ckpt-every`` steps and
``--resume`` restarts from the latest one onto the run's own layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.plan import derive_plan
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.dist.pipeline import bubble_fraction
from repro_torch.dist.sharding import (NamedSharding, Shardings, gather, place,
                                       tensor_parallel, unexecuted_layout)
from repro_torch.launch.mesh import Mesh, host_mesh_shape, init_distributed, local_device
from repro_torch.models.params import init_params
from repro_torch.models.transformer import check_pipeline_supported
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.optimizer import OptimizerConfig, TrainState, init_state, tree_leaves
from repro_torch.train.train_step import make_train_step, wire_compression_axes

LAUNCH = "torchrun --nproc-per-node {n} -m repro_torch.launch.train ..."


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


def launch_plan(cfg, world: int, *, batch: int, seq: int, pipeline: int = 0, dp: int = 1,
                seq_parallel: bool = False, compression: str = "none",
                force_mode: Optional[str] = None, fuse_qkv: Optional[bool] = None):
    """The launcher's flags on ``world`` ranks as (mesh extents, plan), as
    JAX's launcher maps them: ``derive_plan`` on the host mesh for the H100
    entry.  With ``pipeline > 1`` and ``dp == 1`` the data axis takes
    ``world // pipeline``; raises, with the command to launch, when the
    flags need more ranks than ``world``.  ``fuse_qkv`` overrides the
    plan's fusion (None: the plan's own)."""
    if pipeline > 1 and dp == 1:
        # pipeline composes with DP, not TP: fold the spare ranks into the
        # data axis instead of leaving a >1 model axis
        dp = max(1, world // pipeline)
    need = max(pipeline, 1) * dp
    if need > world:
        raise ValueError(f"--pipeline {pipeline} --dp {dp} need {need} ranks; the world has "
                         f"{world}: launch {LAUNCH.format(n=need)}")
    shape = host_mesh_shape(world, pod=pipeline if pipeline > 1 else 1, data=dp)
    plan = derive_plan(
        cfg, shape, H100_SXM, batch=batch, seq_len=seq, training=True,
        pod_role="pipeline" if pipeline > 1 else "data", seq_parallel=seq_parallel,
        grad_compression=compression, force_mode=force_mode, fuse_qkv=fuse_qkv,
    )
    return shape, plan


def layout_line(sh: Shardings, param_sh, state: TrainState) -> str:
    """Which axes shard the weights (FSDP, gathered where used; the
    pipeline's stage slices over ``pod``; model shards a layer computes
    on), and the train state's bytes a rank against the replicated
    figure."""
    def axes(spec):
        return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))
                if sh.mesh.extent(a) > 1}

    fsdp, stage, model, mine, whole = set(), set(), set(), 0, 0
    for (p, m, v), s in zip(zip(*(tree_leaves(t) for t in (state.params, state.m, state.v))),
                            tree_leaves(param_sh)):
        g = axes(sh.gather_spec(s.spec) or ())
        fsdp |= g
        stage |= (axes(s.spec) - g) & {"pod"}
        model |= axes(s.spec) - g - {"pod"}
        per = p.element_size() + m.element_size() + v.element_size()
        mine += p.numel() * per
        whole += p.numel() * sh.mesh.extent(tuple(axes(s.spec))) * per
    return (f"weights: FSDP over {sorted(fsdp) or 'none'} (gathered where used), "
            + (f"stage slices over {sorted(stage)}, " if stage else "")
            + f"model shards over {sorted(model) or 'none'}; state (weights + AdamW moments) "
            f"{mine / 1e9:.3g} GB a rank, {whole / 1e9:.3g} GB replicated")


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
    n_layers: Optional[int] = None,
    fuse_qkv: Optional[bool] = None,
):
    """Train ``arch`` up to step ``steps`` (AdamW, the synthetic stream)
    over the world's ranks (one process without ``torch.distributed``);
    returns (the losses of the steps this call ran, this rank's final
    ``TrainState``).  ``pipeline`` / ``dp`` / ``seq_parallel`` /
    ``force_mode`` shape the mesh and the plan as JAX's flags do; with
    ``pipeline > 1`` and ``dp == 1`` the data axis takes ``world //
    pipeline``.  With ``ckpt_dir`` the state is saved after every
    ``ckpt_every`` steps; with ``resume`` too, the run restarts from the
    latest saved step (a run resumed at 4 returns steps 4..steps - 1).
    ``device`` is the card unless the caller asks for ``"cpu"`` (plain
    kernels).  ``n_layers`` cuts the arch's depth (its widths stay) and
    ``fuse_qkv`` overrides the plan's fusion: the chip script's reduced-depth
    runs and its one-rank baselines of an SP plan (which keeps q, k and v
    unfused)."""
    dev = resolve_device(device)
    backend = init_distributed(dev.type)
    dev = local_device(dev.type)
    world = torch.distributed.get_world_size() if backend else 1
    rank = torch.distributed.get_rank() if backend else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape, plan = launch_plan(cfg, world, batch=batch, seq=seq, pipeline=pipeline, dp=dp,
                              seq_parallel=seq_parallel, compression=compression,
                              force_mode=force_mode, fuse_qkv=fuse_qkv)
    mesh = Mesh(shape)
    if backend:
        say(f"distributed: {world} ranks, backend {backend}, mesh {shape}"
            + (f" (ranks share {dev}: CUDA tensors cross gloo through host memory)"
               if backend == "gloo" and dev.type == "cuda" else ""))
    reason = unexecuted_layout(plan, cfg)
    if reason:
        raise ValueError(f"mesh {dict(mesh.shape)}: {reason}")
    pipelined = plan.pod_role == "pipeline" and plan.pod_axis > 1
    if pipelined:
        check_pipeline_supported(cfg, plan, batch)
        n_groups = cfg.n_layers // len(cfg.layer_pattern)
        if n_groups % plan.pod_axis:
            raise ValueError(f"{n_groups} stacked layer-groups do not split into "
                             f"{plan.pod_axis} pipeline stages")
        say(f"pipeline: {plan.pod_axis} stages x {plan.microbatches} microbatches"
            f" (bubble {bubble_fraction(plan.microbatches, plan.pod_axis):.1%})")
    if seq_parallel and not plan.seq_parallel_acts:
        say("seq-parallel requested but infeasible for this (arch, mesh); off")
    sh = Shardings(mesh, plan, cfg)
    if tensor_parallel(plan):
        on, whole = sh.tp_blocks()
        say(f"tensor parallelism: model axis {plan.model_axis}, on local heads: "
            f"{', '.join(on) or 'none'}; whole: {', '.join(whole) or 'none'}; "
            f"MoE {plan.moe_mode}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = init_params(cfg, plan, dtype, generator=gen, device=dev)
    param_sh = sh.manual_param_shardings(full)
    params = place(full, param_sh)
    del full
    # the error-feedback residual serves the accumulation-dtype fallback;
    # the wire path quantizes on a shared grid instead
    wire = wire_compression_axes(plan, mesh, batch) is not None
    state = init_state(params, with_residual=compression != "none" and not wire)
    del params
    if backend:
        say(layout_line(sh, param_sh, state))
    opt = OptimizerConfig(peak_lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    # the state is donated to the step, as JAX's launcher donates it
    step_fn = make_train_step(cfg, plan, opt, compression=CompressionConfig(mode=compression),
                              device=dev, mesh=mesh, grad_shardings=param_sh, donate=True)
    state_sh = TrainState(step=NamedSharding(mesh, ()), params=param_sh, m=param_sh, v=param_sh,
                          residual=None if state.residual is None else param_sh)
    sharded = any(any(e is not None for e in s.spec) for s in tree_leaves(param_sh))
    start = 0
    if resume and ckpt_dir:
        k = latest_step(ckpt_dir)
        if k is not None:
            # elastic restore: each rank keeps its shard of the saved leaves
            state = restore_checkpoint(ckpt_dir, k, state, shardings=state_sh)
            start = k
            say(f"resumed from step {k}")
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
            say(f"[watchdog] step {step} took {dt:.2f}s (straggler)")
        if log_every and step % log_every == 0:
            say(f"step {step:5d} loss {loss:.4f} gnorm "
                f"{float(metrics['grad_norm']):.3f} ({dt * 1e3:.0f} ms)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            whole = gather(state, state_sh) if sharded else state
            if rank == 0:
                if pending is not None:
                    pending.join()
                pending = save_checkpoint(ckpt_dir, step + 1, whole, meta={"arch": arch},
                                          async_save=True)
            if backend:
                if pending is not None:
                    pending.join()  # every rank sees the step published before going on
                    pending = None
                torch.distributed.barrier()
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
    ap.add_argument("--pipeline", type=int, default=0,
                    help="pipeline the layer stack over this many pod stages (0/1: off)")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel axis extent of the mesh")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-SP: seq-shard the residual over the model axis")
    ap.add_argument("--force-mode", default=None, choices=["spatial", "temporal"])
    a = ap.parse_args(argv)
    losses, _ = run(
        a.arch, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr, ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every, resume=a.resume, compression=a.compression,
        pipeline=a.pipeline, dp=a.dp, seq_parallel=a.seq_parallel, force_mode=a.force_mode,
        device=a.device,
    )
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
