"""The training cells: ``repro_torch``'s train step over batches drawn from
the seed, timed on the host's clock.

The step is built as ``repro_torch.launch.train.run`` builds it on one card:
``launch_plan`` (``derive_plan`` on the H100 entry for the job's batch and
length), the mesh of one rank with its shardings, ``init_state``, and
``make_train_step(donate=True)``, on the weights the benchmark drew.  Set-up
drives that one step function through the job's first ``check_steps``
steps with the window's own feed, reading what the comparison needs: each
step's loss, the first gradient as AdamW received it (its first moment
after one step, over 1 - b1) and the parameters' change after the last.
The window then runs the next steps back to back, reading each loss as the
launcher does."""
from __future__ import annotations

import time

import torch

from bench.portbench import weights

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def slice_norms(leaves: dict) -> dict:
    """{(path, layer): f32 norm} of every leaf, a stacked leaf (under
    ``blocks``) a layer at a time, so a fault in one layer is not diluted
    by the others."""
    out = {}
    for path, x in leaves.items():
        x = x.detach()
        if path[0] == "blocks":
            n = torch.linalg.vector_norm(x.float().reshape(x.shape[0], -1), dim=1)
            for i, v in enumerate(n.tolist()):
                out[(path, i)] = v
        else:
            out[(path, None)] = float(torch.linalg.vector_norm(x.float()))
    return out


def build_step(arch_cfg, config: dict, traffic: dict, seed: int, device):
    """(step function, train state, layout, optimizer config) as the
    launcher builds them at 1 x 1, on the benchmark's weights."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import launch_plan
    from repro_torch.dist.sharding import Shardings, place
    from repro_torch.models.params import init_params
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.train_step import make_train_step

    shape, plan = launch_plan(arch_cfg, 1, batch=int(traffic["batch"]),
                              seq=int(traffic["seq_len"]))
    mesh = Mesh(shape)
    sh = Shardings(mesh, plan, arch_cfg)
    dtype = _DTYPES[config["dtype"]]
    layout = init_params(arch_cfg, plan, dtype, device="meta")
    full = weights.rebuild(layout, weights.draw(layout, seed, arch_cfg.norm, device))
    param_sh = sh.manual_param_shardings(full)
    state = init_state(place(full, param_sh))
    del full
    opt = OptimizerConfig(**traffic["optimizer"])
    step_fn = make_train_step(arch_cfg, plan, opt, compression=CompressionConfig(mode="none"),
                              device=device, mesh=mesh, grad_shardings=param_sh, donate=True)
    return step_fn, state, layout, opt


def check_steps(step_fn, state, feed, n: int, b1: float, spans):
    """Steps 1..n through ``step_fn`` on ``feed``'s batches: (state, the
    program's readings)."""
    params0 = {p: x.clone() for p, x in weights.leaves_with_path(state.params)}
    losses, grad = [], None
    for s in range(1, n + 1):
        with spans("bench.train_step"):
            state, met = step_fn(state, feed.batch(s))
            losses.append(float(met["loss"]))
        if s == 1:
            grad = {k: v / (1.0 - b1) for k, v in
                    slice_norms(dict(weights.leaves_with_path(state.m))).items()}
    delta = {p: x.float() - params0[p].float() for p, x in weights.leaves_with_path(state.params)}
    change = slice_norms(delta)
    del params0, delta
    return state, {"losses": losses, "grad": grad, "change": change}


def run_window(step_fn, state, feed, first: int, seconds: float, window, spans):
    """Steps ``first``, ``first + 1``, ... back to back until ``seconds``
    have passed; (state, window record)."""
    steps, losses = [], []
    s = first
    with window() as w:
        while True:
            with spans("bench.train_step"):
                state, met = step_fn(state, feed.batch(s))
                loss = float(met["loss"])  # waits for the step, as the launcher does
            t = time.perf_counter()
            steps.append(t)
            losses.append(loss)
            s += 1
            if t >= w.t0 + seconds:
                break
        w.close(t)
    return state, {"t0": w.t0, "t1": w.t1, "step_ends": steps, "losses": losses,
                   "tokens_per_step": feed.tokens_per_step}
