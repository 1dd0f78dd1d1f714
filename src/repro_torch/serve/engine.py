"""Serving (the port's ``repro/serve/engine.py``): the eager whole-batch
path and the continuous-batching engine over the paged KV cache.

* ``make_prefill_step`` / ``make_decode_step`` / ``greedy_generate``: one
  prefill of the whole batch (flash-attention or WKV kernel, harvesting the
  decode cache), then lockstep greedy decode over a dense cache.  Archs the
  continuous engine cannot serve (RWKV-6) serve through it, and it is the
  oracle the engine's tokens are held to.
* ``make_mixed_step``, ``make_rolled_step`` and ``ServingEngine``: every
  slot owns ``mixed_slab_width`` query rows of a shared (B, W) token slab:
  a decode slot uses 1 (gamma + 1 when it speculates), a prefill slot up to
  W (its next prompt chunk), idle rows are dead and write to the trash
  block.  Attention goes through the CUDA paged-attention kernel, which
  reads the block table directly, and the norms through the RMSNorm kernel;
  ``fused=False`` (the gather path, with plain norms) is the oracle and the
  degradation ladder's bottom rung.  Scheduling lives host-side in
  ``serve/scheduler.py``; speculative drafters in ``serve/speculative.py``;
  the chaos injector in ``serve/faults.py``; metrics, tracing and the drift
  meter in ``repro_torch.obs``.

Sharded serving (``ServingEngine(shardings=)``, as JAX's engine takes
them): every rank of the mesh runs the same host scheduler on its
tensor-parallel shards (``models.transformer``'s TP layer: this rank's
heads, pools of this rank's KV heads, ``Shardings.attention_sharded``;
the embedding and head cut over ``vocab``: a vocab-parallel lookup, and
each rank's logit columns gathered, so every rank reaches the same argmax
(``check_replicas`` compares the ranks' tokens once a step, for debug runs
and the tests).  JAX's engine
runs the gather path on a multi-device mesh because GSPMD cannot partition
its Pallas call; the port's paged-attention kernel runs per rank on that
rank's KV-head pages, so ``fused`` keeps the plan's default there, and
``fused=False`` (the gather path) gives the same tokens (ROADMAP,
deliberate divergences).

PyTorch runs eagerly, so there is no compile to count: the JAX engine's
``trace_counts`` has no counterpart.  ``dispatch_counts`` takes its place in
the step-time calibration: the first dispatch of each step function (the
mixed step, the rolled loop, the gather rung) pays one-off costs (kernel
builds, library set-up) where JAX's traces, and is left out of
``sched.step_ms`` and of the drift meter as JAX leaves out a tracing
dispatch.  The pools are updated in place where the JAX steps took them
donated.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.hardware import DEFAULT_HARDWARE, HardwareSpec
from repro_torch.core.plan import ExecutionPlan, ServePlan, serve_feasible
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import kernel as paged_attention_kernel
from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel
from repro_torch.models.cache import (
    cache_from_prefill,
    init_paged_cache,
    live_blocks,
    paged_copy_block,
)
from repro_torch.models.transformer import forward, logits_fn
from repro_torch.obs import Observability, step_time_model
from repro_torch.serve.faults import (
    LADDER,
    SALTS,
    FaultInjector,
    LadderExhausted,
    StallError,
    TransientDeviceError,
)
from repro_torch.serve.scheduler import DONE, WAITING, Request, Scheduler


def _serving_gathers(cfg: ArchConfig, plan: ExecutionPlan, mesh, shardings):
    """FSDP's gathers of a serving step on a mesh (``dist.collectives.
    FSDPGathers``, no batch axes to sum over), or None where no leaf of
    ``shardings`` is cut over the data-parallel axes."""
    if mesh is None or shardings is None:
        return None
    from repro_torch.dist.collectives import FSDPGathers
    from repro_torch.dist.sharding import Shardings
    from repro_torch.train.optimizer import tree_leaves

    specs = Shardings(mesh, plan, cfg).gather_specs(shardings)
    return FSDPGathers(mesh, specs) if any(s is not None for s in tree_leaves(specs)) else None


def make_prefill_step(cfg: ArchConfig, plan: ExecutionPlan, *, fused: bool = True,
                      mesh=None, shardings=None):
    """``prefill(params, batch) -> (logits (B, 1, V) of the last position,
    prefill cache)``: one pass over the whole prompt (``batch["tokens"]``,
    with any ``prefix_embeds`` and ``enc_embeds``) with
    ``collect_cache=True``.  ``fused=False`` runs the kernels' plain
    versions on any device (the oracle).

    With a ``mesh`` (JAX's ``shard``): ``params`` are this rank's shards
    (``shardings``, the parameters' manual shardings) and ``batch`` its
    rows; the pass runs ``forward(mesh=)`` (tensor parallelism where the
    plan has it: the harvest holds this rank's heads), FSDP leaves are
    gathered where read, and logits cut over the vocabulary are gathered."""
    gathers = _serving_gathers(cfg, plan, mesh, shardings)

    @torch.no_grad()
    def prefill_step(params, batch):
        if gathers is not None:
            params = gathers.top(params)
        x, pc = forward(params, batch, cfg=cfg, plan=plan, collect_cache=True, fused=fused,
                        mesh=mesh, gathers=gathers)
        return logits_fn(params, x[:, -1:], cfg, mesh=mesh), pc

    return prefill_step


def make_decode_step(cfg: ArchConfig, plan: ExecutionPlan, *, fused: bool = True,
                     mesh=None, shardings=None):
    """``decode(params, token (B, 1), cache) -> (logits (B, 1, V), cache)``:
    one token over the dense cache, which is updated in place (it carries
    an encoder-decoder's memory: a step takes tokens only, as in JAX).
    ``fused=False`` runs the kernels' plain versions on any device.  With a
    ``mesh``, as ``make_prefill_step``: this rank's shards, rows and cache
    (``cache.init_cache(shardings=)``)."""
    gathers = _serving_gathers(cfg, plan, mesh, shardings)

    @torch.no_grad()
    def decode_step(params, token, cache):
        if gathers is not None:
            params = gathers.top(params)
        x, cache = forward(params, {"tokens": token}, cfg=cfg, plan=plan, cache=cache,
                           fused=fused, mesh=mesh, gathers=gathers)
        return logits_fn(params, x, cfg, mesh=mesh), cache

    return decode_step


def greedy_generate(
    params: dict,
    cfg: ArchConfig,
    plan: ExecutionPlan,
    batch: dict,
    n_steps: int,
    cache_len: int,
    cache_dtype=torch.bfloat16,
    *,
    device="cuda",
    fused: bool = True,
) -> torch.Tensor:
    """Prefill ``batch`` (``"tokens"`` (B, S), and an arch's
    ``"prefix_embeds"`` (B, P, d) and ``"enc_embeds"`` (B, Se, d), cast to
    the compute dtype by ``forward``), then ``n_steps - 1`` lockstep greedy
    decode steps over a dense cache of ``cache_len`` positions in
    ``cache_dtype``.  Returns the (B, n_steps) int32 greedy tokens on
    ``device`` (the card by default; raises without one unless ``"cpu"``),
    where the parameters and the batch are moved first.  ``fused=False``
    runs every kernel's plain version, in the prefill and in each decode
    step.  A classifier (``cfg.n_classes``: ViT) has no token to generate
    and raises (in JAX it fails with an ``IndexError``)."""
    if cfg.n_classes:
        raise ValueError(
            f"{cfg.name} is a classifier: logits_fn gives (B, {cfg.n_classes}) class logits, "
            "not tokens, so it cannot be served by greedy_generate; call forward and "
            "logits_fn instead")
    dev = resolve_device(device)
    params = _tree_to(params, dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    logits, pc = make_prefill_step(cfg, plan, fused=fused)(params, batch)
    cache = cache_from_prefill(cfg, plan, pc, cache_len, dtype=cache_dtype)
    del pc
    decode = make_decode_step(cfg, plan, fused=fused)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    for _ in range(n_steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32)


def _page_state(serve: ServePlan, fused: bool, table: np.ndarray, device) -> dict:
    """Static knobs + this dispatch's table (uploaded) and, for the gather
    path, its live high-water mark (read on the host, no device sync)."""
    return {
        "block_size": serve.block_size,
        "fused": bool(fused),
        "table": torch.from_numpy(np.ascontiguousarray(table, np.int32)).to(device),
        "max_blocks": live_blocks(table),
    }


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def make_mixed_step(cfg: ArchConfig, plan: ExecutionPlan, serve: ServePlan, *, fused: bool,
                    spec_width: int = 1, mesh=None):
    """The unified mixed prefill/decode step (JAX engine.py:112-179).

    ``step(params, pools, tokens (B, W), tables (B, MB), lens (B,),
    kinds (B,), poison (B,) or None)`` takes the scheduler's numpy arrays and
    returns device tensors ``(tok (B,), vtok (B, spec_width), finite (B,))``:
    ``tok[b]`` is the greedy token at slot b's last live row; ``vtok`` the
    greedy argmax at each of its first ``spec_width`` rows, the verification
    targets of speculative decoding (row i scores the token that should
    follow the slot's i-th slab token; with ``spec_width == 1`` it is
    ``tok[:, None]`` and no extra logits are computed); ``finite[b]`` false
    when any logit the slot sampled from is non-finite (the host quarantines
    such slots).  ``poison`` is the chaos harness's additive per-slot logit
    offset (NaN injection), added before the argmax and the finiteness
    check; ``None`` or all zeros adds nothing.

    Shared by :class:`ServingEngine` and the model drafter
    (``serve/speculative.ModelDraft``).  ``mesh``: the parameters and pools
    are this rank's tensor-parallel shards (``forward``'s ``mesh``)."""

    @torch.no_grad()
    def step(params, pools, tokens, tables, lens, kinds, poison=None):
        dev = params["embed"].device
        kinds_d = _upload(kinds, dev)
        page_state = {**_page_state(serve, fused, tables, dev), "q_lens": kinds_d}
        x, _ = forward(
            params, {"tokens": _upload(tokens, dev)}, cfg=cfg, plan=plan,
            cache={"layers": pools["layers"], "t": _upload(lens, dev)},
            page_state=page_state, fused=fused, mesh=mesh,
        )
        # poison is data the host holds: skip the add when it is all zero
        pz = None
        if poison is not None and np.any(poison != 0):
            pz = torch.from_numpy(np.ascontiguousarray(poison, np.float32)).to(dev)
        # per-slot row kinds-1: row 0 for decode slots, the final prompt
        # token on a last prefill chunk
        idx = torch.clamp(kinds_d.long() - 1, min=0)
        xl = x[torch.arange(x.shape[0], device=dev), idx]
        logits = logits_fn(params, xl, cfg, mesh).float()
        if pz is not None:
            logits += pz[:, None]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        # a NaN/Inf anywhere in the sampled logits poisons the sum
        finite = torch.isfinite(torch.sum(logits, dim=-1))
        if spec_width > 1:
            # the target's own greedy choice after every leading row (drafted
            # rows ride rows 1..gamma): B x spec_width x V f32 logits.  The
            # rows are copied contiguous first: matmul cannot fold a strided
            # (B, spec_width, d) view into one product and falls back to a
            # batched one that reads the vocab matrix once a slot
            B, d = x.shape[0], x.shape[-1]
            rows = x[:, :spec_width].reshape(B * spec_width, d)
            vlog = logits_fn(params, rows, cfg, mesh).float().view(B, spec_width, -1)
            if pz is not None:
                vlog += pz[:, None, None]
            vtok = torch.argmax(vlog, dim=-1).to(torch.int32)
            finite &= torch.isfinite(torch.sum(vlog, dim=(-2, -1)))
        else:
            vtok = tok[:, None]
        return tok, vtok, finite

    return step


def make_rolled_step(cfg: ArchConfig, plan: ExecutionPlan, serve: ServePlan, *, fused: bool,
                     mesh=None):
    """The rolled decode loop: up to K decode iterations for one host
    dispatch, without reading anything back between them.

    ``rolled(params, pools, tok (B,), tables (B, MB), lens (B,),
    steps_left (B,), k_steps, poison (B,) or None)`` runs each iteration as
    a width-1 slab: forward, greedy argmax, repack the token, advance the
    per-slot length.  ``steps_left[b]`` is slot b's own budget (0 = idle); a
    slot whose budget runs out goes dead (writes to the trash block, token
    frozen).  A slot whose logits turn non-finite stops for good (the
    sticky dead flag): its length stays at the last good position and its
    remaining output columns stay -1.  ``poison[b]`` is the chaos harness's
    iteration at which slot b's logits turn NaN (-1 or ``None``: never), as
    in JAX engine.py:231.  The JAX loop exits once no slot is live; here the
    host knows the budgets, so it runs ``min(k_steps, max(steps_left))``
    iterations, and an iteration with no live slot changes nothing.

    Returns device tensors ``(out (B, K), lens (B,))`` with
    ``out[b, :steps_left[b]]`` slot b's tokens (-1 past the end).  ``mesh``
    as ``make_mixed_step``'s."""
    K = int(serve.rolled_steps)

    @torch.no_grad()
    def rolled(params, pools, tok, tables, lens, steps_left, k_steps, poison=None):
        dev = params["embed"].device
        page_state = _page_state(serve, fused, tables, dev)
        n_iter = min(int(k_steps), int(np.max(steps_left)))
        tok, lens = _upload(tok, dev), _upload(lens, dev)
        steps_d = _upload(steps_left, dev)
        B = tok.shape[0]
        dead = torch.zeros(B, dtype=torch.bool, device=dev)
        out = torch.full((B, K), -1, dtype=torch.int32, device=dev)
        for i in range(n_iter):
            live = (steps_d > i) & ~dead
            x, _ = forward(
                params, {"tokens": tok[:, None]}, cfg=cfg, plan=plan,
                cache={"layers": pools["layers"], "t": lens},
                page_state={**page_state, "q_lens": live.to(torch.int32)}, fused=fused,
                mesh=mesh,
            )
            logits = logits_fn(params, x[:, -1], cfg, mesh).float()
            if poison is not None and np.any(poison == i):
                pz = np.where(np.asarray(poison) == i, np.float32(np.nan), np.float32(0))
                logits += torch.from_numpy(pz).to(dev)[:, None]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            ok = torch.isfinite(torch.sum(logits, dim=-1))
            good = live & ok
            tok = torch.where(good, nxt, tok)
            lens = lens + good.to(torch.int32)
            out[:, i] = torch.where(good, nxt, -1)
            dead |= live & ~ok
        return out, lens

    return rolled


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return None if tree is None else tree.to(device)


def _by_tenant(finished: list) -> dict:
    groups: dict = {}
    for r in finished:
        groups.setdefault(r.tenant, []).append(r)
    return groups


def _dispositions(rs: list) -> dict:
    """Counts of the retired-without-completing statuses among ``rs``."""
    out = {"shed": 0, "expired": 0, "cancelled": 0, "poisoned": 0}
    for r in rs:
        if r.status in out:
            out[r.status] += 1
    return out


def _percentiles(xs: list) -> Optional[dict]:
    if not xs:
        return None
    arr = np.asarray(xs, np.float64)
    return {
        "n": int(arr.size),
        "mean": float(arr.mean()),
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "p99": float(np.percentile(arr, 99)),
    }


class ServingEngine:
    """Continuous-batching serving over the paged KV cache.

    Each ``step()`` admits, grows and packs the slab on the host, then runs
    one unified mixed step (or, when the plan allows K > 1, the ladder sits
    on its top rung and the scheduler's event horizon says no host event
    falls due, one rolled span of K decode iterations).  Greedy outputs
    match the JAX engine's token for token on the same weights;
    ``fused=False`` swaps the CUDA kernels for the gather path and the plain
    norms, with the same tokens.

    ``draft`` (a ``serve/speculative`` draft source) with ``serve.spec_len``
    > 0 turns decode slots speculative: each running slot's drafted
    continuation rides its slab row as gamma+1 rows, the step scores every
    row, and the host keeps the longest draft prefix that matches the
    target's own greedy argmax: the tokens are those of the plain engine,
    only the speed changes.  The rolled loop is off under speculation.

    ``injector`` (``serve/faults.FaultInjector``) drives the chaos harness:
    transient dispatch faults (retried, then the ladder steps down rolled ->
    mixed -> gather and climbs back after ``ladder_recovery`` healthy
    dispatches), NaN poison (quarantine and replay), pool pressure and step
    time spikes.  ``obs`` is the observability bundle (metrics and the drift
    meter on, tracing when the caller enables it); ``hw`` the hardware entry
    the drift meter prices dispatches on.

    ``device`` defaults to ``"cuda"`` and raises when there is no card; the
    parameters are moved there if they are not already.

    ``shardings`` (``dist.sharding.Shardings`` on a mesh of this process
    group's ranks): ``params`` are this rank's shards
    (``manual_param_shardings``, ``dist.sharding.place``), the pools hold
    this rank's KV heads, and every step runs the tensor-parallel layer.
    The kernel path stays the default (JAX falls back to the gather path on
    a multi-device mesh).  ``check_replicas``: once a step, all-gather the
    sampled tokens over ``model`` and raise unless every rank has the
    same (a debug check, off on the main path)."""

    def __init__(
        self,
        params: dict,
        cfg: ArchConfig,
        plan: ExecutionPlan,
        serve: ServePlan,
        *,
        fused: Optional[bool] = None,
        draft=None,
        injector: Optional[FaultInjector] = None,
        obs: Optional[Observability] = None,
        hw: Optional[HardwareSpec] = None,
        device="cuda",
        shardings=None,
        check_replicas: bool = False,
    ):
        ok, reason = serve_feasible(cfg)
        if not ok:
            raise ValueError(f"{cfg.name} cannot serve continuously: {reason}")
        self.device = resolve_device(device)
        self.cfg, self.plan, self.serve = cfg, plan, serve
        self.obs = obs if obs is not None else Observability()
        self.hw = hw if hw is not None else DEFAULT_HARDWARE
        self.shardings = shardings
        self.mesh = None if shardings is None else shardings.mesh
        self.check_replicas = bool(check_replicas)
        self.params = _tree_to(params, self.device)
        self.pools = init_paged_cache(cfg, plan, serve, self.device, shardings=shardings)
        self.sched = Scheduler(serve, obs=self.obs)
        self.injector = injector
        if injector is not None:
            injector.bind(self.obs)
        self.fused = serve.fused_attention if fused is None else bool(fused)
        if self.fused and self.device.type == "cuda":
            # build (or load) the kernels now, so no step's time includes nvcc
            kernels = [paged_attention_kernel] + (
                [rmsnorm_kernel] if cfg.norm == "rmsnorm" else [])
            _build.build_all([k.SOURCE for k in kernels])
            for k in kernels:
                k.library()
        # planner drift meter: the roofline constants of this (arch, plan,
        # device, TP degree) frozen once, so pricing a dispatch is O(1); on a
        # mesh it prices the kernel path where JAX's prices the gather path
        self.mesh_model = 1 if self.mesh is None else self.mesh.extent("model")
        self._cost = step_time_model(cfg, serve, self.hw, mesh_model=self.mesh_model,
                                     fused=self.fused)
        self.draft = draft
        if draft is not None:
            draft.bind_obs(self.obs)
        self.spec_len = serve.spec_len if draft is not None else 0
        if self.spec_len >= serve.mixed_slab_width and serve.mixed_slab_width > 0:
            self.spec_len = serve.mixed_slab_width - 1  # the plan clamps this already
        # verify rows follow the engine's draft-gated depth, not the plan's
        self._spec_width = self.spec_len + 1 if self.spec_len > 0 else 1
        self._step = make_mixed_step(cfg, plan, serve, fused=self.fused,
                                     spec_width=self._spec_width, mesh=self.mesh)
        # the rolled loop is off under speculation: draft accept/rollback is
        # a host event every iteration
        self.rolled_cap = int(serve.rolled_steps) if self.spec_len == 0 else 1
        self._rolled = (
            make_rolled_step(cfg, plan, serve, fused=self.fused, mesh=self.mesh)
            if self.rolled_cap > 1
            else None
        )
        self._gather = None  # rung 2, built on first use
        self.iteration = 0
        # dispatches of each step function: the first of each is left out of
        # the step-time EMA and the drift meter (the JAX engine's tracing
        # dispatch gate)
        self.dispatch_counts = {"step": 0}
        if self._rolled is not None:
            self.dispatch_counts["rolled_step"] = 0
        self.stats = {
            "steps": 0, "dispatches": 0, "prefill_tokens": 0, "generated_tokens": 0,
            "draft_rows": 0, "accepted_drafts": 0, "spec_slots": 0, "spec_generated": 0,
            "fork_copies": 0, "occupancy_sum": 0.0, "rolled_dispatches": 0,
            "rolled_steps": 0, "device_s": 0.0, "retries": 0, "transient_faults": 0,
            "rung_escalations": 0, "rung_recoveries": 0, "quarantines": 0, "poisoned": 0,
            "expired": 0, "shed": 0, "cancelled": 0, "injected_nans": 0, "slots_idle": 0,
            "slots_decode": 0, "slots_prefill": 0,
        }
        # degradation ladder: 0 rolled spans, 1 the K=1 mixed step, 2 the
        # gather step; an engine without a rolled loop lives on rung 1
        self._rung_floor = 0 if self._rolled is not None else 1
        self.rung = self._rung_floor
        self._healthy = 0
        self._last_fault: Optional[dict] = None
        self.obs.m_rung.set(self.rung)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        """Queue a request, validating its construction fields up front."""
        if not req.prompt:
            raise ValueError(f"request {req.rid}: prompt must not be empty")
        if req.max_new_tokens <= 0:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be positive, got {req.max_new_tokens}"
            )
        if len(req.prompt) >= self.serve.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)}"
                f" >= max_seq_len {self.serve.max_seq_len}"
            )
        vocab = self.cfg.vocab_size
        for i, t in enumerate(req.prompt):
            if not 0 <= int(t) < vocab:
                raise ValueError(
                    f"request {req.rid}: prompt token id {int(t)} at position {i}"
                    f" outside vocab range [0, {vocab})"
                )
        if req.deadline_ms is None:
            req.deadline_ms = self.serve.deadline_ms
        self.sched.submit(req)

    def cancel(self, rid: str) -> bool:
        """Cancel a queued or in-flight request by id, releasing its blocks
        and prefix references; False when no live request matches."""
        for r in list(self.sched.waiting) + [s for s in self.sched.slots if s is not None]:
            if r.rid == rid:
                self.sched.cancel(r, status="cancelled")
                self.stats["cancelled"] += 1
                return True
        return False

    def reset_stats(self) -> None:
        """Zero the counters, the finished-request records and the iteration
        clock (request arrivals are absolute iterations); pools and built
        kernels are left alone."""
        for k in self.stats:
            self.stats[k] = 0.0 if isinstance(self.stats[k], float) else 0
        self.stats.pop("wall_s", None)
        self.sched.finished = []
        self.sched.shed = []
        self.iteration = 0

    def _same_on_every_rank(self, *tokens: torch.Tensor) -> None:
        """The debug check of ``check_replicas``: the ranks of ``model``
        sampled the same tokens (one all-gather a step)."""
        if not self.check_replicas or self.mesh_model == 1:
            return
        from repro_torch.dist.collectives import all_gather

        mine = torch.cat([t.reshape(-1).to(torch.int32) for t in tokens])
        every = all_gather(mine[None], "model", self.mesh).cpu()
        if not bool((every == every[:1]).all()):
            raise RuntimeError(f"iteration {self.iteration}: the ranks of the model axis "
                               "sampled different tokens")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _propose_drafts(self) -> dict:
        """{rid: [draft tokens]} for the running slots: never more than the
        plan's gamma, never past the slab width, never more tokens than the
        request may still emit, none while an SLO'd prefill is at risk."""
        cap = min(self.spec_len, self.serve.mixed_slab_width - 1)
        if self.draft is None or cap <= 0 or self.sched._slo_pressure():
            return {}
        asks = []
        for req in self.sched.running():
            n = min(cap, req.max_new_tokens - len(req.out) - 1)
            if n > 0:
                asks.append((req.rid, req.prompt + req.out, n))
        if not asks:
            return {}
        props = self.draft.propose(asks)
        return {rid: list(d) for rid, d in props.items() if d}

    # ------------------------------------------------- degradation ladder
    def _gather_step(self):
        """Rung 2: the same mixed step without the kernels (gathered pages,
        plain norms), built on first use and counted as ``fallback_step``."""
        if self._gather is None:
            self.dispatch_counts.setdefault("fallback_step", 0)
            self._gather = make_mixed_step(self.cfg, self.plan, self.serve, fused=False,
                                           spec_width=self._spec_width, mesh=self.mesh)
        return self._gather

    def _escalate(self) -> bool:
        """Step one rung down the ladder; False when already at the bottom."""
        if self.rung >= len(LADDER) - 1:
            return False
        self.rung += 1
        self._healthy = 0
        self.stats["rung_escalations"] += 1
        self.obs.on_rung("down", self.rung, LADDER[self.rung])
        return True

    def _note_healthy(self) -> None:
        self._healthy += 1
        if self.rung > self._rung_floor and self._healthy >= self.serve.ladder_recovery:
            self.rung -= 1
            self._healthy = 0
            self.stats["rung_recoveries"] += 1
            self.obs.on_rung("up", self.rung, LADDER[self.rung])

    def _note_fault(self, kind: str, detail: str) -> None:
        self.stats["transient_faults"] += 1
        self._healthy = 0
        self._last_fault = {"kind": kind, "iteration": self.iteration, "detail": detail}

    def _backoff(self, attempt: int) -> None:
        base = self.serve.retry_backoff_s
        if base > 0:
            time.sleep(min(base * 2 ** (attempt - 1), 0.25))

    def _retry_transients(self) -> bool:
        """Absorb the injector's transient faults for the coming dispatch
        with bounded, exponentially backed-off retries.  True: cleared to
        dispatch; False: this rung's retry budget is spent (the caller
        escalates).  The check runs before the device call, so a failed
        attempt never touches the pools.

        Only :class:`TransientDeviceError` from the injector is a transient
        fault.  A CUDA error, a failed kernel build or a failed launch
        propagates out of ``step()``: it is never mapped to a transient fault
        and never moves the ladder to the gather step."""
        attempts = 0
        while True:
            if self.injector is None:
                return True
            try:
                self.injector.check_dispatch(self.iteration)
                return True
            except TransientDeviceError as e:
                self._note_fault("transient", str(e))
                attempts += 1
                if attempts > self.serve.retry_limit:
                    return False
                self.stats["retries"] += 1
                self.obs.on_retry()
                self._backoff(attempts)

    def _poison_vec(self, kinds: np.ndarray) -> Optional[np.ndarray]:
        """Per-slot additive logit poison for this iteration (NaN on the
        injector's occupied slots), or None."""
        if self.injector is None:
            return None
        mask = self.injector.nan_mask(self.iteration, self.serve.decode_batch)
        mask = mask & (np.asarray(kinds) > 0)
        n = int(mask.sum())
        if n == 0:
            return None
        self.injector.counts["nan"] += n
        self.stats["injected_nans"] += n
        # emitted here: only the engine knows how many poisons landed on
        # occupied slots
        self.obs.on_fault("nan", seed=self.injector.seed, salt=SALTS["nan"],
                          iteration=self.iteration, slots=n)
        v = np.zeros((self.serve.decode_batch,), np.float32)
        v[mask] = np.nan
        return v

    def _spike(self) -> None:
        if self.injector is not None:
            sp = self.injector.spike_s(self.iteration)
            if sp:
                time.sleep(sp)

    def _set_pool(self) -> None:
        s = self.sched
        self.obs.set_pool(available=s.alloc.available, in_use=s.alloc.in_use,
                          active=len(s._active()), queued=len(s.waiting))

    def step(self) -> None:
        """One engine iteration: pressure/expiry -> admit -> shed -> fork
        copies -> (rolled span | draft -> grow -> one unified mixed step ->
        accept/rollback)."""
        s = self.sched
        if self.injector is not None:
            self.injector.pressure(self.iteration, s.alloc)
        self.stats["expired"] += s.expire_deadlines(time.perf_counter())
        s.admit(self.iteration)
        self.stats["shed"] += s.shed_starved(self.iteration)
        for src, dst in s.drain_copies():
            paged_copy_block(self.pools, src, dst)
            self.stats["fork_copies"] += 1
        if self._rolled is not None and self.rung == 0:
            k, steps = s.plan_rolled(self.iteration, self.rolled_cap)
            if k > 1 and self._rolled_dispatch(k, steps):
                return
            # retry exhaustion escalated mid-plan: the K=1 path this
            # iteration (pre-reserved span blocks stay with their slots)
        drafts = self._propose_drafts()
        s._grow_for_decode({rid: len(d) for rid, d in drafts.items()})
        if s.busy():
            tokens, tables, lens, kinds = s._slab_view(self.serve.mixed_slab_width, drafts)
            composition = {
                "idle": int((kinds == 0).sum()),
                "decode": int((kinds == 1).sum()),
                "prefill": len(s.prefilling()),
                "spec": sum(1 for r in s.running() if r.rid in drafts),
            }
            self.stats["slots_idle"] += composition["idle"]
            self.stats["slots_decode"] += len(s.running())
            self.stats["slots_prefill"] += composition["prefill"]
            rows = int(kinds.sum())
            phase = "prefill" if composition["prefill"] else "decode"
            predicted_s = self._cost.predict_s(rows, float(lens.sum()) + rows)
            while not self._retry_transients():
                if not self._escalate():
                    raise LadderExhausted(
                        "transient dispatch faults exhausted the retry ladder", self.health())
            key = "step" if self.rung < 2 else "fallback_step"
            step_fn = self._step if self.rung < 2 else self._gather_step()
            poison = self._poison_vec(kinds)
            t0 = time.perf_counter()
            self._spike()
            tok, vtok, finite = step_fn(self.params, self.pools, tokens, tables, lens, kinds,
                                        poison)
            self._same_on_every_rank(tok, vtok, finite)
            sampled = tok.cpu().numpy()  # waits for the device: honest step time
            vtok, finite = vtok.cpu().numpy(), finite.cpu().numpy()
            t1 = time.perf_counter()
            dt_ms = (t1 - t0) * 1e3
            self.stats["device_s"] += dt_ms / 1e3
            self._note_healthy()
            calibrated = self.dispatch_counts[key] > 0
            if calibrated:
                # SLO chunk sizing gets a step time without the first call's
                # one-off costs (kernel builds, library set-up)
                s.step_ms = dt_ms if s.step_ms is None else 0.8 * s.step_ms + 0.2 * dt_ms
            self.dispatch_counts[key] += 1
            self.obs.on_dispatch(key, phase, t0, t1, rows=rows, composition=composition,
                                 rung=LADDER[self.rung], predicted_s=predicted_s,
                                 calibrated=calibrated)
            c = s._slab_done(sampled, kinds, vtok, drafts, finite=finite, span=(t0, t1))
            self.obs.on_step_counts(c)
            self._set_pool()
            self.stats["steps"] += 1
            self.stats["dispatches"] += 1
            self.stats["prefill_tokens"] += c["prefill"]
            self.stats["generated_tokens"] += c["generated"]
            for k in ("draft_rows", "accepted_drafts", "spec_slots", "spec_generated",
                      "poisoned"):
                self.stats[k] += c[k]
            self.stats["quarantines"] += c["quarantined"]
            self.stats["occupancy_sum"] += int((kinds > 0).sum()) / self.serve.decode_batch
        self.iteration += 1

    def _rolled_dispatch(self, k: int, steps: np.ndarray) -> bool:
        """One rolled span: up to ``k`` decode iterations, one host
        dispatch, blocks pre-reserved by ``plan_rolled``.  False when
        transient faults spent this rung's retry budget (the ladder stepped
        down; the caller falls through to the K=1 step)."""
        s = self.sched
        if not self._retry_transients():
            self._escalate()
            return False
        tok0 = np.zeros((self.serve.decode_batch,), np.int32)
        for b, req in enumerate(s.slots):
            if req is not None and steps[b] > 0:
                tok0[b] = req.out[-1]
        poison = None
        if self.injector is not None:
            poison = self.injector.nan_in_span(self.iteration, k, self.serve.decode_batch)
            poison[np.asarray(steps) <= 0] = -1
            n = int((poison >= 0).sum())
            self.injector.counts["nan"] += n
            self.stats["injected_nans"] += n
            if n:
                self.obs.on_fault("nan", seed=self.injector.seed, salt=SALTS["nan"],
                                  iteration=self.iteration, slots=n, span_k=int(k))
        t0 = time.perf_counter()
        self._spike()
        out, _ = self._rolled(self.params, self.pools, tok0, s.table, s.lens, steps, k, poison)
        self._same_on_every_rank(out)
        out = out.cpu().numpy()  # waits for the device
        t1 = time.perf_counter()
        dt_ms = (t1 - t0) * 1e3
        self.stats["device_s"] += dt_ms / 1e3
        self._note_healthy()
        adv = int(steps.max())  # device iterations actually executed
        calibrated = self.dispatch_counts["rolled_step"] > 0 and adv > 0
        if calibrated:
            per = dt_ms / adv  # the per-iteration time feeds the same EMA
            s.step_ms = per if s.step_ms is None else 0.8 * s.step_ms + 0.2 * per
        self.dispatch_counts["rolled_step"] += 1
        live = int((steps > 0).sum())
        self.obs.on_dispatch(
            "rolled_step", "decode", t0, t1, rows=live,
            composition={"idle": self.serve.decode_batch - live, "decode": live},
            rung=LADDER[self.rung], k=adv,
            predicted_s=self._cost.predict_s(live, float(s.lens.sum()), k=max(adv, 1)),
            calibrated=calibrated,
        )
        c = s._rolled_done(out, steps, span=(t0, t1))
        self.obs.on_step_counts(c)
        self._set_pool()
        self.stats["steps"] += adv
        self.stats["dispatches"] += 1
        self.stats["rolled_dispatches"] += 1
        self.stats["rolled_steps"] += adv
        self.stats["slots_decode"] += int(steps.sum())
        self.stats["slots_idle"] += adv * self.serve.decode_batch - int(steps.sum())
        self.stats["generated_tokens"] += c["generated"]
        self.stats["quarantines"] += c["quarantined"]
        self.stats["poisoned"] += c["poisoned"]
        self.stats["occupancy_sum"] += float(steps.sum()) / self.serve.decode_batch
        self.iteration += adv
        return True

    def run(self, requests=(), max_iterations: int = 100_000) -> dict:
        """Drive the stream to completion; returns {rid: generated tokens}
        for the requests that finished (shed, expired, cancelled and
        poisoned ones are reported by ``summary()``).

        A stall detector watches for iterations with no progress at all (no
        token emitted, no prompt row consumed, no admission, no completion
        or shedding) while work is pending (a future arrival idling the
        engine is not a stall): ``stall_limit`` of them in a row raise
        :class:`StallError` carrying ``health()``."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        sig, stalled = None, 0
        while not self.sched.idle and self.iteration < max_iterations:
            self.step()
            s = self.sched
            cur = (self.stats["generated_tokens"], self.stats["prefill_tokens"],
                   s.n_admissions, len(s.finished) + len(s.shed))
            idle_by_design = all(x is None for x in s.slots) and all(
                r.arrival > self.iteration for r in s.waiting)
            if cur != sig or idle_by_design:
                sig, stalled = cur, 0
            else:
                stalled += 1
                if stalled >= self.serve.stall_limit:
                    raise StallError(
                        f"engine made no progress for {stalled} consecutive iterations"
                        f" (iteration {self.iteration})", self.health())
        self._sync()
        self.stats["wall_s"] = time.perf_counter() - t0
        if not self.sched.idle:
            raise RuntimeError(f"stream not drained after {max_iterations} iterations")
        return {r.rid: list(r.out) for r in self.sched.finished}

    # -------------------------------------------------- health + snapshot
    def health(self) -> dict:
        """Instantaneous engine health (cheap enough to poll every step;
        attached to StallError and LadderExhausted)."""
        s = self.sched
        arrived = sum(1 for r in s.waiting if r.arrival <= self.iteration)
        return {
            "iteration": self.iteration,
            "rung": self.rung,
            "rung_name": LADDER[self.rung],
            "healthy_streak": self._healthy,
            **{k: self.stats[k] for k in ("retries", "transient_faults", "quarantines", "shed",
                                          "expired", "cancelled", "poisoned")},
            "pool": {"n_blocks": self.serve.n_blocks, "available": s.alloc.available,
                     "in_use": s.alloc.in_use},
            "slots": {"running": len(s.running()), "prefilling": len(s.prefilling()),
                      "free": s.slots.count(None)},
            "queue": {"arrived": arrived, "future": len(s.waiting) - arrived},
            "step_ms": s.step_ms,
            "last_fault": self._last_fault,
        }

    @staticmethod
    def _freeze(req: Request) -> dict:
        return {
            "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "arrival": int(req.arrival),
            "tenant": req.tenant,
            "priority": int(req.priority),
            "slo_ttft_ms": req.slo_ttft_ms,
            "tag": req.tag,
            "deadline_ms": req.deadline_ms,
            "out": [int(t) for t in req.out],
            "status": req.status,
            "quarantines": int(req.quarantines),
        }

    @staticmethod
    def _thaw(rec: dict) -> Request:
        req = Request(rid=rec["rid"], prompt=list(rec["prompt"]),
                      max_new_tokens=rec["max_new_tokens"], arrival=rec["arrival"],
                      tenant=rec["tenant"], priority=rec["priority"],
                      slo_ttft_ms=rec["slo_ttft_ms"], tag=rec["tag"],
                      deadline_ms=rec["deadline_ms"])
        req.out = list(rec["out"])
        req.status = rec["status"]
        req.quarantines = rec["quarantines"]
        return req

    def snapshot(self) -> dict:
        """Plain-JSON logical engine state (the JAX engine's format, so a
        snapshot moves between the two packages): queues, request progress
        and counters, no KV and no allocator layout.  KV pages are a pure
        function of each request's token prefix, so ``restore`` on a fresh
        engine re-prefills every in-flight request and continues with the
        same tokens.  Call between steps."""
        s = self.sched
        return {
            "version": 1,
            "arch": self.cfg.name,
            "iteration": self.iteration,
            "serve_plan": self.serve.to_record(),
            "active": [self._freeze(r) for r in s.slots if r is not None],
            "waiting": [self._freeze(r) for r in s.waiting],
            "finished": [self._freeze(r) for r in s.finished],
            "shed": [self._freeze(r) for r in s.shed],
            # restore takes the counters it knows (JAX's: a subset of these)
            "stats": {k: v for k, v in self.stats.items() if isinstance(v, (int, float))},
            "sched_counters": {
                "n_admissions": s.n_admissions,
                "n_evictions": s.n_evictions,
                "n_forks": s.n_forks,
                "n_prefix_hits": s.n_prefix_hits,
                "prefix_tokens_saved": s.prefix_tokens_saved,
            },
        }

    def restore(self, snap: dict) -> None:
        """Resume a snapshot on this fresh, idle engine: finished and shed
        requests come back as records; in-flight and queued ones re-enter
        the waiting queue with their emitted tokens, and admission prefills
        ``prompt + out[:-1]``.  Deadline clocks restart now."""
        if snap.get("arch") != self.cfg.name:
            raise ValueError(f"snapshot arch {snap.get('arch')!r} != engine {self.cfg.name!r}")
        s = self.sched
        if not s.idle or s.finished or s.shed:
            raise RuntimeError("restore() needs a fresh idle engine")
        self.iteration = int(snap["iteration"])
        for key, into in (("finished", s.finished), ("shed", s.shed)):
            for rec in snap[key]:
                req = self._thaw(rec)
                req.state = DONE
                into.append(req)
        for rec in snap["active"] + snap["waiting"]:
            req = self._thaw(rec)
            req.state = WAITING
            self.submit(req)
        for k, v in snap.get("stats", {}).items():
            if k in self.stats:
                self.stats[k] = v
        sc = snap.get("sched_counters", {})
        for k in ("n_admissions", "n_evictions", "n_forks", "n_prefix_hits",
                  "prefix_tokens_saved"):
            setattr(s, k, sc.get(k, 0))

    def summary(self) -> dict:
        """Engine accounting.  ``tok_per_s`` counts emitted output tokens
        only (prompt rows are ``prefill_tokens``; rejected draft rows count
        nowhere).  ``slab`` sums the slots of every device iteration by what
        they did.  ``tenants`` holds, per tenant, the requests that finished
        normally, their latency and TTFT percentiles and the count of each
        other disposition; ``faults``, ``calibration`` and ``spec`` are the
        JAX engine's blocks (engine.py:1084-1143)."""
        st = self.stats
        fin = self.sched.finished
        shed = self.sched.shed
        wall = st.get("wall_s") or st["device_s"] or None
        spec_on = self.draft is not None and self.spec_len > 0

        tenants = {}
        for t, rs in sorted(_by_tenant(fin + shed).items()):
            t_fin = [r for r in rs if r.status == "ok"]
            tenants[t] = {
                "finished": len(t_fin),
                "latency_s": _percentiles(
                    [r.t_done - r.t_admit for r in t_fin if r.t_done and r.t_admit]),
                "ttft_s": _percentiles(
                    [r.t_first - r.t_admit for r in t_fin if r.t_first and r.t_admit]),
                **_dispositions(rs),
            }
        return {
            "device": str(self.device),
            "iterations": self.iteration,
            "steps": st["steps"],
            "dispatches": st["dispatches"],
            "prefill_tokens": st["prefill_tokens"],
            "generated_tokens": st["generated_tokens"],
            "mean_occupancy": st["occupancy_sum"] / max(st["steps"], 1),
            "evictions": self.sched.n_evictions,
            "dispatch_counts": dict(self.dispatch_counts),
            "fused_attention": self.fused,
            # a sharded engine keeps the kernel on each rank's KV-head pages
            # (JAX's falls back to the gather path); the drift meter prices
            # this TP degree and route
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "wall_s": st.get("wall_s"),
            "device_s": st["device_s"],
            "step_ms": self.sched.step_ms,
            "mean_dispatch_ms": (
                st["device_s"] * 1e3 / st["dispatches"] if st["dispatches"] else None
            ),
            "tok_per_s": st["generated_tokens"] / wall if wall else None,
            "slab": {
                "idle": st["slots_idle"],
                "decode": st["slots_decode"],
                "prefill": st["slots_prefill"],
            },
            "rolled": {
                "enabled": self._rolled is not None,
                "cap": self.rolled_cap,
                "dispatches": st["rolled_dispatches"],
                "rolled_steps": st["rolled_steps"],
                "mean_span": (st["rolled_steps"] / st["rolled_dispatches"]
                              if st["rolled_dispatches"] else None),
            },
            "latency_s": _percentiles(
                [r.t_done - r.t_admit for r in fin if r.t_done and r.t_admit]),
            "ttft_s": _percentiles(
                [r.t_first - r.t_admit for r in fin if r.t_first and r.t_admit]),
            "tenants": tenants,
            "requests": {"finished": len(fin), **_dispositions(shed)},
            "faults": {
                "rung": self.rung,
                "rung_name": LADDER[self.rung],
                **{k: st[k] for k in ("retries", "transient_faults", "rung_escalations",
                                      "rung_recoveries", "quarantines", "injected_nans",
                                      "shed", "expired", "cancelled", "poisoned")},
                "injector": self.injector.summary() if self.injector is not None else None,
            },
            "prefix": {
                "enabled": self.sched.index is not None,
                "admissions": self.sched.n_admissions,
                "hits": self.sched.n_prefix_hits,
                "hit_rate": (self.sched.n_prefix_hits / self.sched.n_admissions
                             if self.sched.n_admissions else None),
                "tokens_saved": self.sched.prefix_tokens_saved,
                "forks": self.sched.n_forks,
                "fork_copies": st["fork_copies"],
                "peak_blocks": self.sched.alloc.peak_in_use,
                "double_frees": self.sched.alloc.double_frees,
            },
            # measured dispatch wall time vs the roofline, per phase
            "calibration": self.obs.drift.report(),
            "spec": {
                "enabled": spec_on,
                "spec_len": self.spec_len,
                "draft": self.serve.draft,
                "draft_rows": st["draft_rows"],
                "accepted_drafts": st["accepted_drafts"],
                "acceptance_rate": (st["accepted_drafts"] / st["draft_rows"]
                                    if st["draft_rows"] else None),
                # output tokens per speculating slot-step (> 1: speculation
                # beats plain decode on those steps)
                "tokens_per_spec_step": (st["spec_generated"] / st["spec_slots"]
                                         if st["spec_slots"] else None),
                "draft_dispatches": (dict(self.draft.dispatch_counts)
                                     if spec_on and hasattr(self.draft, "dispatch_counts")
                                     else None),
            },
            "serve_plan": self.serve.to_record(),
        }

