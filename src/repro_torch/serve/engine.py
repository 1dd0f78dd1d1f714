"""Serving (the port's ``repro/serve/engine.py``): the eager whole-batch
path and the continuous-batching engine over the paged KV cache.

* ``make_prefill_step`` / ``make_decode_step`` / ``greedy_generate``: one
  prefill of the whole batch (flash-attention or WKV kernel, harvesting the
  decode cache), then lockstep greedy decode over a dense cache.  Archs the
  continuous engine cannot serve (RWKV-6) serve through it, and it is the
  oracle the engine's tokens are held to.
* ``make_mixed_step``, ``make_rolled_step`` and ``ServingEngine`` with
  ``submit`` / ``step`` / ``run`` / ``summary``:

Every slot owns ``mixed_slab_width`` query rows of a shared (B, W) token
slab: a decode slot uses 1, a prefill slot up to W (its next prompt chunk),
idle rows are dead and write to the trash block.  Attention goes through the
CUDA paged-attention kernel, which reads the block table directly, and the
norms through the RMSNorm kernel; ``fused=False`` (the gather path, with
plain norms) is the fallback and the oracle.  Scheduling lives host-side in
``serve/scheduler.py``.

PyTorch runs eagerly, so there is no compile to count: the JAX engine's
``trace_counts`` has no counterpart.  ``dispatch_counts`` takes its place in
the step-time calibration: the first dispatch of each step function pays
one-off costs (kernel builds, cuBLAS set-up) where JAX's traces, and is
left out of ``sched.step_ms`` as JAX leaves out a tracing dispatch.  The pools are updated in place where
the JAX steps took them donated.  The fault injector, the degradation
ladder, speculative decoding, snapshot/restore and ``repro.obs`` are not
ported yet.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
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
from repro_torch.serve.scheduler import Request, Scheduler


def make_prefill_step(cfg: ArchConfig, plan: ExecutionPlan, *, fused: bool = True):
    """``prefill(params, batch) -> (logits (B, 1, V) of the last position,
    prefill cache)``: one pass over the whole prompt with
    ``collect_cache=True``.  ``fused=False`` runs the kernels' plain
    versions on any device (the oracle)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x, pc = forward(params, batch, cfg=cfg, plan=plan, collect_cache=True, fused=fused)
        return logits_fn(params, x[:, -1:], cfg), pc

    return prefill_step


def make_decode_step(cfg: ArchConfig, plan: ExecutionPlan, *, fused: bool = True):
    """``decode(params, token (B, 1), cache) -> (logits (B, 1, V), cache)``:
    one token over the dense cache, which is updated in place.
    ``fused=False`` runs the kernels' plain versions on any device."""

    @torch.no_grad()
    def decode_step(params, token, cache):
        x, cache = forward(params, {"tokens": token}, cfg=cfg, plan=plan, cache=cache,
                           fused=fused)
        return logits_fn(params, x, cfg), cache

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
    """Prefill ``batch["tokens"]`` (B, S), then ``n_steps - 1`` lockstep
    greedy decode steps over a dense cache of ``cache_len`` positions in
    ``cache_dtype``.  Returns the (B, n_steps) int32 greedy tokens on
    ``device`` (the card by default; raises without one unless ``"cpu"``),
    where the parameters and the batch are moved first.  ``fused=False``
    runs every kernel's plain version, in the prefill and in each decode
    step."""
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


def _greedy(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """Greedy token and the finiteness scalar per slot from (B, d) rows."""
    logits = logits_fn(params, x, cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    # a NaN/Inf anywhere in the sampled logits poisons the sum
    finite = torch.isfinite(torch.sum(logits.float(), dim=-1))
    return tok, finite


def make_mixed_step(cfg: ArchConfig, plan: ExecutionPlan, serve: ServePlan, *, fused: bool):
    """The unified mixed prefill/decode step.

    ``step(params, pools, tokens (B, W), tables (B, MB), lens (B,),
    kinds (B,))`` takes the scheduler's numpy arrays and returns device
    tensors ``(tok (B,), finite (B,))``: ``tok[b]`` is the greedy token at
    slot b's last live row, ``finite[b]`` false when any logit it sampled
    from is non-finite (the host quarantines such slots)."""

    @torch.no_grad()
    def step(params, pools, tokens, tables, lens, kinds):
        dev = params["embed"].device
        kinds_d = _upload(kinds, dev)
        page_state = {**_page_state(serve, fused, tables, dev), "q_lens": kinds_d}
        x, _ = forward(
            params, {"tokens": _upload(tokens, dev)}, cfg=cfg, plan=plan,
            cache={"layers": pools["layers"], "t": _upload(lens, dev)},
            page_state=page_state, fused=fused,
        )
        # per-slot row kinds-1: row 0 for decode slots, the final prompt
        # token on a last prefill chunk
        idx = torch.clamp(kinds_d.long() - 1, min=0)
        xl = x[torch.arange(x.shape[0], device=dev), idx]
        return _greedy(params, xl, cfg)

    return step


def make_rolled_step(cfg: ArchConfig, plan: ExecutionPlan, serve: ServePlan, *, fused: bool):
    """The rolled decode loop: up to K decode iterations for one host
    dispatch, without reading anything back between them.

    ``rolled(params, pools, tok (B,), tables (B, MB), lens (B,),
    steps_left (B,), k_steps)`` runs each iteration as a width-1 slab:
    forward, greedy argmax, repack the token, advance the per-slot length.
    ``steps_left[b]`` is slot b's own budget (0 = idle); a slot whose budget
    runs out goes dead (writes to the trash block, token frozen).  A slot
    whose logits turn non-finite stops for good (the sticky dead flag): its
    length stays at the last good position and its remaining output columns
    stay -1.  The JAX loop exits once no slot is live; here the host knows
    the budgets, so it runs ``min(k_steps, max(steps_left))`` iterations,
    and an iteration with no live slot changes nothing.

    Returns device tensors ``(out (B, K), lens (B,))`` with
    ``out[b, :steps_left[b]]`` slot b's tokens (-1 past the end)."""
    K = int(serve.rolled_steps)

    @torch.no_grad()
    def rolled(params, pools, tok, tables, lens, steps_left, k_steps):
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
            )
            nxt, ok = _greedy(params, x[:, -1], cfg)
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
    one unified mixed step (or, when the plan allows K > 1 and the
    scheduler's event horizon says no host event falls due, one rolled span
    of K decode iterations).  Greedy outputs match the JAX engine's token
    for token on the same weights; ``fused=False`` swaps the CUDA kernels for
    the gather path and the plain norms, with the same tokens.

    ``device`` defaults to ``"cuda"`` and raises when there is no card; the
    parameters are moved there if they are not already."""

    def __init__(
        self,
        params: dict,
        cfg: ArchConfig,
        plan: ExecutionPlan,
        serve: ServePlan,
        *,
        fused: Optional[bool] = None,
        device="cuda",
    ):
        ok, reason = serve_feasible(cfg)
        if not ok:
            raise ValueError(f"{cfg.name} cannot serve continuously: {reason}")
        self.device = resolve_device(device)
        self.cfg, self.plan, self.serve = cfg, plan, serve
        self.params = _tree_to(params, self.device)
        self.pools = init_paged_cache(cfg, plan, serve, self.device)
        self.sched = Scheduler(serve)
        self.fused = serve.fused_attention if fused is None else bool(fused)
        if self.fused and self.device.type == "cuda":
            # build (or load) the kernels now, so no step's time includes nvcc
            kernels = [paged_attention_kernel] + (
                [rmsnorm_kernel] if cfg.norm == "rmsnorm" else [])
            _build.build_all([k.SOURCE for k in kernels])
            for k in kernels:
                k.library()
        self._step = make_mixed_step(cfg, plan, serve, fused=self.fused)
        self.rolled_cap = int(serve.rolled_steps)
        self._rolled = (
            make_rolled_step(cfg, plan, serve, fused=self.fused)
            if self.rolled_cap > 1
            else None
        )
        self.iteration = 0
        # dispatches of each step function: the first of each is left out of
        # the step-time EMA (the JAX engine's calibration gate)
        self.dispatch_counts = {"step": 0, "rolled_step": 0}
        self.stats = {
            "steps": 0, "dispatches": 0, "prefill_tokens": 0, "generated_tokens": 0,
            "fork_copies": 0, "occupancy_sum": 0.0, "rolled_dispatches": 0,
            "rolled_steps": 0, "device_s": 0.0, "quarantines": 0, "poisoned": 0,
            "expired": 0, "shed": 0, "slots_idle": 0, "slots_decode": 0,
            "slots_prefill": 0,
        }

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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        """One engine iteration: expiry -> admit -> shed -> fork copies ->
        (rolled span | grow -> one unified mixed step)."""
        s = self.sched
        self.stats["expired"] += s.expire_deadlines(time.perf_counter())
        s.admit(self.iteration)
        self.stats["shed"] += s.shed_starved(self.iteration)
        for src, dst in s.drain_copies():
            paged_copy_block(self.pools, src, dst)
            self.stats["fork_copies"] += 1
        if self._rolled is not None:
            k, steps = s.plan_rolled(self.iteration, self.rolled_cap)
            if k > 1:
                self._rolled_dispatch(k, steps)
                return
        s._grow_for_decode()
        if s.busy():
            tokens, tables, lens, kinds = s._slab_view(self.serve.mixed_slab_width)
            self.stats["slots_idle"] += int((kinds == 0).sum())
            self.stats["slots_decode"] += len(s.running())
            self.stats["slots_prefill"] += len(s.prefilling())
            t0 = time.perf_counter()
            tok, finite = self._step(self.params, self.pools, tokens, tables, lens, kinds)
            sampled = tok.cpu().numpy()  # waits for the device: honest step time
            finite = finite.cpu().numpy()
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.stats["device_s"] += dt_ms / 1e3
            if self.dispatch_counts["step"]:
                # feed SLO chunk sizing a step time without the first call's
                # one-off costs (kernel builds, cuBLAS set-up), as JAX leaves
                # out its tracing dispatch
                s.step_ms = dt_ms if s.step_ms is None else 0.8 * s.step_ms + 0.2 * dt_ms
            self.dispatch_counts["step"] += 1
            c = s._slab_done(sampled, kinds, finite=finite)
            self.stats["steps"] += 1
            self.stats["dispatches"] += 1
            self.stats["prefill_tokens"] += c["prefill"]
            self.stats["generated_tokens"] += c["generated"]
            self.stats["quarantines"] += c["quarantined"]
            self.stats["poisoned"] += c["poisoned"]
            self.stats["occupancy_sum"] += int((kinds > 0).sum()) / self.serve.decode_batch
        self.iteration += 1

    def _rolled_dispatch(self, k: int, steps: np.ndarray) -> None:
        """One rolled span: up to ``k`` decode iterations, one host
        dispatch, blocks pre-reserved by ``plan_rolled``."""
        s = self.sched
        tok0 = np.zeros((self.serve.decode_batch,), np.int32)
        for b, req in enumerate(s.slots):
            if req is not None and steps[b] > 0:
                tok0[b] = req.out[-1]
        t0 = time.perf_counter()
        out, _ = self._rolled(self.params, self.pools, tok0, s.table, s.lens, steps, k)
        out = out.cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.stats["device_s"] += dt_ms / 1e3
        adv = int(steps.max())  # device iterations actually executed
        if self.dispatch_counts["rolled_step"] and adv > 0:
            per = dt_ms / adv  # the per-iteration time feeds the same EMA
            s.step_ms = per if s.step_ms is None else 0.8 * s.step_ms + 0.2 * per
        self.dispatch_counts["rolled_step"] += 1
        c = s._rolled_done(out, steps)
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

    def run(self, requests=(), max_iterations: int = 100_000) -> dict:
        """Drive the stream to completion; returns {rid: generated tokens}
        for the requests that finished."""
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while not self.sched.idle and self.iteration < max_iterations:
            self.step()
        self._sync()
        self.stats["wall_s"] = time.perf_counter() - t0
        if not self.sched.idle:
            raise RuntimeError(f"stream not drained after {max_iterations} iterations")
        return {r.rid: list(r.out) for r in self.sched.finished}

    def summary(self) -> dict:
        """Engine accounting.  ``tok_per_s`` counts emitted output tokens
        only; prompt rows are ``prefill_tokens``.  ``slab`` sums the slots of
        every device iteration by what they did.  ``tenants`` holds, per
        tenant, the requests that finished normally, their latency and TTFT
        percentiles and the count of each other disposition (JAX
        engine.py:1027-1046)."""
        st = self.stats
        fin = self.sched.finished
        wall = st.get("wall_s") or st["device_s"] or None

        def _dispositions(rs: list) -> dict:
            out = {"shed": 0, "expired": 0, "cancelled": 0, "poisoned": 0}
            for r in rs:
                if r.status in out:
                    out[r.status] += 1
            return out

        tenants = {}
        for t, rs in sorted(_by_tenant(fin + self.sched.shed).items()):
            t_fin = [r for r in rs if r.status == "ok"]
            tenants[t] = {
                "finished": len(t_fin),
                "latency_s": _percentiles(
                    [r.t_done - r.t_admit for r in t_fin if r.t_done and r.t_admit]
                ),
                "ttft_s": _percentiles(
                    [r.t_first - r.t_admit for r in t_fin if r.t_first and r.t_admit]
                ),
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
            "fused_attention": self.fused,
            "wall_s": st.get("wall_s"),
            "device_s": st["device_s"],
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
            },
            "latency_s": _percentiles(
                [r.t_done - r.t_admit for r in fin if r.t_done and r.t_admit]
            ),
            "ttft_s": _percentiles(
                [r.t_first - r.t_admit for r in fin if r.t_first and r.t_admit]
            ),
            "tenants": tenants,
            "requests": {"finished": len(fin), "shed": len(self.sched.shed)},
            "quarantines": st["quarantines"],
            "prefix": {
                "enabled": self.sched.index is not None,
                "admissions": self.sched.n_admissions,
                "hits": self.sched.n_prefix_hits,
                "tokens_saved": self.sched.prefix_tokens_saved,
                "fork_copies": st["fork_copies"],
            },
            "serve_plan": self.serve.to_record(),
        }
