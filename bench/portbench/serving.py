"""The serving cells: ``repro_torch``'s continuous engine under a closed or
an open loop of requests, timed on the host's clock.

The engine is built as ``repro_torch.launch.serve`` builds it on one card
(``derive_execution_plan``, ``derive_serve_plan`` on the h100 entry with
the configuration's plan inputs, the fused kernels), with the weights the
benchmark drew.  The harness submits each request when it falls due (its
``arrival`` the engine's current iteration, so the engine sees it at once)
and calls ``step()`` in a loop; each new output token is stamped at the
return of the step that produced it.  From the program it reads the
requests' tokens and states, its dispatch spans and row counts
(``Observability.on_dispatch``) and the prefix each admission found
(``on_admit``)."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from bench.portbench import costs, weights

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclasses.dataclass
class Track:
    """One request as the caller sees it."""
    req: object
    due: float  # when it fell due (perf_counter)
    stamps: list  # the return time of the step that carried each token
    client: Optional[int] = None
    ctx: int = 0  # positions cached after the last step the harness saw
    seen: bool = False


@dataclasses.dataclass
class StepRecord:
    t0: float  # the program's dispatch span (host clock around the dispatch
    t1: float  # up to the token read-back)
    rows: int  # live rows, as the program counts them
    slots: list  # (rows, ctx) of each live slot, as the harness reconstructs it
    sampled: int  # tokens emitted by the step


def _hooks_class():
    from repro_torch.obs import Observability

    class Hooks(Observability):
        """The engine's observability bundle, also keeping what the harness
        reads: each admission's resident prefix and each dispatch span."""

        def __init__(self):
            super().__init__(tracing=False)
            self.prefix: dict = {}
            self.dispatches: list = []

        def on_admit(self, req, now, *, prefix_tokens=0, forked=False):
            self.prefix[req.rid] = int(prefix_tokens)
            super().on_admit(req, now, prefix_tokens=prefix_tokens, forked=forked)

        def on_dispatch(self, kind, phase, t0, t1, *, rows, **kw):
            self.dispatches.append((t0, t1, int(rows)))
            super().on_dispatch(kind, phase, t0, t1, rows=rows, **kw)

    return Hooks


def build_engine(arch_cfg, config: dict, seed: int, device, plan_overrides: Optional[dict] = None):
    """(engine, weight leaves' layout, serve plan): the launcher's engine on
    the benchmark's weights."""
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.plan import derive_execution_plan, derive_serve_plan
    from repro_torch.launch.mesh import host_mesh_shape
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServingEngine

    sp = dict(config["serve_plan"])
    hw = get_hardware(sp.pop("hardware", "h100"))
    sp.update(plan_overrides or {})
    plan = derive_execution_plan(arch_cfg)
    serve = derive_serve_plan(arch_cfg, host_mesh_shape(1), hw, **sp)
    dtype = _DTYPES[config["dtype"]]
    layout = init_params(arch_cfg, plan, dtype, device="meta")
    leaves = weights.draw(layout, seed, arch_cfg.norm, device)
    params = weights.rebuild(layout, leaves)
    engine = ServingEngine(params, arch_cfg, plan, serve, obs=_hooks_class()(), hw=hw,
                           device=device)
    return engine, layout, serve


def _cached(req) -> int:
    """Positions of ``req`` resident in the paged cache."""
    from repro_torch.serve.scheduler import PREFILL, WAITING

    if req.state == WAITING:
        return 0
    if req.state == PREFILL:
        return int(req.pos)
    return len(req.prompt) + len(req.out) - 1


class Loop:
    """Drives ``engine`` with the requests of ``traffic`` (a closed or open
    loop generator), recording what the caller sees."""

    def __init__(self, engine, traffic, spans):
        from repro_torch.serve.scheduler import Request

        self.engine, self.traffic, self.spans = engine, traffic, spans
        self.Request = Request
        self.tracks: dict = {}
        self.live: dict = {}  # rid -> Track, until its last token is stamped
        self.steps: list = []
        self.record = False
        self.blocks_peak = 0  # the most pool blocks in use after a recorded step

    def submit(self, spec: dict, due: float, client=None) -> Track:
        req = self.Request(rid=spec["rid"], prompt=spec["prompt"], max_new_tokens=spec["max_new"],
                           arrival=self.engine.iteration, tenant=spec["tenant"])
        with self.spans("bench.submit"):
            self.engine.submit(req)
        tr = Track(req=req, due=due, stamps=[], client=client)
        self.tracks[req.rid] = tr
        self.live[req.rid] = tr
        return tr

    def step(self) -> tuple:
        """One engine iteration; returns (its return time, the finished
        tracks).  While recording, keeps the step's program span and the
        live slots' (rows, positions)."""
        from repro_torch.serve.scheduler import DONE

        hooks = self.engine.obs
        n_disp = len(hooks.dispatches)
        with self.spans("bench.step"):
            self.engine.step()
        t = time.perf_counter()
        done, slots, sampled = [], [], 0
        with self.spans("bench.stamp"):
            for rid, tr in list(self.live.items()):
                req = tr.req
                new = len(req.out) - len(tr.stamps)
                if new > 0:
                    tr.stamps.extend([t] * new)
                    sampled += new
                c1 = _cached(req)
                if not tr.seen and req.rid in hooks.prefix:
                    tr.seen, tr.ctx = True, hooks.prefix[req.rid]
                if tr.seen and c1 > tr.ctx:
                    slots.append((c1 - tr.ctx, c1))
                    tr.ctx = c1
                if req.state == DONE:
                    done.append(tr)
                    del self.live[rid]
        if self.record:
            self.blocks_peak = max(self.blocks_peak, self.engine.sched.alloc.in_use)
            if len(hooks.dispatches) > n_disp:
                t0, t1, rows = hooks.dispatches[-1]
                self.steps.append(StepRecord(t0, t1, rows, slots, sampled))
        return t, done

    def busy(self) -> bool:
        s = self.engine.sched
        return any(x is not None for x in s.slots) or bool(s.waiting)


def warm_up(loop: Loop, vocab: int, prompt_len: int) -> None:
    """Two requests through prefill and a few decode steps: the slab's one
    shape, the kernels (built on a checkout's first run) and cuBLAS's
    choices, before anything is timed.  They are not tracked."""
    from repro_torch.serve.scheduler import Request

    g = torch.Generator().manual_seed(0)
    for i in range(2):
        ids = torch.randint(0, vocab, (prompt_len,), generator=g).tolist()
        loop.engine.submit(Request(rid=f"warm{i}", prompt=ids, max_new_tokens=4,
                                   arrival=loop.engine.iteration))
    while loop.busy():
        loop.engine.step()
    loop.engine.obs.dispatches.clear()


def run_closed(loop: Loop, seconds: float, window) -> dict:
    """The closed loop: every client's first request goes in at once, the
    window opens once each is past its prefill, and a client sends its next
    request the moment the last one finishes."""
    now = time.perf_counter()
    for spec in loop.traffic.first():
        loop.submit(spec, now, client=spec["client"])
    while any(not tr.stamps for tr in loop.live.values()):
        loop.step()
    with window() as w:
        loop.record = True
        loop.blocks_peak = loop.engine.sched.alloc.in_use
        while True:
            t, done = loop.step()
            for tr in done:
                loop.submit(loop.traffic.next(tr.client), t, client=tr.client)
            if t >= w.t0 + seconds:
                break
        w.close(t)
        loop.record = False
    return {"t0": w.t0, "t1": w.t1}


def run_open(loop: Loop, seconds: float, window) -> dict:
    """The open loop: the schedule starts ``preroll_s`` before the window;
    each request is submitted when due, whatever the engine is doing."""
    arrivals = loop.traffic.arrivals
    i, n = 0, len(arrivals)
    t_pre = time.perf_counter()
    t_ws = t_pre + loop.traffic.preroll_s

    def submit_due(now):
        nonlocal i
        while i < n and t_pre + arrivals[i][0] <= now:
            loop.submit(arrivals[i][1], t_pre + arrivals[i][0])
            i += 1

    def idle_until(limit):
        nxt = t_pre + arrivals[i][0] if i < n else limit
        time.sleep(max(0.0, min(nxt, limit) - time.perf_counter()))

    while time.perf_counter() < t_ws:  # the pre-roll (set-up)
        submit_due(time.perf_counter())
        if loop.busy():
            loop.step()
        else:
            idle_until(t_ws)
    with window(start=t_ws) as w:
        loop.record = True
        loop.blocks_peak = loop.engine.sched.alloc.in_use
        t_end = w.t0 + seconds
        t = time.perf_counter()
        while t < t_end:
            submit_due(t)
            if loop.busy():
                t, _ = loop.step()
            else:
                with loop.spans("bench.idle"):
                    idle_until(t_end)
                t = time.perf_counter()
        submit_due(t_end)  # due during the last step: counted, with no token yet
        w.close(t)
        loop.record = False
    return {"t0": w.t0, "t1": w.t1}


def pool_bytes(serve, blocks: int) -> int:
    """Bytes of ``blocks`` pages of the paged cache (every layer's K and V)."""
    return int(blocks) * serve.block_size * serve.kv_bytes_per_token


def kv_elem(serve) -> int:
    return {"bf16": 2, "fp32": 4, "int8": 1}[serve.kv_dtype]


def step_flops(cfg, rec: StepRecord) -> float:
    """Model FLOPs of one serving step's live work: every live row through
    the layers' matrices, attention over each row's causal context, the
    head once for each token the step emitted."""
    per_layer = costs.decoder_matrix_weights(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                             cfg.d_head, cfg.d_ff)
    pairs = sum(costs.context_pairs(ctx - rows, ctx) for rows, ctx in rec.slots)
    return (2.0 * per_layer * cfg.n_layers * rec.rows
            + costs.attention_pair_flops(cfg.n_heads, cfg.d_head) * cfg.n_layers * pairs
            + 2.0 * cfg.d_model * cfg.vocab_size * rec.sampled)
