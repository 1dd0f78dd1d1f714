"""Continuous-batching scheduler (host side): a copy of
``repro/serve/scheduler.py``.

The device side of serving is ONE static-shape jitted step (the unified
mixed prefill/decode slab — ``serve/engine.py``); everything dynamic lives
here as plain Python: request admission, block accounting, slab packing,
completion and eviction.  The scheduler owns the block tables and per-slot
lengths as numpy arrays and hands device copies to each step, so the step
never retraces on request churn.

Policy (Orca-style iteration-level scheduling, token-level batching):

* **admission** — priority classes with per-tenant fair shares: among the
  arrived waiting requests the scheduler repeatedly admits the one with the
  highest ``priority``, breaking ties toward the tenant holding the fewest
  slots (work-conserving max-min fairness), then by arrival.  A request is
  admitted when a decode slot is free and the pool can cover the un-shared
  part of its prompt.
* **prefix sharing** — a :class:`~repro_torch.serve.prefix.PrefixIndex` maps the
  prompt to already-resident block runs: fully-matched blocks are shared by
  refcount (no pages, no prefill), a mid-block divergence forks the block
  (copy-on-write: the engine copies the pages before its next step — see
  ``pending_copies``), and only the divergent tail is prefilled.
* **slab packing** — every slot contributes rows to one (B, W) token slab
  per iteration: a mid-prefill slot fills its row with its next prompt
  chunk, a running slot carries its last sampled token in row 0, and idle
  rows are dead (``kinds`` = live rows per slot; dead rows write to the
  trash block).  Chunk sizing is SLO-aware: a prefill with a TTFT target
  always takes the full width, and when one of them is at risk (measured
  step time says the target needs more than half the slab's rate) the
  SLO-less prefills throttle to one block per step so every step stays
  short.
* **growth/eviction** — decode slots grow their block list lazily, one
  block at a time; when the pool is exhausted a requester may only evict
  runners strictly weaker than itself (lower priority, then younger), so
  the most senior request always finishes (no eviction livelock).
  Releasing a victim only returns blocks with no remaining sharers — a
  shared prefix survives its evicted co-owner.
* **completion** — a slot that reaches ``max_new_tokens`` frees its blocks
  and the slot is immediately reusable (padding-free slot reuse: the other
  slots never see it).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np

from repro_torch.core.plan import ServePlan
from repro_torch.serve.prefix import PrefixIndex

WAITING, PREFILL, RUNNING, DONE = "waiting", "prefill", "running", "done"


def random_stream(
    cfg,
    n_requests: int,
    prompt_len,
    gen: int,
    stagger: int = 0,
    seed: int = 0,
    rid_prefix: str = "req",
) -> list["Request"]:
    """Synthetic staggered request stream (launcher, benchmarks, examples all
    share this so they exercise the same arrival semantics).

    ``prompt_len`` is an int for fixed-length prompts or an (lo, hi) tuple
    for mixed lengths drawn uniformly."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        n = (
            int(rng.integers(prompt_len[0], prompt_len[1]))
            if isinstance(prompt_len, tuple)
            else prompt_len
        )
        reqs.append(
            Request(
                rid=f"{rid_prefix}{i:03d}",
                prompt=list(rng.integers(0, cfg.vocab_size, n)),
                max_new_tokens=gen,
                arrival=i * stagger,
            )
        )
    return reqs


class BlockAllocator:
    """Refcounted free-list allocator over the shared block pool.

    Block 0 is reserved as the trash block (idle decode slots write there),
    so ids 1..n_blocks-1 are allocatable.  ``alloc`` hands out blocks with
    one reference; ``share`` adds a sharer (prefix sharing: N requests on
    one resident prefix hold the same physical block); ``free`` drops one
    reference per listed block and only returns a block to the pool when
    its last sharer lets go.  Freed blocks are handed out again
    (wraparound) — stale page contents are simply overwritten by the next
    owner's writes.

    Double-free safety: with refcounts a stray second ``free`` of the same
    list would silently steal a block still owned by a sharer, so freeing
    a block with no live references is a counted, warned no-op
    (``double_frees``) instead of trusting callers.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least one allocatable block + trash")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() yields 1 first
        self._ref = [0] * n_blocks
        self.double_frees = 0
        self.peak_in_use = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical blocks currently owned (however many sharers each has)."""
        return self.n_blocks - 1 - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> Optional[list[int]]:
        """n blocks, or None when the pool cannot host them (caller evicts)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._ref[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return got

    def share(self, blocks: list[int]) -> None:
        """Add one reference per block (must already be live)."""
        for b in blocks:
            if self._ref[b] < 1:
                raise ValueError(f"cannot share unowned block {b}")
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks: list[int]) -> list[int]:
        """Drop one reference per block; returns the blocks actually
        released to the pool (refcount hit zero) so the caller can
        invalidate the prefix index precisely."""
        released = []
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"block {b} out of range")
            if self._ref[b] < 1:
                self.double_frees += 1
                warnings.warn(
                    f"double free of block {b} ignored", RuntimeWarning,
                    stacklevel=2,
                )
                continue
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                released.append(b)
        return released


@dataclasses.dataclass
class Request:
    """One serving request (the ``repro_torch.serve`` public request record).

    Construct with the prompt and generation budget; the multi-tenant
    descriptors are keyword-only:

    * ``tenant`` — fair-share accounting key (per-tenant slot shares).
    * ``priority`` — admission/eviction class; higher wins.
    * ``slo_ttft_ms`` — time-to-first-token target; feeds SLO-aware prefill
      chunk sizing (and, via the plan, slab width / draft depth).
    * ``tag`` — free-form workload-class label for per-class reporting
      (``serve.workload.per_class_report``); never read by the scheduler.
    * ``deadline_ms`` — wall-clock budget from submit; expiry cancels the
      request wherever it is (queue or slot) and releases its resources.
      None inherits the plan's fleet default.

    Every field after the marker comment is scheduler-owned runtime state —
    internal, reset on eviction, not part of the construction API.
    """

    rid: str
    prompt: list[int]
    max_new_tokens: int
    arrival: int = 0  # engine iteration at which the request becomes visible
    _: dataclasses.KW_ONLY
    tenant: str = "default"
    priority: int = 0
    slo_ttft_ms: Optional[float] = None
    tag: str = ""
    deadline_ms: Optional[float] = None
    # -- scheduler-owned state --
    state: str = WAITING
    slot: int = -1
    blocks: list[int] = dataclasses.field(default_factory=list)
    pos: int = 0  # prompt tokens resident (shared prefix + prefilled) so far
    out: list[int] = dataclasses.field(default_factory=list)
    shared: int = 0  # leading blocks held by refcount share (stats only)
    registered: int = 0  # prefix-index high-water mark (full blocks indexed)
    # -- robustness state --
    # terminal disposition: "ok" (finished normally) | "shed" (admission
    # backpressure) | "expired" (deadline) | "cancelled" (caller) |
    # "poisoned" (quarantine_limit consecutive non-finite steps)
    status: str = "ok"
    retry_after_s: Optional[float] = None  # hint attached when shed
    quarantines: int = 0  # total non-finite steps absorbed (stats)
    quarantine_streak: int = 0  # consecutive; reset by any progress
    blocked_since: Optional[int] = None  # iteration admission first starved
    # -- latency bookkeeping (wall clock; summary percentiles) --
    t_submit: Optional[float] = None  # entered the queue (deadline clock t0)
    t_admit: Optional[float] = None  # first admitted into a slot
    t_first: Optional[float] = None  # first output token sampled
    t_done: Optional[float] = None  # generation complete

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens

    @property
    def prefill_target(self) -> list[int]:
        """Tokens that must be cache-resident before this slot decodes:
        the prompt, plus — after a crash-restore replay resumed mid-stream
        — all but the last already-emitted token (that one re-enters as
        the decode row).  KV pages are a pure function of the token
        prefix, so replaying this target rebuilds them byte-exactly."""
        return (self.prompt + self.out[:-1]) if self.out else self.prompt


def _seniority(r: Request) -> tuple:
    """Total order for admission/eviction: higher priority first, then
    older arrival, then rid.  Smaller = more senior."""
    return (-r.priority, r.arrival, r.rid)


class Scheduler:
    """Owns slots, block tables and the request queues for one engine."""

    def __init__(self, serve: ServePlan, *, obs=None):
        self.serve = serve
        # shared with the owning engine (which passes its bundle in); a
        # bare Scheduler builds its own so lifecycle accounting always has
        # somewhere to land.  Tracing stays disabled unless the bundle
        # enables it — every hook is host-side only.
        if obs is None:
            from repro_torch.obs import Observability

            obs = Observability()
        self.obs = obs
        self.alloc = BlockAllocator(serve.n_blocks)
        self.index = (
            PrefixIndex(serve.block_size) if serve.prefix_sharing else None
        )
        self.table = np.zeros(
            (serve.decode_batch, serve.max_blocks_per_seq), np.int32
        )  # all-trash until a slot is owned
        self.lens = np.zeros((serve.decode_batch,), np.int32)
        self.slots: list[Optional[Request]] = [None] * serve.decode_batch
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        # requests retired *without* completing (shed / expired / cancelled /
        # poisoned) — kept separate so goodput accounting cannot conflate
        # them with finished streams
        self.shed: list[Request] = []
        self.n_evictions = 0
        # copy-on-write forks the engine must apply (device page copies)
        # BEFORE its next step: (src block, dst block) pairs, appended at
        # admission and drained by ``drain_copies``.  Nothing may free the
        # source between admission and the drain (the engine drains right
        # after ``admit``; growth/eviction only run later in the iteration).
        self.pending_copies: list[tuple[int, int]] = []
        self.n_forks = 0
        self.n_admissions = 0
        self.n_prefix_hits = 0
        self.prefix_tokens_saved = 0
        # measured step wall time (EMA, engine-fed) for SLO chunk sizing
        self.step_ms: Optional[float] = None

    # ------------------------------------------------------------- helpers
    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.serve.block_size)

    def submit(self, req: Request) -> None:
        limit = self.serve.max_blocks_per_seq * self.serve.block_size
        if len(req.prompt) + req.max_new_tokens > limit:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)}"
                f" + {req.max_new_tokens} new tokens exceeds max_seq {limit}"
            )
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.obs.on_submit(req)
        self.waiting.append(req)

    # ----------------------------------------------------------- admission
    def _tenant_load(self) -> dict:
        load: dict = {}
        for r in self._active():
            load[r.tenant] = load.get(r.tenant, 0) + 1
        return load

    def admit(self, iteration: int) -> None:
        """Priority + per-tenant fair-share admission over arrived waiters.

        Dead slab rows write to the trash block, so a prompt needs exactly
        ``ceil(len / block_size)`` blocks — minus whatever prefix the index
        finds resident.  Admission stops at the first pool-full candidate
        (no bypass: a starved head-of-line request keeps its turn)."""
        while True:
            arrived = [r for r in self.waiting if r.arrival <= iteration]
            if not arrived:
                return
            slot = next((i for i, s in enumerate(self.slots) if s is None), None)
            if slot is None:
                self._mark_blocked(arrived, iteration)
                return
            load = self._tenant_load()
            req = min(
                arrived,
                key=lambda r: (-r.priority, load.get(r.tenant, 0), r.arrival, r.rid),
            )
            if not self._admit_one(req, slot):
                self._mark_blocked(arrived, iteration)
                return  # pool full: keep order, try next iteration
            # the queue moved: nobody still waiting is starving *yet*
            for r in self.waiting:
                r.blocked_since = None

    def _mark_blocked(self, arrived: list[Request], iteration: int) -> None:
        """Start (or continue) the starvation clock for arrived waiters the
        pool/slots cannot take; ``shed_starved`` sheds them once the clock
        exceeds the plan's admission patience."""
        for r in arrived:
            if r.blocked_since is None:
                r.blocked_since = iteration

    def _admit_one(self, req: Request, slot: int) -> bool:
        """Place one request into a slot, sharing whatever prefix is
        resident.  Returns False (no side effects) when the pool cannot
        host the un-shared blocks.

        Admission prefills ``req.prefill_target`` — the prompt for a fresh
        or evicted request, prompt + emitted-so-far for a crash-restore
        replay (``out`` is preserved; the replayed KV is byte-identical
        because pages are a pure function of the token prefix)."""
        target = req.prefill_target
        total = self._blocks_for(len(target))
        full: list[int] = []
        partial = None
        p = 0
        if self.index is not None:
            full, partial, p = self.index.match(target)
        fresh = self.alloc.alloc(total - len(full))
        if fresh is None:
            return False
        self.alloc.share(full)
        if partial is not None:
            # copy-on-write fork: the divergence point sits inside a
            # resident block — copy its pages to fresh[0], prefill the tail
            self.pending_copies.append((partial[0], fresh[0]))
            self.n_forks += 1
        blocks = full + fresh
        self.waiting.remove(req)
        req.state, req.slot, req.blocks, req.pos = PREFILL, slot, blocks, p
        req.blocked_since = None
        req.quarantine_streak = 0
        req.shared = len(full)
        req.registered = len(full)
        self.n_admissions += 1
        if p > 0:
            self.n_prefix_hits += 1
            self.prefix_tokens_saved += p
        now = time.perf_counter()
        if req.t_admit is None:  # re-admission after eviction keeps t0
            req.t_admit = now
        self.obs.on_admit(
            req, now, prefix_tokens=p, forked=partial is not None
        )
        self.slots[slot] = req
        self.table[slot] = 0
        self.table[slot, : len(blocks)] = blocks
        self.lens[slot] = 0
        return True

    def drain_copies(self) -> list[tuple[int, int]]:
        """Hand the engine the pending fork copies (and forget them)."""
        out, self.pending_copies = self.pending_copies, []
        return out

    # ------------------------------------------------------------ the slab
    def busy(self) -> bool:
        return any(s is not None for s in self.slots)

    def _slo_pressure(self) -> bool:
        """True while some SLO'd prefill is at risk: at the measured step
        time its TTFT target needs more than half the slab's row rate, so
        SLO-less prefills should yield chunk width (shorter steps)."""
        if self.step_ms is None:
            return False
        now = time.perf_counter()
        W = self.serve.mixed_slab_width
        for r in self.prefilling():
            if r.slo_ttft_ms is None or r.t_admit is None:
                continue
            left_ms = r.slo_ttft_ms - (now - r.t_admit) * 1e3
            steps_left = max(left_ms, 0.0) / max(self.step_ms, 1e-9)
            if len(r.prefill_target) - r.pos > 0.5 * W * steps_left:
                return True
        return False

    def _chunk_for(self, req: Request, width: int, pressure: bool) -> int:
        """SLO-aware prefill chunk sizing: TTFT-targeted requests always
        take the full slab width; SLO-less ones throttle to one block per
        step while an SLO'd prefill is at risk."""
        rem = len(req.prefill_target) - req.pos
        if req.slo_ttft_ms is None and pressure:
            return min(rem, width, self.serve.block_size)
        return min(rem, width)

    def _slab_view(self, width: int, drafts: Optional[dict] = None):
        """[internal] Pack one engine iteration's (B, W) token slab.

        Returns (tokens, tables, lens, kinds) as numpy arrays:
        ``kinds[b]`` is the number of live query rows of slot b — 0 for an
        idle slot (whole row dead, table zeroed to the trash block), 1 for
        a decode slot (its last sampled token), up to W for a prefill slot
        (its next prompt chunk).  ``lens[b]`` is the absolute position of
        the row's first token.

        ``drafts`` ({rid: [draft tokens]}, speculative decoding) turns a
        running slot's row into a gamma+1-token verification chunk: its
        last sampled token followed by the drafted continuation.  Keyed by
        rid, not slot, so drafts for a request evicted (or recycled) between
        proposal and packing are dropped on the floor instead of riding an
        unrelated slot."""
        B = self.serve.decode_batch
        tokens = np.zeros((B, width), np.int32)
        tables = np.zeros_like(self.table)
        lens = np.zeros((B,), np.int32)
        kinds = np.zeros((B,), np.int32)
        pressure = self._slo_pressure()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            tables[b] = self.table[b]
            if req.state == RUNNING:
                row = [req.out[-1]]
                if drafts:
                    row += list(drafts.get(req.rid, ()))[: width - 1]
                tokens[b, : len(row)] = row
                lens[b] = self.lens[b]
                kinds[b] = len(row)
            elif req.state == PREFILL:
                n = self._chunk_for(req, width, pressure)
                chunk = req.prefill_target[req.pos : req.pos + n]
                tokens[b, : len(chunk)] = chunk
                lens[b] = req.pos
                kinds[b] = len(chunk)
        return tokens, tables, lens, kinds

    def _slab_done(
        self,
        sampled: np.ndarray,
        kinds: np.ndarray,
        vtok: Optional[np.ndarray] = None,
        drafts: Optional[dict] = None,
        finite: Optional[np.ndarray] = None,
        span: Optional[tuple] = None,
    ) -> dict:
        """[internal] Consume one unified step's per-slot sampled tokens.

        ``sampled[b]`` is the greedy token at the slot's last live row — a
        running slot's next token, or (on the final prompt chunk) the
        request's first output token; mid-chunk samples are discarded.

        Speculative slots (``drafts[rid]`` rode the slab) are verified
        against ``vtok`` ((B, spec_len+1): the greedy argmax at each of the
        slot's leading rows): the longest draft prefix matching the target's
        own greedy choices is accepted, and every emitted token is one the
        target would have produced serially — acceptance changes speed,
        never tokens.  Rollback past rejected rows is just the per-slot
        length vector (`lens[b] += len(emitted)` instead of += gamma+1);
        the block table is untouched and the stale KV the dead rows wrote
        past the new length is masked by the kernel and overwritten when
        the slot next advances.

        Newly *full* blocks (their whole extent below the slot's accepted
        length) are registered in the prefix index here — only accepted
        tokens, so rejected draft rows never leak into a shared prefix.

        ``finite[b]`` (the on-device finiteness scalar, when the engine
        passes it) gates everything: a non-finite slot is *quarantined* —
        no token is emitted, no position advances, and the slot simply
        replays the same rows next iteration (the KV it wrote is a pure
        function of the token prefix, so the replay is byte-exact).
        ``quarantine_limit`` consecutive quarantines cancel the request as
        poisoned instead of replaying forever.

        Returns this step's accounting: output tokens actually emitted
        (``generated``), prompt rows consumed (``prefill``), quarantine
        outcomes, and the speculation counters (draft rows submitted /
        accepted, slots that speculated, tokens they emitted).

        ``span`` is the engine's (t0, t1) dispatch window; when given, each
        busy slot gets a per-request lifecycle span over that window
        (``prefill-chunk`` / ``decode`` / ``spec-verify``) so request
        timelines nest under step spans in the Chrome trace."""
        now = time.perf_counter()
        tr = self.obs.tracer
        c = {
            "generated": 0, "prefill": 0, "draft_rows": 0,
            "accepted_drafts": 0, "spec_slots": 0, "spec_generated": 0,
            "quarantined": 0, "poisoned": 0,
        }

        def finish(b, req):
            self._finish(req, now)

        for b, req in enumerate(self.slots):
            if req is None or kinds[b] == 0:
                continue
            if finite is not None and not bool(finite[b]):
                c["quarantined"] += 1
                if self._note_quarantine(req, now):
                    c["poisoned"] += 1
                continue
            req.quarantine_streak = 0
            if req.state == RUNNING:
                k = int(kinds[b])
                d = list((drafts or {}).get(req.rid, ()))[: k - 1] if k > 1 else []
                if d:
                    v = vtok[b]
                    a = 0
                    while a < len(d) and int(v[a]) == int(d[a]):
                        a += 1
                    room = req.max_new_tokens - len(req.out)
                    emit = [int(v[i]) for i in range(min(a + 1, room))]
                    c["draft_rows"] += len(d)
                    c["accepted_drafts"] += a
                    c["spec_slots"] += 1
                    c["spec_generated"] += len(emit)
                    if span is not None:
                        tr.request_span(
                            "spec-verify", req.rid, span[0], span[1],
                            {"drafted": len(d), "accepted": a,
                             "emitted": len(emit)},
                        )
                        if a < len(d):
                            tr.request_instant(
                                "rollback", req.rid, span[1],
                                {"rejected": len(d) - a},
                            )
                else:
                    emit = [int(sampled[b])]
                    if span is not None:
                        tr.request_span(
                            "decode", req.rid, span[0], span[1],
                            {"pos": int(self.lens[b])},
                        )
                self.lens[b] += len(emit)
                req.out.extend(emit)
                c["generated"] += len(emit)
                if req.done:
                    finish(b, req)
                else:
                    self._register_full_blocks(req, int(self.lens[b]))
            elif req.state == PREFILL:
                target = req.prefill_target
                req.pos += int(kinds[b])
                c["prefill"] += int(kinds[b])
                if span is not None:
                    tr.request_span(
                        "prefill-chunk", req.rid, span[0], span[1],
                        {"rows": int(kinds[b]), "pos": req.pos},
                    )
                if req.pos >= len(target):
                    if not req.out:
                        req.out.append(int(sampled[b]))
                        c["generated"] += 1
                        req.t_first = now
                        tr.request_instant("first-token", req.rid, now)
                    # else: crash-restore replay — the sample at the last
                    # target row is out[-1]'s already-known predecessor
                    # argmax; the preserved tail re-enters as the decode row
                    req.state = RUNNING
                    self.lens[b] = len(target)
                    if req.done:  # max_new_tokens == 1
                        finish(b, req)
                        continue
                self._register_full_blocks(req, req.pos)
        return c

    def _note_quarantine(self, req: Request, now: float) -> bool:
        """Count one quarantined (non-finite) step; cancel the request as
        poisoned when the streak exhausts the plan's quarantine limit.
        Returns True if the request was cancelled."""
        req.quarantines += 1
        req.quarantine_streak += 1
        self.obs.on_quarantine(req, now)
        if req.quarantine_streak >= self.serve.quarantine_limit:
            self.cancel(req, status="poisoned", now=now)
            return True
        return False

    def _finish(self, req: Request, now: float) -> None:
        """Retire a completed request: release its blocks/slot, record it.
        Shared by the K=1 slab path and the rolled-span path."""
        req.t_done = now
        req.state = DONE
        self._release(req)
        self.finished.append(req)
        self.obs.on_finish(req, now)

    # ----------------------------------------------- cancellation / shedding
    def cancel(
        self,
        req: Request,
        status: str = "cancelled",
        retry_after: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """Retire a request *without* completing it, wherever it lives —
        the waiting queue or an active slot.  Blocks and radix references
        release exactly as on completion; a pending copy-on-write fork
        targeting a released block is dropped before it can write into a
        reallocated page."""
        if req.state == DONE:
            return
        if req in self.waiting:
            self.waiting.remove(req)
        if req.blocks or req.slot >= 0:
            mine = set(req.blocks)
            self.pending_copies = [
                (s, d) for s, d in self.pending_copies if d not in mine
            ]
            self._release(req)
        req.state = DONE
        req.status = status
        req.retry_after_s = retry_after
        req.t_done = now if now is not None else time.perf_counter()
        self.shed.append(req)
        self.obs.on_cancel(req, status, req.t_done)

    def expire_deadlines(self, now: float) -> int:
        """Cancel every queued or active request whose wall-clock deadline
        (ms since submit) has passed; returns how many expired."""
        n = 0
        candidates = [r for r in self.waiting] + [
            s for s in self.slots if s is not None
        ]
        for r in candidates:
            if r.deadline_ms is None or r.t_submit is None:
                continue
            if (now - r.t_submit) * 1e3 > r.deadline_ms:
                self.cancel(r, status="expired", now=now)
                n += 1
        return n

    def shed_starved(self, iteration: int) -> int:
        """Admission backpressure: shed arrived waiters that have been
        admission-blocked for longer than the plan's patience, attaching a
        retry-after hint, instead of livelocking behind eviction."""
        n = 0
        for r in list(self.waiting):
            if r.arrival > iteration or r.blocked_since is None:
                continue
            if iteration - r.blocked_since >= self.serve.admission_patience:
                self.cancel(r, status="shed", retry_after=self._retry_after())
                n += 1
        return n

    def _retry_after(self) -> float:
        """Seconds until admission plausibly unblocks: the earliest runner
        completion at the measured step rate, or one patience window when
        nothing is running (pure pool pressure)."""
        ms = self.step_ms if self.step_ms is not None else 1.0
        rem = [r.max_new_tokens - len(r.out) for r in self.running()]
        steps = min(rem) if rem else self.serve.admission_patience
        return max(steps, 1) * ms / 1e3

    # Aliases: the public serving surface is ServingEngine.submit/run/summary;
    # slab packing and growth are engine internals, also reachable here.
    slab_view = _slab_view
    slab_done = _slab_done

    # ------------------------------------------------------- rolled horizon
    def plan_rolled(self, iteration: int, cap: int):
        """Event horizon + block pre-reservation for one rolled dispatch.

        Returns ``(k, steps)``: the decode-iteration count the device may
        run before the host must intervene again, and the per-slot
        iteration budgets (B,) int32 — or ``(1, None)`` when the next
        host-required event is immediate, so the engine falls back to the
        ordinary K=1 mixed step transparently.

        What forces K=1 (each is host work the loop cannot do):

        * a mid-prefill slot — chunk packing / SLO throttling is host-side;
        * no runners — nothing to decode;
        * an arrival due next iteration, or pool pressure the reservation
          below cannot cover without evicting (the K=1 path owns eviction).

        The horizon itself is the distance to the next host event:

        * an **unarrived** waiter bounds it by ``arrival - iteration``
          (admission is a host event);
        * an **arrived-but-blocked** waiter (no free slot / pool too full
          now) bounds it by the earliest runner completion — a completion
          is exactly the admission opportunity it is waiting for;
        * otherwise every runner gets its own remaining generation budget
          and simply dies mid-span on device while the rest continue.

        Pre-reservation: each runner is granted blocks for its *whole*
        span before dispatch (positions up to ``lens + steps[b]``), so K
        iterations can never outgrow a block table mid-loop.  If the pool
        cannot cover the spans without eviction the horizon shrinks until
        it can; at k == 1 nothing is reserved and the caller falls back.
        """
        if cap <= 1 or self.prefilling():
            return 1, None
        runners = self.running()
        if not runners:
            return 1, None
        budgets = {r.rid: r.max_new_tokens - len(r.out) for r in runners}
        k = min(int(cap), max(budgets.values()))  # nobody can use more
        unarrived = [r.arrival for r in self.waiting if r.arrival > iteration]
        if unarrived:
            k = min(k, min(unarrived) - iteration)
        if any(r.arrival <= iteration for r in self.waiting):
            # an arrived waiter is blocked on slots/pool: the earliest
            # completion is its admission opportunity, stop there
            k = min(k, min(budgets.values()))

        def need(kk: int) -> dict:
            per = {}
            for r in runners:
                span = min(kk, budgets[r.rid])
                n = self._blocks_for(int(self.lens[r.slot]) + span)
                n -= len(r.blocks)
                if n > 0:
                    per[r.rid] = n
            return per

        while k > 1 and sum(need(k).values()) > self.alloc.available:
            k -= 1
        if k <= 1:
            return 1, None
        per = need(k)
        for r in runners:
            n = per.get(r.rid, 0)
            if n:
                got = self.alloc.alloc(n)  # covered: sum(per) <= available
                start = len(r.blocks)
                r.blocks.extend(got)
                self.table[r.slot, start : len(r.blocks)] = got
        steps = np.zeros((self.serve.decode_batch,), np.int32)
        for r in runners:
            steps[r.slot] = min(k, budgets[r.rid])
        return k, steps

    def _rolled_done(
        self,
        out: np.ndarray,
        steps: np.ndarray,
        span: Optional[tuple] = None,
    ) -> dict:
        """[internal] Consume one rolled dispatch: append each slot's span
        of sampled tokens, advance its length, retire exhausted requests and
        register newly-full blocks — the K=1 bookkeeping, span-sized.
        ``out[b, :steps[b]]`` are slot b's tokens in order; a -1 marks the
        first non-finite iteration (the rolled loop freezes the slot from
        there), so a truncated span is a quarantine — the slot keeps its
        last-good length and replays from it next dispatch."""
        now = time.perf_counter()
        c = {"generated": 0, "quarantined": 0, "poisoned": 0}
        for b, req in enumerate(self.slots):
            if req is None or steps[b] == 0:
                continue
            row = out[b, : int(steps[b])]
            neg = np.flatnonzero(row < 0)
            emit = [int(t) for t in (row[: neg[0]] if len(neg) else row)]
            if span is not None:
                self.obs.tracer.request_span(
                    "decode-span", req.rid, span[0], span[1],
                    {"k": int(steps[b]), "emitted": len(emit)},
                )
            self.lens[b] += len(emit)
            req.out.extend(emit)
            c["generated"] += len(emit)
            if emit:
                req.quarantine_streak = 0
            if len(neg):
                c["quarantined"] += 1
                if self._note_quarantine(req, now):
                    c["poisoned"] += 1
                    continue
            if req.done:
                self._finish(req, now)
            else:
                self._register_full_blocks(req, int(self.lens[b]))
        return c

    def _register_full_blocks(self, req: Request, n_written: int) -> None:
        """Index every newly *full* block of a live request.

        KV below ``n_written`` (accepted tokens only) is final: per-slot
        lengths are monotone, so a full block's pages never change again
        and its token run identifies them exactly."""
        if self.index is None:
            return
        n_full = n_written // self.serve.block_size
        if n_full <= req.registered:
            return
        toks = (req.prompt + req.out)[: n_full * self.serve.block_size]
        self.index.register(toks, req.blocks[:n_full])
        req.registered = n_full

    # -------------------------------------------------------------- decode
    def running(self) -> list[Request]:
        return [s for s in self.slots if s is not None and s.state == RUNNING]

    def prefilling(self) -> list[Request]:
        return [s for s in self.slots if s is not None and s.state == PREFILL]

    def _active(self) -> list[Request]:
        """Slot holders that own blocks (running *or* mid-prefill) — the
        eviction candidate pool."""
        return [
            s for s in self.slots if s is not None and s.state in (PREFILL, RUNNING)
        ]

    def _grow_for_decode(self, extra_rows: Optional[dict] = None) -> None:
        """[internal] Ensure every running slot has a block for the position
        it is about to write; when the pool runs dry a requester may only
        evict holders strictly *weaker* than itself (lower priority, then
        younger) — if there is none it preempts itself instead.  The most
        senior request therefore always keeps its pages and finishes (no
        eviction livelock).  Evicting a sharer releases only its exclusive
        blocks — a shared prefix stays resident for its co-owners, so a
        victim may free less than it holds.

        ``extra_rows`` ({rid: n}) covers speculative slots: a slot about to
        verify n draft rows writes KV at n positions past its real token,
        so its block run must reach that high-water mark *before* the step
        (rejected rows roll back the length only — the blocks stay)."""
        extra_rows = extra_rows or {}
        for req in sorted(self.running(), key=_seniority):
            if req.state != RUNNING:  # evicted as a victim earlier in this loop
                continue
            rows = 1 + int(extra_rows.get(req.rid, 0))
            need = self._blocks_for(int(self.lens[req.slot]) + rows) - len(req.blocks)
            while need > 0:
                got = self.alloc.alloc(need)
                if got is not None:
                    start = len(req.blocks)
                    req.blocks.extend(got)
                    self.table[req.slot, start : len(req.blocks)] = got
                    need = 0
                    break
                victims = sorted(self._active(), key=_seniority, reverse=True)
                victim = next(
                    (
                        v for v in victims
                        if v is not req and _seniority(v) > _seniority(req)
                    ),
                    None,
                )
                if victim is None:
                    if len(self._active()) == 1:
                        raise RuntimeError(
                            "KV pool exhausted by a single request; "
                            "raise n_blocks or lower max_new_tokens"
                        )
                    self.evict(req)  # yield to the elders
                    break
                self.evict(victim)

    grow_for_decode = _grow_for_decode  # back-compat alias (internal)

    def evict(self, req: Request) -> None:
        """Recompute-style preemption: back to the waiting queue from scratch.

        Blocks the victim shares with live co-owners are only dereferenced
        (eviction refuses to release pages somebody else still reads); on
        re-admission the prefix index may hand them straight back."""
        self._release(req)
        req.state, req.pos, req.out = WAITING, 0, []
        req.quarantine_streak = 0
        self.waiting.append(req)
        self.n_evictions += 1
        self.obs.on_evict(req, time.perf_counter())

    def _release(self, req: Request) -> None:
        for b in self.alloc.free(req.blocks):
            if self.index is not None:
                self.index.forget(b)
        req.blocks = []
        req.shared = 0
        req.registered = 0
        if req.slot >= 0:
            self.table[req.slot] = 0
            self.lens[req.slot] = 0
            self.slots[req.slot] = None
            req.slot = -1

    # ------------------------------------------------------------- queries
    @property
    def occupancy(self) -> float:
        return len(self._active()) / self.serve.decode_batch

    @property
    def idle(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)
