"""Speculative decoding: draft sources for the continuous-batching engine
(the port's ``repro/serve/speculative.py``).

A drafter proposes gamma continuation tokens per running slot; the engine
packs them, after the slot's real token, into the unified (B, W) slab as a
gamma+1-row verification chunk, and the ONE mixed step scores every row.
The host keeps the longest draft prefix matching the target's own greedy
argmax, so the emitted tokens are exactly those of plain decode: a draft
source changes speed, never tokens.  Rollback past rejected rows is the
per-slot length vector alone: the block table is untouched, and the stale
KV the dead rows wrote is masked by the attention kernel and overwritten
when the slot advances.

* :class:`NGramDraft` — prompt-lookup self-drafting: match the sequence's
  trailing n-gram against its own history and propose what followed it
  last time.  No second model, no device work.
* :class:`ModelDraft` — a model (any ``configs`` entry) with its *own*
  paged KV cache, block allocator and mixed step (the target engine's slab
  contract).  Slot state is keyed by request id and self-heals: each
  proposal round diffs the target's sequence against what the drafter has
  cached and rolls its length back to the common prefix, so eviction, slot
  reuse and rejected drafts need no invalidation protocol.

The draft depth is a plan decision (``ServePlan.spec_len``), not a drafter
property.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hardware import DEFAULT_HARDWARE, HardwareSpec
from repro_torch.core.plan import (
    ExecutionPlan,
    ServePlan,
    derive_execution_plan,
    derive_serve_plan,
)
from repro_torch.models.cache import init_paged_cache
from repro_torch.serve.engine import _tree_to, make_mixed_step
from repro_torch.serve.scheduler import BlockAllocator

Ask = tuple  # (rid, full token sequence so far, max drafts wanted)


def prompt_lookup(
    seq: Sequence[int], n: int, max_ngram: int = 3, min_ngram: int = 1
) -> list[int]:
    """Propose up to ``n`` tokens by copying what followed an earlier
    occurrence of the sequence's trailing n-gram.

    Longest n-gram first; within one n-gram length the *most recent*
    occurrence whose continuation has all ``n`` tokens wins (a match at the
    sequence tail can only contribute a truncated draft, so it is kept only
    as the fallback when no occurrence has a full window).  Returns [] when
    no n-gram down to ``min_ngram`` recurs."""
    L = len(seq)
    fallback: list[int] = []
    for m in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pat = tuple(seq[L - m :])
        # scan right-to-left, excluding the suffix occurrence itself
        for i in range(L - m - 1, -1, -1):
            if tuple(seq[i : i + m]) == pat:
                cont = list(seq[i + m : i + m + n])
                if len(cont) == n:
                    return cont
                if not fallback:
                    fallback = cont
    return fallback


class NGramDraft:
    """Prompt-lookup self-drafting (no second model, host-side only)."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.obs = None

    def bind_obs(self, obs) -> None:
        """Emit per-round draft counters into the engine's metrics."""
        self.obs = obs

    def propose(self, asks: list[Ask]) -> dict:
        out = {
            rid: prompt_lookup(seq, n, self.max_ngram, self.min_ngram)
            for rid, seq, n in asks
        }
        if self.obs is not None:
            self.obs.on_draft_round(self.name, len(asks), sum(len(d) for d in out.values()))
        return out


class ModelDraft:
    """Model drafting: a config runs greedy continuation on its own paged
    cache through its own mixed step.

    Proposal rounds are batched: every asking slot contributes rows to one
    (B, Wd) draft slab per call (catch-up chunks of tokens the drafter has
    not cached yet, and autoregressive draft rows), so a round costs
    ``ceil(max_catchup / Wd) + gamma - 1`` dispatches however many slots
    speculate.  ``dispatch_counts["draft_step"]`` counts them.  The
    drafter's step runs the kernels when ``serve.fused_attention`` (on the
    card), like the target's."""

    def __init__(
        self,
        params,
        cfg,
        plan: ExecutionPlan,
        serve: ServePlan,
        *,
        target_vocab: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg, self.plan, self.serve = cfg, plan, serve
        self.params = _tree_to(params, self.device)
        self.name = cfg.name
        self.target_vocab = target_vocab
        self.pools = init_paged_cache(cfg, plan, serve, self.device)
        self.alloc = BlockAllocator(serve.n_blocks)
        B = serve.decode_batch
        self.table = np.zeros((B, serve.max_blocks_per_seq), np.int32)
        self.blocks: list[list[int]] = [[] for _ in range(B)]
        self.toks: list[list[int]] = [[] for _ in range(B)]  # cached tokens
        self.rids: list[Optional[str]] = [None] * B
        self.dispatch_counts = {"draft_step": 0}
        self.obs = None
        # no chaos poison: drafts are proposals, and a non-finite drafter
        # only drafts tokens the target's verification rejects
        self._step = make_mixed_step(cfg, plan, serve, fused=serve.fused_attention)

    # ----------------------------------------------------------- slot state
    def _slot_for(self, rid: str, active: set) -> Optional[int]:
        """Slot of ``rid``, assigning (or stealing an inactive slot) on
        first sight.  At most ``decode_batch`` rids ask per round (they
        occupy target slots), so a steal always finds a victim."""
        if rid in self.rids:
            return self.rids.index(rid)
        for b, r in enumerate(self.rids):
            if r is None:
                self.rids[b] = rid
                return b
        for b, r in enumerate(self.rids):
            if r not in active:
                self._release(b)
                self.rids[b] = rid
                return b
        return None

    def _release(self, b: int) -> None:
        if self.blocks[b]:
            self.alloc.free(self.blocks[b])
        self.blocks[b] = []
        self.table[b] = 0
        self.toks[b] = []
        self.rids[b] = None

    def _ensure_blocks(self, b: int, n_tokens: int) -> bool:
        bs = self.serve.block_size
        need = -(-n_tokens // bs) - len(self.blocks[b])
        if need <= 0:
            return True
        got = self.alloc.alloc(need)
        if got is None:
            return False  # pool dry: stop drafting this slot, never evict
        start = len(self.blocks[b])
        self.blocks[b].extend(got)
        self.table[b, start : len(self.blocks[b])] = got
        return True

    # -------------------------------------------------------------- drafting
    def propose(self, asks: list[Ask]) -> dict:
        """{rid: [<= n draft tokens]} for each (rid, seq, n) ask.

        The drafter's cache is valid only up to the longest common prefix of
        what it cached and the sequence the target kept: rejected drafts,
        evictions and slot churn surface as a shorter prefix and cost only
        re-feeding."""
        if not asks:
            return {}
        n_dispatches = 0
        active = {rid for rid, _, _ in asks}
        W = self.serve.mixed_slab_width
        B = self.serve.decode_batch
        state = {}  # slot -> [pending rows to feed, drafts, want]
        for rid, seq, n in asks:
            b = self._slot_for(rid, active)
            if b is None:
                continue
            cached, p = self.toks[b], 0
            while p < min(len(cached), len(seq)) and cached[p] == seq[p]:
                p += 1
            # keep >= 1 token pending: drafting needs the argmax after seq's
            # last token, so it is fed again even when cached
            p = min(p, len(seq) - 1)
            self.toks[b] = cached[:p]  # rollback = length only, blocks stay
            state[b] = [list(seq[p:]), [], int(n)]
        while True:
            feeding = {}  # slot -> rows packed this call
            tokens = np.zeros((B, W), np.int32)
            tables = np.zeros_like(self.table)
            lens = np.zeros((B,), np.int32)
            kinds = np.zeros((B,), np.int32)
            for b, (pending, drafts, want) in state.items():
                if len(drafts) >= want:
                    continue
                rows = pending[:W] if pending else [drafts[-1]]
                if not self._ensure_blocks(b, len(self.toks[b]) + len(rows)):
                    state[b][2] = len(drafts)  # pool dry: freeze this slot
                    continue
                feeding[b] = rows
                tokens[b, : len(rows)] = rows
                tables[b] = self.table[b]
                lens[b] = len(self.toks[b])
                kinds[b] = len(rows)
            if not feeding:
                break
            tok, _, _ = self._step(self.params, self.pools, tokens, tables, lens, kinds)
            n_dispatches += 1
            self.dispatch_counts["draft_step"] += 1
            tok = tok.cpu().numpy()
            for b, rows in feeding.items():
                pending, drafts, want = state[b]
                self.toks[b].extend(rows)
                if pending:
                    del pending[: len(rows)]
                    if pending:
                        continue  # mid-catch-up argmax: discard
                t = int(tok[b])
                if self.target_vocab is not None and t >= self.target_vocab:
                    state[b][2] = len(drafts)  # unverifiable id: stop early
                    continue
                drafts.append(t)
        out = {
            self.rids[b]: drafts
            for b, (_, drafts, _) in state.items()
            if self.rids[b] is not None
        }
        if self.obs is not None:
            self.obs.on_draft_round(self.name, len(asks), sum(len(d) for d in out.values()),
                                    device_steps=n_dispatches)
        return out

    def bind_obs(self, obs) -> None:
        """Emit per-round draft counters (asks, drafted tokens, dispatches)
        into the engine's metrics."""
        self.obs = obs

    def summary(self) -> dict:
        return {
            "draft_model": self.name,
            "dispatches": dict(self.dispatch_counts),
            "serve_plan": self.serve.to_record(),
        }


def make_draft_source(
    name: Optional[str],
    target_cfg,
    target_serve: ServePlan,
    *,
    hw: HardwareSpec = DEFAULT_HARDWARE,
    params=None,
    seed: int = 0,
    reduced: bool = False,
    device="cuda",
    dtype=torch.float32,
):
    """The draft source named by a plan/CLI ``draft`` string.

    ``"none"``/None -> None, ``"ngram"`` -> :class:`NGramDraft`, anything
    else is a config name -> :class:`ModelDraft` with weights drawn by the
    port's ``init_params`` in ``dtype`` from a ``torch.Generator`` seeded
    ``seed`` (or ``params`` when the caller has weights: the *target's*
    params make it a self-drafting oracle, the acceptance upper bound).

    The drafter's execution plan is ``derive_execution_plan`` where the JAX
    source calls ``derive_plan`` (whose MM-tile search finds no tile for the
    H100's shared memory): the draft step reads only ``fuse_qkv`` and
    ``moe_dispatch`` from it, which both derive alike.  Its serve plan is
    the target's geometry (batch, blocks, chunk, slab, page dtype) for the
    draft config."""
    if name in (None, "", "none"):
        return None
    if name == "ngram":
        return NGramDraft()
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params

    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    plan = derive_execution_plan(cfg)
    serve_d = derive_serve_plan(
        cfg, {"data": 1, "model": 1}, hw,
        max_seq_len=target_serve.max_seq_len,
        decode_batch=target_serve.decode_batch,
        block_size=target_serve.block_size,
        prefill_chunk=target_serve.prefill_chunk,
        mixed_slab_width=target_serve.mixed_slab_width,
        # the target's page precision: a self-drafting oracle must score the
        # prefix through the same cache numerics or a near-tie argmax flips
        kv_dtype=target_serve.kv_dtype,
    )
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, plan, dtype, generator=gen, device=dev)
    return ModelDraft(params, cfg, plan, serve_d, target_vocab=target_cfg.vocab_size,
                      device=dev)
