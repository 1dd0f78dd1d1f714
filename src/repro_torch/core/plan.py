"""The CAT planner, copied from ``repro/core/plan.py``: ``derive_plan``
(the training and execution plan: stage modes, head sharding, remat,
microbatches, the mesh layout) and the serving half (``ServePlan`` /
``serve_feasible`` / ``derive_serve_plan``).  The parity tests hold both
against the JAX package field for field, on the same hardware numbers.

Two deliberate divergences (ROADMAP, "Deliberate divergences"):

* ``StagePlan`` carries no ``pu``: the JAX plan picks each stage's Pallas
  tile with ``core/pu.pick_pu``; the port's CUDA kernels choose their own
  tiles, and the tile search, sized for a TPU's VMEM, finds no feasible
  tile in the H100's shared memory.
* Factor1's one-shot engine MM: the JAX plan takes the LARGE member of
  ``derive_pu_family(hw)``; on a card with a hand-written MM kernel
  (``ONE_SHOT_MM_TILES``, the H100) it is that kernel's CTA tile, 128 x 128
  x 64 (``kernels/mm_pu/csrc/mm_pu.cu``).  On any other hardware (the TPU
  numbers the parity tests hand both packages) the search decides, as in JAX.

``derive_execution_plan`` is ``derive_plan`` on a 1 x 1 mesh with the
serving defaults (``training=False``), which the serving paths call.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core.hardware import DEFAULT_HARDWARE, VCK5000, HardwareSpec
from repro_torch.core.pu import derive_pu_family

# Paper constant: EDPU pipeline has at most 4 PRGs in flight per stage.
PRG_MAX_PIPELINE_DEPTH = 4

SPATIAL = "spatial"  # paper parallel mode (1): fully-pipelined, sliced fabric
TEMPORAL = "temporal"  # paper parallel mode (2): serial PRGs, each uses all chips

GRAD_COMPRESSION = ("none", "bf16", "int8")

# The CTA tile (block_m, block_n, block_k) of the port's tensor-core MM
# kernel (kernels/mm_pu/csrc/mm_pu.cu), by hardware name: Factor1's
# one-shot engine MM on that card.
H100_MM_CTA_TILE = (128, 128, 64)
ONE_SHOT_MM_TILES = {"h100": H100_MM_CTA_TILE, "h100-nvlink": H100_MM_CTA_TILE}

MESH1 = {"data": 1, "model": 1}


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Per-stage (MHA / FFN) decision record (JAX's, without ``pu``)."""

    mode: str  # SPATIAL | TEMPORAL
    factor1: float  # Eq.5/6 Factor1 analog (diagnostic, logged)
    factor2_bytes: int  # Eq.5/6 Factor2 analog: activation bytes/chip, no remat


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The derived accelerator instance for one (arch x mesh x shape)."""

    arch: str
    mesh_axes: tuple  # e.g. (("data", 16), ("model", 16)), sorted by name
    mha: StagePlan
    ffn: StagePlan
    # C5: Independent-Linear: one fused (q | k | v) projection matrix.
    fuse_qkv: bool
    # C4/P_ATB: attention-block parallel degree (heads consumed in parallel).
    p_atb: int
    # Head sharding degree over the model axis.
    head_shards: int
    # Activation checkpointing of each stacked pattern-group (Factor2').
    remat: bool
    # Gradient accumulation over this many microbatches (Factor2').
    microbatches: int
    # Embedding partition dim: "vocab" | "embed" | "replicated".
    embed_shard: str
    # MoE execution mode: "ep" (experts sharded) | "tp" (d_ff sharded) | "none".
    moe_mode: str
    # Sequence sharding for long-context cells (batch < data axis).
    seq_shard: bool
    # MoE dispatch algorithm: "gshard" grouped one-hot products | "sort".
    moe_dispatch: str = "gshard"
    # TEMPORAL mode folds the model axis into data parallelism.
    dp_over_model: bool = False
    # ZeRO/FSDP hybrid: weights and optimizer state also sharded over `data`.
    zero_weights: bool = False
    # Megatron-style sequence parallelism of the residual stream over `model`.
    seq_parallel_acts: bool = False
    # Pod-axis role: "data" (extra DP) or "pipeline" (stages over `pod`).
    pod_role: str = "data"
    # Gradient wire format: "none" | "bf16" | "int8".
    grad_compression: str = "none"

    @property
    def model_axis(self) -> int:
        return dict(self.mesh_axes).get("model", 1)

    @property
    def data_axis(self) -> int:
        return dict(self.mesh_axes).get("data", 1)

    @property
    def pod_axis(self) -> int:
        return dict(self.mesh_axes).get("pod", 1)

    def mode_for(self, stage: str) -> str:
        """Parallel mode the sharder executes for a stage ("mha" | "ffn"):
        every stage TEMPORAL when ``dp_over_model`` folds the model axis into
        data parallelism."""
        if self.dp_over_model:
            return TEMPORAL
        if stage == "mha":
            return self.mha.mode
        if stage == "ffn":
            return self.ffn.mode
        raise KeyError(f"unknown stage {stage!r}; expected 'mha' or 'ffn'")


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0 and cap % d == 0:
            return d
    return 1


def one_shot_mm(hw: HardwareSpec, dtype_bytes: int = 2) -> tuple:
    """(block_m, block_n, block_k) of the engine's one-shot MM, Factor1's
    denominator: the named CTA tile of the card's own MM kernel where
    ``ONE_SHOT_MM_TILES`` lists the hardware, else the LARGE member of the
    tile search (the JAX plan's rule)."""
    if hw.name in ONE_SHOT_MM_TILES:
        return ONE_SHOT_MM_TILES[hw.name]
    large = derive_pu_family(hw, dtype_bytes)["LARGE"]
    return large.block_m, large.block_n, large.block_k


def derive_plan(
    cfg,
    mesh_shape: Mapping[str, int],
    hw: HardwareSpec = DEFAULT_HARDWARE,
    *,
    batch: int = 8,
    seq_len: int = 2048,
    training: bool = True,
    fuse_qkv: Optional[bool] = None,
    force_mode: Optional[str] = None,
    pod_role: str = "data",
    dtype_bytes: int = 2,
    moe_dispatch: str = "gshard",
    seq_parallel: Optional[bool] = None,
    grad_compression: str = "none",
) -> ExecutionPlan:
    """Top-down derivation (paper section IV): hardware and model jointly
    decide.  ``repro/core/plan.py::derive_plan`` term for term, but for the
    stage tiles (``StagePlan.pu``) and the one-shot MM (``one_shot_mm``)."""
    if moe_dispatch not in ("gshard", "sort"):
        raise ValueError(f"moe_dispatch {moe_dispatch!r}: 'gshard' or 'sort'")
    if grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"grad_compression {grad_compression!r}: one of {GRAD_COMPRESSION}")
    ma = mesh_shape.get("model", 1)
    da = mesh_shape.get("data", 1)
    bm, bn, bk = one_shot_mm(hw, dtype_bytes)

    # ---- Eq.5 Factor1 (MHA): LB MM scale / engine one-shot MM scale. -------
    lb_mm_volume = 4.0 * seq_len * cfg.d_model * cfg.n_heads * cfg.d_head
    engine_volume = float(ma) * bm * bn * bk
    mha_factor1 = lb_mm_volume / engine_volume

    # ---- Eq.6 Factor1 (FFN). ------------------------------------------------
    ffn_volume = 2.0 * seq_len * cfg.d_model * cfg.d_ff
    ffn_factor1 = ffn_volume / engine_volume

    # ---- divisibility (needed by Factor2' and the mode decision). ----------
    heads_div = cfg.n_heads % ma == 0 and (cfg.n_kv_heads % ma == 0 or cfg.n_kv_heads < ma)
    ffn_shard_w = cfg.effective_ff_width()
    ffn_div = ffn_shard_w % ma == 0 and (ffn_shard_w // ma) >= hw.mxu_dim
    tp_feasible = heads_div and cfg.d_model % ma == 0

    # ---- Factor2': activation bytes per chip if nothing is rematerialized. --
    tokens = batch * seq_len
    tokens_per_chip = tokens / max(da, 1)
    width_frac = 1.0 / ma  # hidden sharded over model axis in SPATIAL mode
    qkv_width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    mha_act = tokens_per_chip * (cfg.d_model + qkv_width + cfg.n_heads * cfg.d_head)
    ffn_act = tokens_per_chip * (cfg.d_model + 2 * cfg.effective_ff_width())
    mha_factor2 = int(mha_act * dtype_bytes * width_frac * cfg.n_layers)
    ffn_factor2 = int(ffn_act * dtype_bytes * width_frac * cfg.n_layers)
    # the f32 attention probabilities, the big saved residual without remat
    attn_layers = sum(
        1 for i in range(cfg.n_layers) if cfg.layer_kind(i) in ("attn", "swa", "local")
    )
    eff_kv = min(seq_len, cfg.sliding_window or seq_len)
    probs = tokens_per_chip * eff_kv * cfg.n_heads * 4.0
    mha_factor2 += int(probs * attn_layers / (ma if tp_feasible else 1))

    # The batch folds over the model axis (TEMPORAL -> FSDP, no duplicate
    # compute) only when it divides the full dp extent.
    can_fold = batch % max(da * ma, 1) == 0 and batch >= da

    def decide(feasible: bool) -> str:
        if force_mode:
            return force_mode
        return SPATIAL if feasible else TEMPORAL

    mha_mode = decide(tp_feasible)
    ffn_mode = decide(ffn_div and cfg.d_model % ma == 0)

    # Eq.5/6: when the model's MM scale dwarfs the engine's one-shot scale
    # (Factor1 >= PRG depth) training takes mode (2), serial PRGs each using
    # all compute: the model axis folds into data parallelism.  MoE keeps its
    # spatial FFN.
    if (
        training
        and not cfg.is_moe
        and can_fold
        and force_mode is None
        and max(mha_factor1, ffn_factor1) >= PRG_MAX_PIPELINE_DEPTH
    ):
        mha_mode = TEMPORAL
        ffn_mode = TEMPORAL

    seq_shard = batch % max(da, 1) != 0 or batch < da
    dp_over_model = (
        mha_mode == TEMPORAL
        and ffn_mode == TEMPORAL
        and not seq_shard
        and batch % max(da * ma, 1) == 0
    )

    # ---- P_ATB (Eq.7/8): heads consumed in parallel per fused-QKV output. --
    head_shards = _largest_divisor_leq(cfg.n_heads, ma) if mha_mode == SPATIAL else 1
    if cfg.n_heads % max(head_shards, 1):
        head_shards = 1
    p_atb = max(1, cfg.n_heads // max(head_shards, 1))

    # ---- Factor2' outcome: ZeRO weights + remat + microbatches. -------------
    # Optimizer state (~12 B a parameter training, the weights serving)
    # sharded over the model axis only can exceed device memory: shard the
    # complementary weight dim over `data` too (ZeRO/FSDP hybrid).
    bytes_per_param = 12.0 if training else float(dtype_bytes)
    param_bytes_model_only = cfg.param_count() * bytes_per_param / ma
    zero_weights = param_bytes_model_only > (0.35 if training else 1.0) * hw.hbm_bytes
    param_bytes = param_bytes_model_only / (da if zero_weights else 1)
    act_budget = max(hw.hbm_bytes - param_bytes, hw.hbm_bytes * 0.25)
    total_act = mha_factor2 + ffn_factor2
    remat = training and total_act > 0.25 * act_budget
    # Megatron-SP stays opt-in (``seq_parallel=``) and engages only where the
    # manual path runs: every projection column/row-shards evenly and the
    # sequence splits over the model axis.
    sp_feasible = (
        ma > 1
        and not cfg.is_moe
        and not cfg.enc_dec
        and all(k in ("attn", "swa", "local") for k in cfg.layer_pattern)
        and mha_mode == SPATIAL
        and ffn_mode == SPATIAL
        and cfg.n_heads % ma == 0
        and cfg.n_kv_heads % ma == 0
        and seq_len % ma == 0
        and cfg.effective_ff_width() % ma == 0
        and not seq_shard
        and not zero_weights  # the manual ring assumes whole column/row shards
    )
    seq_parallel_acts = bool(seq_parallel) and sp_feasible
    if seq_parallel_acts:
        # the ring needs per-projection column shards: a fused (q|k|v)
        # column split would hand each rank a q/k/v mix
        fuse_qkv = False
    saved_per_layer = tokens_per_chip * cfg.d_model * dtype_bytes
    resid = saved_per_layer * cfg.n_layers
    # the per-microbatch global batch must stay divisible by the DP extent
    dp_total = da * (ma if dp_over_model else 1)
    micro_cap = max(1, batch // max(dp_total, 1))
    microbatches = 1
    while (
        training
        and resid / microbatches > 0.5 * act_budget
        and microbatches * 2 <= micro_cap
        and batch % (microbatches * 2) == 0
    ):
        microbatches *= 2

    # Pipeline pods need the pipe full: the GPipe bubble is (S-1)/(M+S-1), so
    # raise M to the largest batch divisor <= 4 S whose microbatch still
    # folds over the data axis (an unfillable pipe fails loudly in
    # check_pipeline_supported instead).
    pa = mesh_shape.get("pod", 1)
    if training and pod_role == "pipeline" and pa > 1:
        for cand in range(min(batch, 4 * pa), microbatches, -1):
            if batch % cand == 0 and cand >= pa and (batch // cand) % max(da, 1) == 0:
                microbatches = cand
                break

    # ---- Embedding + MoE + sequence sharding. -------------------------------
    if cfg.vocab_size % ma == 0:
        embed_shard = "vocab"
    elif cfg.d_model % ma == 0:
        embed_shard = "embed"
    else:
        embed_shard = "replicated"
    if cfg.n_experts > 1:
        if cfg.n_experts % ma == 0:
            moe_mode = "ep"
        elif cfg.moe_d_ff % ma == 0 and cfg.moe_d_ff // ma >= hw.mxu_dim:
            moe_mode = "tp"
        else:
            moe_mode = "none"
    else:
        moe_mode = "none"
    if fuse_qkv is None:
        fuse_qkv = cfg.fused_qkv_ok()

    return ExecutionPlan(
        arch=cfg.name,
        mesh_axes=tuple(sorted(mesh_shape.items())),
        mha=StagePlan(mha_mode, mha_factor1, mha_factor2),
        ffn=StagePlan(ffn_mode, ffn_factor1, ffn_factor2),
        fuse_qkv=bool(fuse_qkv),
        p_atb=p_atb,
        head_shards=head_shards,
        remat=remat,
        microbatches=max(1, microbatches),
        embed_shard=embed_shard,
        moe_mode=moe_mode,
        moe_dispatch=moe_dispatch,
        seq_shard=seq_shard,
        dp_over_model=dp_over_model,
        zero_weights=zero_weights,
        seq_parallel_acts=seq_parallel_acts,
        pod_role=pod_role,
        grad_compression=grad_compression,
    )


def derive_execution_plan(cfg, fuse_qkv: Optional[bool] = None, *,
                          moe_dispatch: str = "gshard", training: bool = False,
                          batch: int = 8, seq_len: int = 2048,
                          hw: HardwareSpec = DEFAULT_HARDWARE, dtype_bytes: int = 2,
                          grad_compression: str = "none") -> ExecutionPlan:
    """``derive_plan`` on a 1 x 1 mesh, serving by default: ``fuse_qkv``
    wherever the arch has attention unless the caller decides, the dispatch
    the caller names ("gshard" by default, the JAX serving launcher's);
    with ``training``, remat and microbatches for ``batch`` x ``seq_len``
    tokens on ``hw``."""
    return derive_plan(cfg, MESH1, hw, batch=batch, seq_len=seq_len, training=training,
                       fuse_qkv=fuse_qkv, dtype_bytes=dtype_bytes, moe_dispatch=moe_dispatch,
                       grad_compression=grad_compression)


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Derived serving configuration for one (arch x mesh x hardware).

    Frozen + hashable so it can ride as a static argument of the jitted
    prefill/decode steps exactly like :class:`ExecutionPlan`.
    """

    arch: str
    # Concurrent decode slots (the engine's static decode batch).
    decode_batch: int
    # Paged KV cache geometry: tokens per block / pool blocks per attention
    # layer / table width per request.  Block 0 is the trash block (writes
    # from idle slots land there), so the allocatable pool is n_blocks - 1.
    block_size: int
    n_blocks: int
    max_blocks_per_seq: int
    # KV page dtype: "bf16" | "int8" | "fp32" (int8 reuses
    # train/compression.quantize on a per-token, per-head grid).
    kv_dtype: str
    # Tokens per prefill chunk (derivation target for the mixed-slab width).
    prefill_chunk: int
    # Serving context bound: block tables cover exactly this many positions.
    max_seq_len: int
    # Width of the unified mixed prefill/decode slab: every slot owns this
    # many query rows per step (decode uses 1, a prefill chunk up to all of
    # them).  Wider slabs prefill faster but pay dead rows while decoding.
    mixed_slab_width: int = 1
    # KV pages streamed into one VMEM tile per kernel grid step (the fused
    # paged-attention kernel's tile height), from the VMEM budget.  Derived
    # exactly as the JAX plan derives it; the port's CUDA kernel does not
    # read it: its CUDA-core entry (f32 and int8 pages) tiles by 32 keys, its
    # bf16 tensor-core entry by 64.
    pages_per_tile: int = 1
    # Attention engine of the unified step: the fused paged-attention
    # kernel (True) vs the dense gather-then-attend fallback (False).  The
    # roofline charges the fallback its gather bytes, so this knob feeds the
    # decode-batch derivation too.
    fused_attention: bool = True
    # Rolled on-device decode loop: max decode iterations per host dispatch
    # (K).  One host round-trip costs ``hw.dispatch_overhead_s`` regardless
    # of how much work it launches — the CAT/EA4RCA communication-avoiding
    # argument — so at small decode batch (steps are short, overhead is a
    # large fraction) the engine rolls K sampling+repack+length-advance
    # iterations into ONE ``lax.while_loop`` dispatch.  Derived so the
    # dispatch overhead amortizes below ~10% of the rolled span; 1 disables
    # rolling (every step is a host round-trip, the pre-rolled contract).
    # The scheduler still chooses the *actual* K per dispatch from the
    # event horizon (next admission/prefill/speculation/growth boundary),
    # bounded above by this plan cap.
    rolled_steps: int = 1
    # Speculative decoding: draft depth per decode slot (gamma).  A
    # speculating slot submits spec_len drafted tokens + its real one as
    # gamma+1 slab rows — mechanically a prefill chunk — and the host keeps
    # the longest draft prefix matching the step's greedy argmax.  0 = off.
    # Derived from the roofline's compute-vs-bandwidth slack: decode is
    # bandwidth-bound, so the MXU has (machine_balance / decode_batch) rows
    # of free compute per slot before verification itself would go
    # compute-bound (then gamma stays 0).  Always <= mixed_slab_width - 1.
    spec_len: int = 0
    # Draft source label: "none" | "ngram" (prompt-lookup self-drafting) |
    # a config name (model drafting, e.g. "smollm-135m").  The engine takes
    # the actual DraftSource object; the plan records the decision.
    draft: str = "none"
    # Copy-on-write prefix sharing: the scheduler keeps a radix index over
    # resident token prefixes and admits prefix-hit requests with shared
    # (refcounted) blocks + only the divergent tail as prefill.  Greedy
    # outputs are byte-identical either way (KV pages are a pure function
    # of the token prefix); the knob exists for A/B accounting and as the
    # escape hatch, not because sharing changes results.
    prefix_sharing: bool = True
    # Fleet-default TTFT target (ms) that shaped this plan, when one did:
    # the derivation widens the mixed slab so a typical prompt prefils
    # within the target and reins in gamma (draft rows compete with prompt
    # chunks for slab width).  Per-request targets on ``Request.slo_ttft_ms``
    # drive the scheduler's runtime chunk sizing; this field records the
    # planning-time decision.  None = throughput-shaped plan.
    slo_ttft_ms: Optional[float] = None
    # --- robustness knobs (fault-tolerance ladder; see docs/ROBUSTNESS.md) ---
    # Fleet-default wall-clock deadline (ms from submit) after which a
    # request is cancelled and its blocks/radix refs released; per-request
    # ``Request.deadline_ms`` overrides.  None = no deadline.
    deadline_ms: Optional[float] = None
    # Transient-dispatch retries per ladder rung before stepping down
    # rolled-K -> K=1 mixed -> eager gather fallback (then giving up).
    retry_limit: int = 3
    # Base for the exponential retry backoff: sleep backoff * 2^(attempt-1)
    # seconds (capped at 0.25 s) between retries.  Tests set it to 0.
    retry_backoff_s: float = 0.001
    # Consecutive healthy dispatches before the engine climbs one rung
    # back up the ladder.
    ladder_recovery: int = 32
    # Iterations an *arrived* request may sit admission-blocked (pool or
    # slot saturation) before it is shed with a retry-after hint, instead
    # of livelocking behind eviction.
    admission_patience: int = 128
    # Consecutive no-progress engine iterations (no tokens, no admission,
    # no completion) before ``run()`` raises StallError carrying health().
    stall_limit: int = 256
    # Consecutive quarantined (non-finite logits) steps for one slot before
    # the request is cancelled as poisoned rather than replayed again.
    quarantine_limit: int = 8
    # Diagnostics (logged + dryrun records).
    kv_bytes_per_token: int = 0
    hbm_kv_budget_bytes: int = 0

    @property
    def max_concurrency(self) -> int:
        """Requests the block pool can hold at full context length."""
        return (self.n_blocks - 1) // self.max_blocks_per_seq

    def describe(self) -> str:
        return (
            f"serve plan for {self.arch}: decode_batch={self.decode_batch} "
            f"block_size={self.block_size} n_blocks={self.n_blocks} "
            f"kv_dtype={self.kv_dtype} prefill_chunk={self.prefill_chunk} "
            f"slab={self.mixed_slab_width} pages/tile={self.pages_per_tile} "
            f"fused={self.fused_attention} rolled_steps={self.rolled_steps} "
            f"spec_len={self.spec_len} "
            f"draft={self.draft} prefix_sharing={self.prefix_sharing} "
            f"slo_ttft_ms={self.slo_ttft_ms} max_seq={self.max_seq_len} "
            f"kv_bytes/token={self.kv_bytes_per_token}"
        )

    def to_record(self) -> dict:
        """Flat dict for dryrun / benchmark JSON records."""
        return {
            "decode_batch": self.decode_batch,
            "block_size": self.block_size,
            "n_blocks": self.n_blocks,
            "max_blocks_per_seq": self.max_blocks_per_seq,
            "kv_dtype": self.kv_dtype,
            "prefill_chunk": self.prefill_chunk,
            "mixed_slab_width": self.mixed_slab_width,
            "pages_per_tile": self.pages_per_tile,
            "fused_attention": self.fused_attention,
            "rolled_steps": self.rolled_steps,
            "spec_len": self.spec_len,
            "draft": self.draft,
            "prefix_sharing": self.prefix_sharing,
            "slo_ttft_ms": self.slo_ttft_ms,
            "deadline_ms": self.deadline_ms,
            "retry_limit": self.retry_limit,
            "retry_backoff_s": self.retry_backoff_s,
            "ladder_recovery": self.ladder_recovery,
            "admission_patience": self.admission_patience,
            "stall_limit": self.stall_limit,
            "quarantine_limit": self.quarantine_limit,
            "max_seq_len": self.max_seq_len,
            "kv_bytes_per_token": self.kv_bytes_per_token,
        }


def serve_feasible(cfg) -> tuple[bool, str]:
    """Can the continuous-batching engine host this arch?

    The paged path needs per-slot positions (rope/none) and a pure-attention
    layer stack (recurrent state is O(1)/request and needs no paging; those
    archs stay on the eager ``greedy_generate`` path for now).
    """
    if cfg.enc_dec or cfg.frontend != "none":
        return False, "enc-dec/frontend archs keep non-stack state"
    if not all(k in ("attn", "swa", "local") for k in cfg.layer_pattern):
        return False, f"layer pattern {cfg.layer_pattern} has recurrent blocks"
    if cfg.pos_embedding not in ("rope", "none"):
        return False, f"pos_embedding={cfg.pos_embedding} needs scalar offsets"
    if not cfg.causal or cfg.encoder_only:
        return False, "serving needs a causal decoder"
    return True, ""


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def largest_divisor_of(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1).  Unlike
    :func:`_largest_divisor_leq` it puts no divisibility demand on ``cap``."""
    for d in range(min(n, max(cap, 1)), 0, -1):
        if n % d == 0:
            return d
    return 1


def derive_serve_plan(
    cfg,
    mesh_shape: Mapping[str, int],
    hw: HardwareSpec = DEFAULT_HARDWARE,
    *,
    max_seq_len: int = 2048,
    decode_batch: Optional[int] = None,
    block_size: Optional[int] = None,
    kv_dtype: Optional[str] = None,
    prefill_chunk: Optional[int] = None,
    mixed_slab_width: Optional[int] = None,
    pages_per_tile: Optional[int] = None,
    fused_attention: bool = True,
    rolled_steps: Optional[int] = None,
    spec_len: Optional[int] = None,
    draft: str = "none",
    slack_blocks: int = 0,
    oversubscribe: float = 1.0,
    prefix_sharing: bool = True,
    slo_ttft_ms: Optional[float] = None,
    typical_prompt_len: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    retry_limit: int = 3,
    retry_backoff_s: float = 0.001,
    ladder_recovery: int = 32,
    admission_patience: int = 128,
    stall_limit: int = 256,
    quarantine_limit: int = 8,
) -> ServePlan:
    """Pick decode batch / block size / KV dtype from the roofline model.

    * **decode batch** — decode is weight-streaming-bound; batching tokens
      amortizes the weight read until compute catches up at the machine
      balance point (Eq.4 analog): B* ~= machine_balance x bytes/param / 2.
      Capped by the HBM KV budget at full context.  With the fused
      paged-attention kernel each slot's HBM traffic is just its own pages
      read once; the gather fallback instead writes *and* re-reads a dense
      ``max_seq_len``-long cache per slot per step, so its per-slot byte tax
      (2 x ``max_seq_len`` x kv_bytes/token) stops the batch from amortizing
      the weight stream long before the balance point — the fallback batch
      is additionally capped at weight_bytes / gather_tax.  The fused
      kernel's plan simply drops that term.
    * **KV dtype** — bf16 unless the bf16 pool cannot hold the
      roofline-preferred batch at ``max_seq_len``; then the paper's Int8
      deployment grid halves the page bytes (C2's precision knob applied to
      the cache instead of the weights).
    * **block size** — one MXU sublane tile (``mxu_dim // 8``) so a page
      feeds the MM PU without re-tiling; never wider than the context.
    * **mixed-slab width** — query rows per slot in the unified step;
      defaults to ``prefill_chunk`` (prefill keeps its compute-bound chunk,
      decode slots carry the dead rows — the explicit latency/throughput
      trade, overridable).
    * **pages per VMEM tile** — the fused kernel double-buffers k+v page
      tiles in VMEM; the tile height is the largest block-table divisor
      whose tiles fit an eighth of the chip's VMEM (the rest holds q, the
      accumulator and the output block).
    * **rolled decode steps (K cap)** — how many decode iterations one host
      dispatch should carry.  A dispatch costs ``hw.dispatch_overhead_s``
      no matter how much it launches, while one decode step is
      weight-stream-bound (~ weight_bytes / hbm_bandwidth); the overhead
      fraction is therefore ``overhead / (K x step)``.  K is the smallest
      power of two holding that fraction under ~10% (1 when a single step
      already amortizes it — big models — and capped at 32: past that the
      host loses admission/completion responsiveness for < 0.4% more).  A
      TTFT target additionally caps K so a rolled span cannot blockade an
      arriving prompt past ~a quarter of its budget.
    * **speculative draft depth (gamma)** — the joint-constraint answer to
      "how many draft rows per slot can verification absorb for free":
      decode at batch B is bandwidth-bound (B below the machine balance
      point), so one weight stream amortizes ``machine_balance / B`` query
      rows per slot before the MXU goes compute-bound.  gamma+1 must stay
      within that slack *and* within the slab width, else gamma drops to 0
      (verification must never slow the step it is trying to speed up).
      Only derived when a ``draft`` source is named; explicit ``spec_len``
      overrides (still clamped to the slab).
    * **SLO feedback** — a fleet TTFT target (``slo_ttft_ms``) feeds back
      into the slab and gamma: steps are weight-stream-bound (>=
      weight_bytes / hbm_bandwidth each), so the target fixes a step
      budget, the slab widens until ``typical_prompt_len`` prefils inside
      it, and gamma is reined in to ``slack // 2 - 1`` (draft rows compete
      with prompt chunks for slab width).  Per-request targets
      (``Request.slo_ttft_ms``) additionally drive runtime chunk sizing in
      the scheduler against *measured* step times.

    ``oversubscribe`` scales the block pool relative to the worst case
    (every slot at ``max_seq_len``).  At the default 1.0 the pool can host
    every admitted request to full context, so derived plans are
    *eviction-free by construction* — the scheduler's eviction path only
    engages when an operator oversubscribes (< 1.0) to trade KV memory for
    admission capacity, betting that most requests stop early.
    """
    ok, reason = serve_feasible(cfg)
    if not ok:
        raise ValueError(f"no serve plan for {cfg.name}: {reason}")
    ma = mesh_shape.get("model", 1)
    n_attn = sum(
        1 for i in range(cfg.n_layers) if cfg.layer_kind(i) in ("attn", "swa", "local")
    )
    weight_bytes = cfg.param_count() * 2.0 / max(ma, 1)
    kv_budget = int(max(hw.hbm_bytes - weight_bytes, 0.1 * hw.hbm_bytes))

    def per_token(dtype: str) -> int:
        b = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
        tok = n_attn * 2 * cfg.n_kv_heads * cfg.d_head * b
        if dtype == "int8":  # per-(token, head) fp32 scale rides along
            tok += n_attn * 2 * cfg.n_kv_heads * 4
        return tok

    # Roofline batch: tokens per step needed to amortize the weight stream.
    # A degenerate device with no off-chip bandwidth reports an infinite
    # machine balance (nothing amortizes); clamp so the int() below is total
    # — the KV-capacity cap then decides the batch alone.
    balance = min(hw.machine_balance_bf16, 2.0**20)
    ridge = max(1, int(balance * 2.0 / (2.0 * max(ma, 1))))
    if kv_dtype is None:
        want = decode_batch or _pow2_floor(ridge)
        fits_bf16 = want * max_seq_len * per_token("bf16") <= kv_budget
        kv_dtype = "bf16" if fits_bf16 else "int8"
    kv_tok = per_token(kv_dtype)
    cap = max(1, kv_budget // max(max_seq_len * kv_tok, 1))
    if not fused_attention:
        # Gather-bytes term (fallback only): every slot drags a dense
        # write+read of its full-context cache through HBM each step.
        gather_tax = 2.0 * max_seq_len * kv_tok
        cap = max(1, min(cap, int(weight_bytes / max(gather_tax, 1.0))))
    if decode_batch is None:
        decode_batch = max(1, min(_pow2_floor(ridge), _pow2_floor(cap)))
    if block_size is None:
        block_size = max(8, hw.mxu_dim // 8)
    block_size = min(block_size, max_seq_len)
    max_blocks_per_seq = -(-max_seq_len // block_size)  # ceil
    pool = max(max_blocks_per_seq, int(decode_batch * max_blocks_per_seq * oversubscribe))
    n_blocks = 1 + pool + slack_blocks  # +1: block 0 is trash
    if prefill_chunk is None:
        prefill_chunk = min(max_seq_len, max(block_size, 256))
    if mixed_slab_width is None:
        mixed_slab_width = prefill_chunk
    if slo_ttft_ms is not None:
        # TTFT feedback (same joint-constraint style as the decode batch):
        # decode steps are weight-stream-bound, so one step costs at least
        # weight_bytes / hbm_bandwidth — that bounds how many steps fit in
        # the TTFT budget, and a typical prompt must prefill within them.
        # Widen the slab until it does (never narrow a wider request).
        est_step_s = weight_bytes / max(hw.hbm_bandwidth, 1.0)
        steps_budget = max(1, int((slo_ttft_ms / 1e3) / max(est_step_s, 1e-12)))
        need = -(-int(typical_prompt_len or max_seq_len) // steps_budget)
        mixed_slab_width = max(int(mixed_slab_width), need)
    mixed_slab_width = max(1, min(mixed_slab_width, max_seq_len))
    if pages_per_tile is None:
        # one pool page in VMEM: (block_size, n_kv_heads, d_head) values
        # (+ a (block_size, n_kv_heads, 1) fp32 scale for int8 pages)
        page_bytes = block_size * cfg.n_kv_heads * (
            cfg.d_head * {"fp32": 4, "bf16": 2, "int8": 1}[kv_dtype]
            + (4 if kv_dtype == "int8" else 0)
        )
        tile_cap = max(1, (hw.vmem_bytes // 8) // max(2 * page_bytes, 1))
        pages_per_tile = largest_divisor_of(max_blocks_per_seq, tile_cap)
    if rolled_steps is None:
        # Dispatch-overhead slack: one decode step streams the weights once
        # (est_step_s); the host round-trip costs dispatch_overhead_s on
        # top.  Roll K steps per dispatch until the overhead fraction
        # overhead / (K * step) drops under ~10%.
        est_step_s = weight_bytes / max(hw.hbm_bandwidth, 1.0)
        rolled_steps = 1
        while (
            hw.dispatch_overhead_s > 0.1 * rolled_steps * max(est_step_s, 1e-12)
            and rolled_steps < 32
        ):
            rolled_steps *= 2
        if slo_ttft_ms is not None:
            # an arriving prompt waits out the in-flight rolled span before
            # its first prefill chunk: keep that wait under ~1/4 of the
            # TTFT budget so rolling never blows the very target the plan
            # was shaped for
            step_budget = max(
                1, int((slo_ttft_ms / 4e3) / max(est_step_s, 1e-12))
            )
            rolled_steps = min(rolled_steps, _pow2_floor(step_budget))
    rolled_steps = max(1, int(rolled_steps))
    if spec_len is None:
        if draft == "none":
            spec_len = 0
        else:
            # Compute slack per decode slot: the weight stream takes
            # weight_bytes / bw while one verified row costs
            # decode_batch * 2P/ma flops across the batch — both scale the
            # same way with TP, so slack rows/slot = machine_balance / B.
            # gamma+1 <= slack keeps verification bandwidth-bound; the -1
            # converts rows to drafts, and the cap of 8 bounds the verify
            # logits width (diminishing returns far before the slab does).
            slack = min(hw.machine_balance_bf16, 2.0**20) / max(int(decode_batch), 1)
            spec_len = max(0, min(int(slack) - 1, 8))
    if slo_ttft_ms is not None:
        # Under a TTFT target draft rows compete with prompt chunks for the
        # slab and lengthen the very steps the target budgets, so gamma only
        # keeps the slack it can *halve*: rein it in to slack//2 - 1 (0 when
        # the roofline slack is thin).
        slack = min(hw.machine_balance_bf16, 2.0**20) / max(int(decode_batch), 1)
        spec_len = min(int(spec_len), max(0, int(slack) // 2 - 1))
    spec_len = max(0, min(int(spec_len), int(mixed_slab_width) - 1))
    return ServePlan(
        arch=cfg.name,
        decode_batch=int(decode_batch),
        block_size=int(block_size),
        n_blocks=int(n_blocks),
        max_blocks_per_seq=int(max_blocks_per_seq),
        kv_dtype=kv_dtype,
        prefill_chunk=int(prefill_chunk),
        mixed_slab_width=int(mixed_slab_width),
        pages_per_tile=int(pages_per_tile),
        fused_attention=bool(fused_attention),
        rolled_steps=int(rolled_steps),
        spec_len=int(spec_len),
        draft=str(draft),
        prefix_sharing=bool(prefix_sharing),
        slo_ttft_ms=None if slo_ttft_ms is None else float(slo_ttft_ms),
        deadline_ms=None if deadline_ms is None else float(deadline_ms),
        retry_limit=int(retry_limit),
        retry_backoff_s=float(retry_backoff_s),
        ladder_recovery=int(ladder_recovery),
        admission_patience=int(admission_patience),
        stall_limit=int(stall_limit),
        quarantine_limit=int(quarantine_limit),
        max_seq_len=int(max_seq_len),
        kv_bytes_per_token=int(kv_tok),
        hbm_kv_budget_bytes=kv_budget,
    )


# ---------------------------------------------------------------------------
# Paper §V.B design case, on the paper's own hardware numbers (a copy of
# JAX's).
# ---------------------------------------------------------------------------
def design_case_vck5000(seq_len: int = 256, d_model: int = 768, d_ff: int = 3072,
                        n_heads: int = 12) -> dict:
    """Reproduce the BERT-Base walk-through: Factor1 ~= 1.5, Factor2 ~= 7.56 MB,
    P_ATB = 4, fully-pipelined mode selected (paper §V.B)."""
    plio_aie, mmsz, total_aie = 4, 64, 400
    engine = (total_aie // plio_aie**2) * (plio_aie * mmsz) ** 3
    factor1 = 4 * seq_len * d_model**2 / engine
    d_head = d_model // n_heads
    buf = (
        seq_len * 256 * 3  # QKV LB output cache (int8 paper accounting)
        + seq_len * d_head * 4 * 4  # ATB in/out cache
        + 128 * seq_len * 4  # ATB attention cache
        + seq_len * 256 * 4  # ATB KV cache
        + seq_len * d_model + seq_len * 256  # Proj LB in/out
        + d_model * d_model * 4 + d_model * d_ff * 2  # weight cache
    )
    p_atb = 256 // d_head  # QKV LB emits 256-wide tiles; one head needs d_head
    mode = (
        SPATIAL
        if factor1 < PRG_MAX_PIPELINE_DEPTH and buf <= VCK5000.vmem_bytes
        else TEMPORAL
    )
    return {
        "factor1": factor1,
        "factor2_bytes": buf,
        "factor2_mb": buf / 2**20,
        "p_atb": p_atb,
        "mode": mode,
        "prg_max_pipeline_depth": PRG_MAX_PIPELINE_DEPTH,
        "buffer_budget_mb": VCK5000.vmem_bytes / 2**20,
    }
