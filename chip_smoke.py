"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the repository around it (it imports ``src/
repro_torch``); without either it exits non-zero and prints no result.  It
builds the five CUDA kernels from the checkout (one ``nvcc`` per source,
in parallel), holds each against its plain PyTorch version at the main
paths' shapes, drives both serving paths at full width and depth (random
weights from a seed) on a dense, a recurrent and an MoE arch, and the int8
FFN stage at full width, checks the outputs, times the kernels, and
prints:

* the card's name and power limit (``nvidia-smi``);
* one JSON line ``{"kernels": [...]}`` (times, launches on the main paths,
  byte/operation bound, plain-version and library times);
* last, ``{"ok": true, "device": {...}}``.

Phases: 1 setup + build; the continuous-batching path of qwen3-1.7b over
the paged-attention kernels: 2 kernels vs plain version (the JAX test's
cases on the CUDA-core entry and each with bf16 q and pages on the
tensor-core entry, the rows-per-CTA sweep and the SWA dead-page check on
both, decode contexts that span several key splits), 3 full-depth f32
serving with the kernel vs the gather path (identical tokens), 4 bf16
serving on the derived H100 plan (a main path whose launches are counted),
5 rolled decode loop (K=4 vs K=1), 6 kernel vs plain version at the derived
plan's decode and mixed shapes (256 slots x 256 rows), and kernel timing;
the eager path (``greedy_generate``): 7 WKV kernels vs plain version (the
JAX test's shapes, chunks, strong decay, a ragged S, the state carry and a
state passed in, in f32 on the CUDA-core entry and each in bf16 on the
tensor-core entry; the rwkv6-1.6b prefill shape) and its times, 8
flash-attention kernels vs plain version
(the JAX test's cases in f32, which runs on CUDA cores, and each in bf16,
which runs on tensor cores; fused-QKV views, the qwen3-1.7b prefill shape)
and their times, 9 rwkv6-1.6b and 10 qwen3-1.7b served eagerly in bf16
(main paths whose launches are counted), 11 kernel path vs plain path in
f32 (identical tokens), 12 the continuous engine vs ``greedy_generate``
(identical tokens); 13 the RMSNorm kernel vs its plain version (the JAX
test's cases, every model width, sub-warp rows at ragged row counts,
strided qk views, the main paths' rows and the continuous slab's q and k
views) and its times; 14 the MM PU kernels vs their plain version (the JAX test's
shapes, activations, int8 dequant, random shapes; bf16 x with bf16 and
int8 w at the same shapes, split K included, on tensor cores); 15 the int8
FFN stage at qwen3-1.7b width (three ``mm_pu`` launches; its launch plans,
T=256 ``w2`` split across K) and its times; then qwen3-moe-30b-a3b (48
layers, 128 experts top-8, 60.4 GB of bf16 weights): 16 paged attention
with int8 pages (the CUDA-core entry, G 8) vs its plain version at the
derived plan's decode and mixed shapes (128 slots x 256 rows) and its
times, and the flash and RMSNorm kernels vs their plain versions at its
head shapes (H 32, KH 4: flash at phase 19's prefill on fused-QKV views
and contiguous copies, qk-norm on the q and k views of phase 18's slab
and phase 19's prefill); 17 the MoE functions at full width (gshard vs sort drop-free at T
4096; gshard at the slab's T 32,768 and capacity 1.25 vs a float64
recomputation of the same routing, the same choices kept; one layer's
parts timed); 18 the MoE main path: the multi-tenant trace (8 classify, 4
chat, 2 summarize, 2 tenants) served by ``ServingEngine`` at full width
and depth on the derived plan, its first dispatch held kernel path vs
plain path (one ``ServingEngine.step`` each, the plain path dispatching
the kernel path's routing; every layer's router inputs and the final rows
within the bf16 tolerance);
19 the same weights through ``greedy_generate`` (B 4 x 1024,
8 new tokens), then 4 layers in f32, drop-free, kernel vs gather path
(identical tokens); then speculation and hardening on qwen3-1.7b: 20
paged attention at speculative verify rows (q_len 2-8 on decode slots:
the tensor-core entry's decode-item route at the derived plan's shape,
causal edges on key-split boundaries, the split scheme emulated there; the
CUDA-core entry with f32 and int8 pages at G 8) and its times at 256 slots
x q_len 5; 21(a) f32 at full depth (untied head), a self-drafting
``ModelDraft`` at gamma 4 against the non-speculative engine (identical
tokens); 21(b) the speculative main path: bf16 on the derived plan, n-gram
drafting at gamma 4 on a ``make_trace`` replay with tracing on (the Chrome
trace validated, the Prometheus text round-tripped, the drift meter's
measured/predicted ratio per phase) against the same stream without
speculation; 22 a chaos run (transient bursts, NaN poison, pool pressure,
latency spikes from one seed) that walks the ladder to the gather rung
and back with the clean run's tokens, and a snapshot restored on a fresh
engine.  Every main path (phases 3-5, 9-11, 18-19, 21-22) checks the
exact launch count of every kernel: the paged or eager-prefill kernel once
a layer, the RMSNorm kernel once a norm per forward (113 on qwen3-1.7b,
193 on qwen3-moe-30b-a3b, none on rwkv6's LayerNorm; a draft model's
forwards count too), and no kernel at all on a plain path (or the gather
rung).  Planted controls (a dropped key tile, a window one
key wider, int8 pages read without their scales, MoE queue ranks counted
over the whole T instead of per group, P rounded once to bf16 instead of
split into hi + lo, in flash and in paged attention, a key split left out
of paged attention's combine, the WKV's cross-chunk term dropped, its
diagonal halves' per-element weights dropped, or its operands rounded
once to TF32 (logged if it passes), the norm's ``1 + scale`` or mean
changed, a dropped K slice, a per-row scale, the causal edge between
verify rows dropped) show that the tolerances
reject a wrong kernel.  Kernel times are medians over batches
of back-to-back calls (``time_ms``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

# qwen3-moe-30b-a3b's main path peaks within ~4.5 GiB of the card's 79 GiB;
# expandable segments keep the caching allocator's split blocks from
# taking that headroom (read when CUDA first allocates)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}  # dense tensor, f32 CUDA-core
SERVE_ARCH = "qwen3-1.7b"
RWKV_ARCH = "rwkv6-1.6b"
MESH1 = {"data": 1, "model": 1}
# The eager main paths: B 8 prompts of 2048 tokens, 32 new tokens each.
EAGER_B, EAGER_PROMPT, EAGER_GEN = 8, 2048, 32
# The continuous main path's slab on the derived H100 plan: 256 slots x 256 rows.
SLAB_ROWS = 256 * 256


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAILED: {msg}")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- inputs
def make_inputs(B, W, H, KH, D, bs, MB, kv_dtype, lens, q_lens, *, q_dtype=torch.float32,
                seed=0, dev="cuda"):
    """Random pools, block tables drawn from a shuffled pool, per-slot
    lens/q_lens given.  kv_dtype: float32 | bfloat16 | int8."""
    from repro_torch.models.cache import _kv_vec_scale, _quantize_int8

    g = torch.Generator(device=dev).manual_seed(seed)
    N = 1 + B * MB
    q = torch.randn((B, W, H, D), generator=g, device=dev).to(q_dtype)
    k = torch.randn((N, bs, KH, D), generator=g, device=dev)
    v = torch.randn((N, bs, KH, D), generator=g, device=dev)
    if kv_dtype == "int8":
        sk, sv = _kv_vec_scale(k), _kv_vec_scale(v)
        entry = {"k": _quantize_int8(k, sk), "v": _quantize_int8(v, sv),
                 "k_scale": sk, "v_scale": sv}
    else:
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[kv_dtype]
        entry = {"k": k.to(dt), "v": v.to(dt)}
    del k, v
    lens = np.asarray(lens, np.int32)
    q_lens = np.asarray(q_lens, np.int32)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, N, dtype=np.int32))
    table = np.zeros((B, MB), np.int32)
    for b in range(B):
        if q_lens[b] == 0:
            continue
        nb = -(-(int(lens[b]) + W) // bs)
        nb = min(nb, MB)
        table[b, :nb] = perm[b * MB: b * MB + nb]
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return q, entry, t(table), t(lens), t(q_lens)


# The six cases of the JAX kernel test (tests/test_kernels_paged_attention.py)
SMALL_CASES = [
    # (B, W, H, KH, D, bs, MB, kv_dtype, window)
    (3, 1, 4, 2, 32, 4, 8, "float32", 0),
    (3, 4, 4, 2, 32, 4, 8, "float32", 0),
    (2, 8, 2, 1, 64, 8, 16, "bfloat16", 0),
    (2, 4, 4, 2, 32, 4, 16, "int8", 0),
    (3, 4, 2, 2, 32, 4, 16, "float32", 12),
    (2, 1, 4, 1, 64, 8, 8, "int8", 20),
]
# Tolerances as (atol, rtol): |got - want| <= atol + rtol * |want| for every
# element.  f32 output (f32 q): the JAX test's 2e-5, whatever the pages;
# int8 pages dequantize exactly in f32 on both sides, and for bf16 pages
# the plain version is given q rounded to bf16 as the kernel rounds it.
# bf16 output (bf16 q, the main path): both sides compute in f32 and round
# once to bf16, so they may differ by one bf16 step, 2^-7 of the value; the
# atol covers the f32 disagreement before that rounding at outputs near 0.
F32_TOL = (2e-5, 2e-5)
BF16_TOL = (1e-4, 2.0**-7)


def tolerance(q_dtype):
    return BF16_TOL if q_dtype == torch.bfloat16 else F32_TOL


def small_case_lens(B, W, bs, MB, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, MB * bs - W, B)
    q_lens = rng.integers(1, W + 1, B)
    lens[0], q_lens[0] = 0, 0  # an empty slot on the trash block
    return lens, q_lens


def main_path_lens(B, W, n_prefill, seed, max_ctx=2048, q_len=1):
    """Slots 0..n_prefill-1 prefill up to W rows, the rest decode ``q_len``
    (1, or gamma + 1 verify rows); contexts up to max_ctx."""
    rng = np.random.default_rng(seed)
    q_lens = np.full(B, q_len, np.int64)
    q_lens[:n_prefill] = rng.integers(1, W + 1, n_prefill)
    lens = np.array([rng.integers(0, max_ctx - int(q)) for q in q_lens])
    return lens, q_lens


# ---------------------------------------------------------------- phase 2
def plain(args, *, bs, window=0):
    """The plain version on the kernel's inputs.  With bf16 pages and f32 q
    the kernel rounds q to bf16 before the dot (as the TPU kernel does), so
    the plain version is given the same rounded q."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    q, entry, table, lens, q_lens = args
    if q.dtype == torch.float32 and entry["k"].dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    return paged_attention_ref(q, entry, table, lens, q_lens, block_size=bs, window=window)


def within(got, want, tol):
    """(every element within tol, max abs error, share of elements outside)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    out = diff > atol + rtol * want.float().abs()
    return not bool(out.any()), float(diff.max()), float(out.float().mean())


def compare(name, args, *, bs, window, rows_per_cta=0):
    """Kernel vs plain version on ``args``; fails on any element outside the
    tolerance or any dead row that is not exactly 0.  Returns (kernel
    output, plain output, max abs error)."""
    from repro_torch.kernels.paged_attention import ops

    q, entry, table, lens, q_lens = args
    got = ops.paged_attention(q, entry, table, lens, q_lens, block_size=bs, window=window,
                              rows_per_cta=rows_per_cta)
    torch.cuda.synchronize()
    want = plain(args, bs=bs, window=window)
    tol = tolerance(q.dtype)
    ok, err, _ = within(got, want, tol)
    dead = torch.arange(q.shape[1], device=q.device)[None] >= q_lens[:, None]
    dead_ok = bool((got[dead] == 0).all())
    log(f"  {name}: max_abs_err={err:.3g} tol(atol, rtol)={tol} dead_rows_zero={dead_ok} "
        f"{'ok' if ok and dead_ok else 'MISMATCH'}")
    check(ok and dead_ok, f"kernel disagrees with the plain version on {name}")
    return got, want, err


def planted(name, control, want, tol):
    """A control: ``control`` is what a kernel with a planted bug would give;
    the tolerance must reject it."""
    ok, err, share = within(control, want, tol)
    log(f"  control {name}: max_abs_err={err:.3g}, {share:.2%} of elements outside "
        f"the tolerance: {'rejected' if not ok else 'ACCEPTED'}")
    check(not ok, f"the tolerance accepts the planted control '{name}'")


def drop_last_tile(args, *, bs, tile=32):
    """The plain version with the last 32-key tile of every slot's context
    left out: what a kernel that skipped its final tile would give."""
    from repro_torch.kernels.paged_attention.ref import masked_attention, paged_mask
    from repro_torch.models.cache import paged_gather

    q, entry, table, lens, q_lens = args
    k, v = paged_gather(entry, table, bs)
    valid = paged_mask(lens, q_lens, q.shape[1], k.shape[1])
    cut = (lens.long() + q_lens.long() - 1).clamp(min=0) // tile * tile
    valid &= torch.arange(k.shape[1], device=q.device)[None, None] < cut[:, None, None]
    return masked_attention(q, k, v, valid).to(q.dtype)


def split_controls(cfg):
    """The tensor-core entry's two planted controls, on decode slots whose
    contexts span several key splits: its scheme emulated
    (``ref.paged_attention_split_ref``) with P rounded once to bf16, and
    with one split left out of the combine, must both be rejected; the
    scheme itself, P as hi + lo, must pass."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_split_ref

    H, KH, D, bs, MB, B = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 128, 8
    rng = np.random.default_rng(30)
    lens, q_lens = rng.integers(1200, 2000, B), np.ones(B, np.int64)
    args = make_inputs(B, 1, H, KH, D, bs, MB, "bfloat16", lens, q_lens,
                       q_dtype=torch.bfloat16, seed=30)
    _, want, _ = compare(f"decode B={B} contexts 1200-2000 bf16 ({ops.SPLIT}-key splits)", args,
                         bs=bs, window=0)
    scheme = lambda **kw: paged_attention_split_ref(*args, block_size=bs,  # noqa: E731
                                                    split=ops.SPLIT, **kw)
    ok, err, _ = within(scheme(), want, BF16_TOL)
    log(f"  scheme emulated (P as hi + lo): max_abs_err={err:.3g} {'ok' if ok else 'MISMATCH'}")
    check(ok, "the emulated split scheme disagrees with the plain version")
    planted("P rounded once to bf16 (no hi + lo split)", scheme(p_split=False), want, BF16_TOL)
    planted("split 2 (keys 1024-1535) left out of the combine", scheme(drop_split=2), want,
            BF16_TOL)


def phase_kernels(cfg):
    log("phase 2: kernels vs plain version on the card")
    errs = []
    # the JAX test's six cases as they are (f32 and int8 pages: the CUDA-core
    # entry), then each with bf16 q and pages (the tensor-core entry)
    for n, (B, W, H, KH, D, bs, MB, kv, window) in enumerate(SMALL_CASES):
        lens, q_lens = small_case_lens(B, W, bs, MB, seed=n)
        for kv_, qdt in ((kv, torch.float32), ("bfloat16", torch.bfloat16)):
            args = make_inputs(B, W, H, KH, D, bs, MB, kv_, lens, q_lens, q_dtype=qdt, seed=n)
            errs.append(compare(f"case{n} {kv_} pages, {str(qdt)[6:]} q, W={W} window={window}",
                                args, bs=bs, window=window)[2])
    # the schedule knob changes nothing: rows per CUDA block (the CUDA
    # analogue of the TPU kernel's pages_per_tile sweep), on both entries
    lens, q_lens = small_case_lens(2, 40, 4, 32, seed=7)
    for kv, qdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = make_inputs(2, 40, 4, 2, 32, 4, 32, kv, lens, q_lens, q_dtype=qdt, seed=7)
        outs = [compare(f"sweep {kv} rows_per_cta={r}", args, bs=4, window=0, rows_per_cta=r)[0]
                for r in (1, 2, 4, 32)]
        spread = max(float((o.float() - outs[0].float()).abs().max()) for o in outs)
        log(f"  sweep {kv} spread={spread:.3g}")
        check(spread <= 1e-6, "rows_per_cta changes the numbers")
    # pages wholly below the window are never read: corrupting them is inert
    for kv, qdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        q, entry, _, _, _ = make_inputs(1, 1, 2, 1, 32, 4, 8, kv, [0], [1], q_dtype=qdt, seed=8)
        table = (torch.arange(8, dtype=torch.int32, device="cuda") + 1)[None]
        lens = torch.tensor([28], dtype=torch.int32, device="cuda")
        q_lens = torch.tensor([1], dtype=torch.int32, device="cuda")
        base = compare(f"swa clean {kv}", (q, entry, table, lens, q_lens), bs=4, window=8)[0]
        smashed = {"k": entry["k"].clone(), "v": entry["v"].clone()}
        smashed["k"][1:4], smashed["v"][1:4] = 1e3, -1e3
        got = compare(f"swa corrupted dead pages {kv}", (q, smashed, table, lens, q_lens), bs=4,
                      window=8)[0]
        check(float((got.float() - base.float()).abs().max()) <= 1e-6,
              "dead pages below the window leaked")
    split_controls(cfg)

    # the main path's shapes: qwen3-1.7b heads, 16-token blocks, a 256-row slab
    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    main_cases = [
        ("main f32 pages", 8, "float32", torch.float32, 0),
        ("main bf16 pages", 16, "bfloat16", torch.bfloat16, 0),
        ("main int8 pages", 16, "int8", torch.bfloat16, 0),
        ("main bf16 swa=512", 16, "bfloat16", torch.bfloat16, 512),
    ]
    for n, (name, B, kv, qdt, window) in enumerate(main_cases):
        lens, q_lens = main_path_lens(B, W, n_prefill=B // 4, seed=20 + n)
        q_lens[-1] = 0  # one idle slot
        args = make_inputs(B, W, H, KH, D, bs, MB, kv, lens, q_lens, q_dtype=qdt, seed=20 + n)
        _, want, err = compare(name, args, bs=bs, window=window)
        errs.append(err)
        if window:  # the window boundary one key off must not pass
            planted(f"window {window + 1} instead of {window}",
                    plain(args, bs=bs, window=window + 1), want, tolerance(qdt))
        del args, want
        torch.cuda.empty_cache()
    return max(errs)


# ---------------------------------------------------------------- serving
def serve_once(cfg, plan, serve, params, reqs, *, fused):
    """One engine run; every launch count is set to 0 just before and read
    just after.  With the kernels, each device iteration launches the paged
    kernel once a layer and the RMSNorm kernel once a norm; the gather path
    (``fused=False``) launches none.  Returns (tokens, counts, summary,
    finished requests)."""
    from repro_torch.serve import ServingEngine

    engine = ServingEngine(params, cfg, plan, serve, fused=fused, device="cuda")
    reset_counts()  # count this run's launches only
    out = engine.run(reqs)
    counts = read_counts()
    summary = engine.summary()
    steps = summary["steps"]
    want = (expect_counts(paged_attention=cfg.n_layers * steps,
                          rmsnorm=norms_per_forward(cfg) * steps) if fused else expect_counts())
    check(counts == want, f"launches {counts}, expected {want} ({steps} device iterations, "
          f"fused={fused})")
    finished = engine.sched.finished
    del engine
    torch.cuda.empty_cache()
    return out, counts, summary, finished


def describe(tag, s):
    log(f"  {tag}: {s['generated_tokens']} tokens, {s['prefill_tokens']} prompt rows, "
        f"{s['dispatches']} dispatches ({s['steps']} device iterations), wall "
        f"{s['wall_s']:.3f} s, {s['tok_per_s']:.1f} tok/s, mean dispatch "
        f"{s['mean_dispatch_ms']:.2f} ms, slab slot-iterations {s['slab']}, "
        f"rolled {s['rolled']}")


def phase_parity(cfg, plan):
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.serve import random_stream
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params

    log(f"phase 3: {cfg.name} full depth, f32 weights + pages, kernel vs gather path")
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048, decode_batch=8,
                              kv_dtype="fp32", rolled_steps=1)
    log(f"  {serve.describe()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.float32, generator=gen, device="cuda")
    reqs = lambda: random_stream(cfg, 8, (100, 600), 16, stagger=2, seed=1)  # noqa: E731
    fused, counts, s1, _ = serve_once(cfg, plan, serve, params, reqs(), fused=True)
    describe("kernel", s1)
    gather, _, s2, _ = serve_once(cfg, plan, serve, params, reqs(), fused=False)
    describe("gather", s2)
    check(len(fused) == 8 and all(len(t) == 16 for t in fused.values()), "requests unfinished")
    same = fused == gather
    first_diff = next((r for r in fused if fused[r] != gather[r]), None)
    log(f"  greedy tokens identical: {same} (first differing request: {first_diff})")
    check(same, "kernel and gather paths disagree on greedy tokens")
    log(f"  kernel path launches {counts} over {s1['steps']} steps "
        f"({cfg.n_layers} paged, {norms_per_forward(cfg)} rmsnorm a step); gather path: none")
    del params
    torch.cuda.empty_cache()


def phase_served(cfg, plan):
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.serve import random_stream
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params

    log(f"phase 4 (main path): {cfg.name} bf16 weights + pages on the derived H100 plan")
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048)
    log(f"  {serve.describe()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.bfloat16, generator=gen, device="cuda")
    reqs = random_stream(cfg, 64, (100, 600), 16, stagger=1, seed=3)
    torch.cuda.reset_peak_memory_stats()
    out, counts, s, _ = serve_once(cfg, plan, serve, params, reqs, fused=True)
    describe("served", s)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(s["requests"]["finished"] == 64 and len(out) == 64, "not every request finished")
    check(all(len(t) == 16 and all(0 <= x < cfg.vocab_size for x in t) for t in out.values()),
          "a request emitted a token outside the vocab or too few tokens")
    check(s["requests"]["shed"] == 0, "requests were shed")
    # the engine quarantines (and replays) a slot whose logits are not finite
    check(s["faults"]["quarantines"] == 0, "non-finite logits")
    # per device iteration (mixed step or rolled one): one paged launch a
    # layer, one RMSNorm launch a norm (serve_once checked the counts)
    check(s["steps"] > 0, "no device iteration ran")
    log(f"  kernel launches on the main path: {counts} ({s['steps']} device iterations)")
    del params
    torch.cuda.empty_cache()
    return counts, s


def phase_rolled(cfg_full, plan):
    import dataclasses

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params
    from repro_torch.serve import random_stream

    cfg = dataclasses.replace(cfg_full, n_layers=2)
    log(f"phase 5: rolled decode loop, {cfg.n_layers} layers at full width, K=4 vs K=1")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.float32, generator=gen, device="cuda")
    base = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048, decode_batch=8,
                             kv_dtype="fp32")
    runs = {}
    for k in (4, 1):
        serve = dataclasses.replace(base, rolled_steps=k)
        reqs = random_stream(cfg, 8, (100, 600), 16, stagger=2, seed=1)
        runs[k], _, s, _ = serve_once(cfg, plan, serve, params, reqs, fused=True)
        describe(f"K={k}", s)
        if k == 4:
            check(s["rolled"]["dispatches"] >= 1 and
                  s["rolled"]["rolled_steps"] > s["rolled"]["dispatches"],
                  "the rolled loop never ran a multi-iteration span")
    check(runs[4] == runs[1], "rolled K=4 tokens differ from K=1")
    log("  K=4 tokens identical to K=1: True")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- timing
def time_ms(fn, reps=25, warmup=3):
    """Median ms of one call of ``fn``: ``reps`` batches of back-to-back
    calls (as many as take about 1 ms, at least one) between two CUDA
    events, so that the card does not idle between the calls it times."""
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    n = max(1, min(100, int(1.0 / max(a.elapsed_time(b), 1e-3))))
    ts = []
    for _ in range(reps):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return float(np.median(ts))


def bound(q, entry, lens, q_lens, window):
    """Least time for the function on an H100 SXM: bytes each input must be
    read once and the output written once (live K/V pages per kv head,
    live q rows, the whole output) at 3.35 TB/s, vs the QK and PV flops
    these rows need at the peak rate of their type."""
    B, W, H, D = q.shape
    KH = entry["k"].shape[2]
    # int8 pages carry one f32 scale per (token, kv head)
    kv_bytes = entry["k"].element_size() + (4 / D if "k_scale" in entry else 0)
    lens, q_lens = lens.cpu().numpy().astype(np.int64), q_lens.cpu().numpy().astype(np.int64)
    keys = flops = rows = 0
    for b in range(B):
        if q_lens[b] == 0:
            continue
        ctx = lens[b] + q_lens[b]
        lo = max(0, lens[b] - window + 1) if window else 0
        keys += ctx - lo
        rows += q_lens[b]
        pos = lens[b] + np.arange(q_lens[b])
        seen = pos + 1 - (np.maximum(0, pos - window + 1) if window else 0)
        flops += 4 * D * H * int(seen.sum())
    nbytes = (keys * KH * D * 2 * kv_bytes + rows * H * D * q.element_size()
              + q.numel() * q.element_size() + 3 * B * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["bf16" if q.dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, entry, table, lens, q_lens, bs):
    """One PyTorch yardstick for the same function: gather the pages, then
    scaled_dot_product_attention with the per-slot causal mask.  Timed
    only; the port never calls it."""
    from repro_torch.models.cache import paged_gather

    B, W, H, D = q.shape
    mb = int(((lens + q_lens).max().item() + bs - 1) // bs)
    k, v = paged_gather(entry, table, bs, mb)
    k, v = k.to(q.dtype).transpose(1, 2), v.to(q.dtype).transpose(1, 2)
    pos = lens[:, None] + torch.arange(W, device=q.device)[None]
    mask = torch.arange(k.shape[2], device=q.device)[None, None] <= pos[:, :, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask[:, None],
                                          enable_gqa=True)


def unscaled(args, *, bs):
    """The plain version with int8 pages read without their per-token
    scales: what a kernel that dropped the dequantization would give."""
    q, entry, table, lens, q_lens = args
    ones = {"k_scale": torch.ones_like(entry["k_scale"]),
            "v_scale": torch.ones_like(entry["v_scale"])}
    return plain((q, {**entry, **ones}, table, lens, q_lens), bs=bs)


def phase_times(cfg, name, B, n_prefill, seed, kv="bfloat16", q_len=1):
    """Kernel vs plain version at one of the main path's shapes (the derived
    plan's B slots x 256-row slab, B x 128 blocks of ``kv`` pages, decode
    slots with ``q_len`` rows), then times.  Planted controls: decode rows
    with a slot's last 32-key tile dropped; int8 pages read without their
    scales."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    lens, q_lens = main_path_lens(B, W, n_prefill, seed, q_len=q_len)
    args = make_inputs(B, W, H, KH, D, bs, MB, kv, lens, q_lens,
                       q_dtype=torch.bfloat16, seed=seed)
    q, entry, table, lens_t, q_lens_t = args
    before = ops.LAUNCHES
    pages = {"bfloat16": "bf16", "int8": "int8"}[kv]
    _, want, err = compare(f"{name} B={B} {pages} pages ({ops.ENTRIES[q.dtype, entry['k'].dtype]})",
                           args, bs=bs, window=0)
    if n_prefill == 0:  # decode rows: skipping a slot's last 32-key tile must not pass
        planted("last 32-key tile dropped", drop_last_tile(args, bs=bs), want, BF16_TOL)
    if kv == "int8":
        planted("int8 pages without their per-token scales", unscaled(args, bs=bs), want,
                BF16_TOL)
    del want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ops.paged_attention(q, entry, table, lens_t, q_lens_t, block_size=bs))
    ops.LAUNCHES = before  # checking and timing launches are not main-path launches
    plain_ms = time_ms(lambda: paged_attention_ref(q, entry, table, lens_t, q_lens_t,
                                                   block_size=bs), reps=5, warmup=1)
    torch.cuda.empty_cache()
    lib_ms = time_ms(lambda: library_call(q, entry, table, lens_t, q_lens_t, bs), reps=10,
                     warmup=2)
    b_ms, b_by = bound(q, entry, lens_t, q_lens_t, 0)
    log(f"  {name}: B={B} W={W} H={H} KH={KH} D={D} {pages} pages, {n_prefill} prefill "
        f"slots, q_len {q_len} a decode slot, live keys/slot mean "
        f"{float((lens + q_lens).mean()):.0f}: kernel {ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of roofline), plain {plain_ms:.3f} ms, "
        f"gather+SDPA {lib_ms:.3f} ms")
    del args, q, entry
    torch.cuda.empty_cache()
    return err, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms}


# ---------------------------------------------------------------- WKV
def kernel_ops() -> dict:
    """Each kernel's wrapper module, which holds its LAUNCHES count."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.mm_pu import ops as mm_pu
    from repro_torch.kernels.paged_attention import ops as paged
    from repro_torch.kernels.rmsnorm import ops as rmsnorm
    from repro_torch.kernels.rwkv6 import ops as wkv

    return {"paged_attention": paged, "wkv": wkv, "flash_attention": flash, "rmsnorm": rmsnorm,
            "mm_pu": mm_pu}


def expect_counts(**launches) -> dict:
    """Every kernel's expected launch count: those given, 0 for the rest."""
    return {name: launches.get(name, 0) for name in kernel_ops()}


def norms_per_forward(cfg) -> int:
    """RMSNorm launches of one forward: each layer's two norms, qk-norm's
    two, and the final norm (4 x 28 + 1 = 113 on qwen3-1.7b); none for a
    LayerNorm arch."""
    if cfg.norm != "rmsnorm":
        return 0
    return (2 + 2 * int(cfg.qk_norm)) * cfg.n_layers + 1


def reset_counts() -> None:
    for m in kernel_ops().values():
        m.LAUNCHES = 0


def read_counts() -> dict:
    return {name: m.LAUNCHES for name, m in kernel_ops().items()}


def rel_err(got, want) -> float:
    """The JAX WKV test's measure: max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-9))


def wkv_inputs(B, S, H, D, *, dtype=torch.float32, decay=(0.45, 0.95), seed=0):
    """r/k/v (dtype), w in ``decay`` (f32), u (f32) as the JAX test draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype) for _ in range(3))
    lo, hi = decay
    w = torch.sigmoid(torch.randn((B, S, H, D), generator=g, device="cuda")) * (hi - lo) + lo
    u = torch.randn((H, D), generator=g, device="cuda") * 0.1
    return r, k, v, w, u


# Tolerances of the JAX WKV test (relative to the largest output): 1e-5,
# 1e-4 under strong decay.  Both sides compute in f32 from the same inputs.
WKV_TOL, WKV_STRONG_TOL = 1e-5, 1e-4


def wkv_check(name, args, tol, *, chunk=32, state=None, scan=False):
    """Kernel vs plain version (``wkv_chunked`` at the same chunk, and for
    small shapes the sequential ``wkv_scan_ref`` too), output and final
    state.  Returns (kernel output, plain output, max abs error)."""
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.models.rwkv6 import wkv_chunked, wkv_scan_ref

    got, s_got = ops.wkv(*args, chunk=chunk, state=state, return_state=True)
    torch.cuda.synchronize()
    want, s_want = wkv_chunked(*args, chunk=chunk, state=state, return_state=True)
    errs = {"out": rel_err(got, want), "state": rel_err(s_got, s_want)}
    if scan:
        errs["vs scan"] = rel_err(got, wkv_scan_ref(*args))
    finite = bool(torch.isfinite(got).all() and torch.isfinite(s_got).all())
    ok = finite and all(e < tol for e in errs.values())
    abs_err = float((got - want).abs().max())
    log(f"  {name}: rel err {', '.join(f'{k} {v:.3g}' for k, v in errs.items())} "
        f"(tol {tol}), max abs {abs_err:.3g}, finite={finite} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"WKV kernel disagrees with the plain version on {name}")
    return got, want, abs_err


def wkv_no_carry(r, k, v, w, u, c=32):
    """The plain version with every chunk started from a zero state: what a
    kernel that dropped the cross-chunk term (and the carry) would give."""
    from repro_torch.models.rwkv6 import wkv_chunked

    S = r.shape[1]
    return torch.cat([wkv_chunked(r[:, i:i + c], k[:, i:i + c], v[:, i:i + c], w[:, i:i + c],
                                  u, chunk=c) for i in range(0, S, c)], dim=1)


def wkv_bound(r, H, D):
    """Least time for the prefill's WKV on an H100 SXM: r/k/v (their type),
    w and the output (f32), u and the final state (f32), each once, at 3.35
    TB/s, vs the recurrence's ~6 D^2 flops per token and head at the rate of
    the entry r's type selects: bf16 runs them on the tensor cores as 3xTF32
    (three TF32 products each, so a third of the TF32 peak), f32 on the CUDA
    cores.  Returns (bound ms, what bounds it, the byte bound ms, the
    operation bound ms, the operation bound ms at the f32 CUDA-core peak)."""
    B, S = r.shape[:2]
    n = B * S * H * D
    nbytes = 3 * n * r.element_size() + 4 * n + 4 * n + 4 * H * D + 4 * B * H * D * D
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    flops = 6 * D * D * B * S * H
    rate = PEAK_FLOPS["tf32"] / 3 if r.dtype == torch.bfloat16 else PEAK_FLOPS["fp32"]
    t_ops, t_f32 = flops / rate * 1e3, flops / PEAK_FLOPS["fp32"] * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound + (t_bytes, t_ops, t_f32)


def wkv_cases(dtype, tag):
    """The JAX WKV test's cases (tests/test_kernels_rwkv6.py: shapes, chunks,
    strong decay), a ragged S, the state carry and a state passed in, with
    r/k/v in ``dtype`` (the entry it selects: ``tag``).  Returns the max
    abs errors."""
    from repro_torch.kernels.rwkv6 import ops

    errs = []
    for n, shape in enumerate([(2, 128, 2, 32), (1, 96, 3, 64), (1, 256, 1, 64)]):
        errs.append(wkv_check(f"{tag} shape {shape}", wkv_inputs(*shape, dtype=dtype, seed=n),
                              WKV_TOL, scan=True)[2])
    for c in ops.CHUNKS:
        errs.append(wkv_check(f"{tag} chunk {c}", wkv_inputs(1, 128, 2, 32, dtype=dtype, seed=3),
                              WKV_TOL, chunk=c, scan=True)[2])
    errs.append(wkv_check(f"{tag} strong decay w in [0.001, 0.01]",
                          wkv_inputs(1, 128, 2, 32, dtype=dtype, decay=(0.001, 0.01), seed=4),
                          WKV_STRONG_TOL, scan=True)[2])
    errs.append(wkv_check(f"{tag} ragged S=100 (last chunk padded)",
                          wkv_inputs(2, 100, 2, 64, dtype=dtype, seed=5), WKV_TOL, scan=True)[2])
    # the state carry: two halves with the state passed on equal the whole
    r, k, v, w, u = wkv_inputs(1, 128, 2, 64, dtype=dtype, seed=6)
    full, s_full = ops.wkv(r, k, v, w, u, return_state=True)
    h1, st = ops.wkv(r[:, :64].contiguous(), k[:, :64].contiguous(), v[:, :64].contiguous(),
                     w[:, :64].contiguous(), u, return_state=True)
    h2, s2 = ops.wkv(r[:, 64:].contiguous(), k[:, 64:].contiguous(), v[:, 64:].contiguous(),
                     w[:, 64:].contiguous(), u, state=st, return_state=True)
    e = max(rel_err(torch.cat([h1, h2], dim=1), full), rel_err(s2, s_full))
    log(f"  {tag} state carry: halves vs whole rel err {e:.3g}")
    check(e < WKV_TOL, f"the WKV state carry ({tag}) does not continue where it left off")
    errs.append(wkv_check(f"{tag} state passed in",
                          (r[:, 64:].contiguous(), k[:, 64:].contiguous(), v[:, 64:].contiguous(),
                           w[:, 64:].contiguous(), u), WKV_TOL, state=st)[2])
    return errs


def wkv_control(name, got, want, tol, *, may_pass=False):
    """A planted control must fall outside ``tol``; with ``may_pass`` one
    that passes is logged as such instead of failing the run."""
    e = rel_err(got, want)
    verdict = "rejected" if e >= tol else ("PASSES (logged)" if may_pass else "ACCEPTED")
    log(f"  control {name}: rel err {e:.3g}: {verdict}")
    check(e >= tol or may_pass, f"the tolerance accepts the planted WKV control ({name})")


def phase_wkv(cfg):
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ref import wkv_split_ref
    from repro_torch.models.rwkv6 import wkv_chunked

    log("phase 7: WKV kernels vs plain version on the card (f32 r/k/v: the CUDA-core entry; "
        "bf16: the tensor-core entry)")
    errs = wkv_cases(torch.float32, "f32") + wkv_cases(torch.bfloat16, "bf16")

    # the main path's shape: the rwkv6-1.6b prefill, bf16 r/k/v
    B, S, H, D = EAGER_B, EAGER_PROMPT, cfg.rnn_heads, cfg.d_head
    args = wkv_inputs(B, S, H, D, dtype=torch.bfloat16, seed=7)
    got, want, err = wkv_check(f"main B={B} S={S} H={H} D={D} bf16", args, WKV_TOL)
    errs.append(err)
    log(f"  the emulation of the tensor-core entry (ref.wkv_split_ref) vs the kernel: rel err "
        f"{rel_err(wkv_split_ref(*args), got):.3g}")
    del got
    wkv_control("cross-chunk term dropped", wkv_no_carry(*args), want, WKV_TOL)
    wkv_control("diagonal halves' per-element weights dropped",
                wkv_split_ref(*args, drop_diagonal=True), want, WKV_TOL)
    wkv_control("operands rounded once to TF32 (no lo)", wkv_split_ref(*args, split=False), want,
                WKV_TOL, may_pass=True)
    del want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ops.wkv(*args, return_state=True))
    plain_ms = time_ms(lambda: wkv_chunked(*args, return_state=True), reps=5, warmup=1)
    b_ms, b_by, b_bytes, b_ops, b_f32 = wkv_bound(args[0], H, D)
    log(f"  times at the main shape: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.1%} of roofline; bytes {b_bytes:.4f} ms, 3xTF32 tensor-core operations "
        f"{b_ops:.4f} ms, the same flops at the f32 CUDA-core peak {b_f32:.4f} ms), "
        f"plain {plain_ms:.3f} ms, library: none")
    del args
    torch.cuda.empty_cache()
    return max(errs), {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_bytes_ms": b_bytes, "bound_operations_ms": b_ops,
                       "bound_f32_cuda_core_ms": b_f32, "library_ms": None}


# ---------------------------------------------------------------- flash
# tests/test_kernels_flash_attention.py::CASES, then its bf16 case and a
# ragged length (the kernels mask the ragged tile); then a bf16 twin of
# every f32 case, so the tensor-core kernel sees non-causal, window,
# prefix, D 32, G 3 and the ragged S 300 too.
FLASH_CASES = [
    # (B, S, H, KH, D, causal, window, prefix, dtype)
    (2, 256, 4, 2, 64, True, 0, 0, torch.float32),
    (1, 128, 3, 1, 32, True, 0, 0, torch.float32),
    (2, 256, 4, 4, 64, False, 0, 0, torch.float32),
    (1, 256, 2, 1, 64, True, 64, 0, torch.float32),
    (1, 128, 2, 2, 64, True, 0, 32, torch.float32),
    (1, 512, 1, 1, 128, True, 128, 0, torch.float32),
    (1, 128, 2, 1, 64, True, 0, 0, torch.bfloat16),
    (2, 300, 4, 2, 128, True, 100, 0, torch.float32),
]
FLASH_CASES += [c[:-1] + (torch.bfloat16,) for c in FLASH_CASES if c[-1] == torch.float32]


def flash_inputs(B, S, H, KH, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, KH, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, KH, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def flash_plain(q, k, v, *, causal=True, window=0, prefix=0):
    from repro_torch.kernels.flash_attention.ops import PLAIN_CHUNK
    from repro_torch.models.layers import blocked_attention

    return blocked_attention(q, k, v, causal=causal, window=window, q_chunk=PLAIN_CHUNK,
                             k_chunk=PLAIN_CHUNK, prefix_len=prefix)


def flash_check(name, q, k, v, **kw):
    """Kernel vs plain version (``blocked_attention``); returns (kernel
    output, plain output, max abs error)."""
    from repro_torch.kernels.flash_attention import ops

    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_plain(q, k, v, **kw)
    tol = tolerance(q.dtype)
    ok, err, _ = within(got, want, tol)
    ok = ok and got.dtype == q.dtype
    log(f"  {name}: max_abs_err={err:.3g} tol(atol, rtol)={tol} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"flash kernel disagrees with the plain version on {name}")
    return got, want, err


def flash_single_bf16_p(q, k, v):
    """The bf16 kernel's scheme with P rounded once to bf16 instead of split
    into hi + lo (``ref.flash_attention_mma_ref``, causal), model layout:
    what a kernel without the split would give."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_mma_ref

    B, S, H, D = q.shape
    KH = k.shape[2]
    kl = lambda x, n: x.permute(0, 2, 1, 3).reshape(B * n, S, D)  # noqa: E731
    out = flash_attention_mma_ref(kl(q, H), kl(k, KH), kl(v, KH), n_q_per_kv=H // KH,
                                  causal=True, p_split=False)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def flash_bound(q, k, causal=True):
    """Least time for causal attention on an H100 SXM: 4 H D flops per
    visible (query, key) pair at the bf16 tensor-core peak, vs q, k, v and
    the output each once at 3.35 TB/s."""
    B, S, H, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * H * D * pairs * B
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["bf16" if q.dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(cfg):
    from repro_torch.kernels.flash_attention import ops

    log("phase 8: flash-attention kernel vs plain version on the card")
    errs = []
    for n, (B, S, H, KH, D, causal, window, prefix, dt) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(B, S, H, KH, D, dt, seed=n)
        kw = dict(causal=causal, window=window, prefix=prefix)
        name = (f"case{n} B={B} S={S} H={H} KH={KH} D={D} {str(dt)[6:]} causal={causal} "
                f"window={window} prefix={prefix}")
        _, want, err = flash_check(name, q, k, v, **kw)
        errs.append(err)
        if window:  # the window one key wider must not pass
            planted(f"window {window + 1} instead of {window}",
                    flash_plain(q, k, v, causal=causal, window=window + 1, prefix=prefix),
                    want, tolerance(dt))

    # the main path's shape: the qwen3-1.7b prefill, bf16, as the model
    # hands it over (q, k, v views of one fused QKV projection)
    B, S, H, KH, D = EAGER_B, EAGER_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device="cuda").manual_seed(20)
    qkv = torch.randn((B, S, (H + 2 * KH) * D), generator=g, device="cuda").to(torch.bfloat16)
    qv, kv_, vv = torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    views = (qv.reshape(B, S, H, D), kv_.reshape(B, S, KH, D), vv.reshape(B, S, KH, D))
    errs.append(flash_check(f"main B={B} S={S} H={H} KH={KH} D={D} bf16, fused-QKV views",
                            *views)[2])
    q, k, v = (x.contiguous() for x in views)
    del qkv, views
    _, want, err = flash_check("main, contiguous", q, k, v)
    errs.append(err)
    planted("P rounded once to bf16 (no hi + lo split)", flash_single_bf16_p(q, k, v), want,
            BF16_TOL)
    del want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_plain(q, k, v), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True))
    b_ms, b_by = flash_bound(q, k)
    flops = 4 * H * D * B * S * (S + 1) // 2
    log(f"  times at the main shape: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of "
        f"least work), bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of roofline), plain "
        f"{plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return max(errs), {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib_ms}


# ---------------------------------------------------------------- eager path
def eager_model(arch, dtype, *, untie=False, seed=0):
    """(cfg, plan, random weights).  ``untie``: a separate random head.  With
    random weights a tied head's greedy stream repeats the last token, so
    the token comparisons untie it to make every token depend on the whole
    model."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.models.params import init_params

    cfg = get_config(arch)
    if untie:
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    plan = derive_execution_plan(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, plan, init_params(cfg, plan, dtype, generator=gen, device="cuda")


def prompts(cfg, B, S, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                         dtype=torch.int32)


def phase_eager(arch, kernel_name, tag):
    """The eager main path: ``greedy_generate`` at full width and depth in
    bf16, B 8 x 2048-token prompts, 32 new tokens.  Every launch count is
    set to 0 just before and read just after; the prompt's one prefill
    launches ``kernel_name`` once per layer, and each of the 32 forwards
    (the prefill and 31 decode steps) the RMSNorm kernel once a norm."""
    from repro_torch.serve import greedy_generate, make_prefill_step

    log(f"phase {tag} (main path): {arch} served by greedy_generate, bf16, B={EAGER_B}, "
        f"prompt {EAGER_PROMPT}, {EAGER_GEN} new tokens")
    cfg, plan, params = eager_model(arch, torch.bfloat16)
    tokens = prompts(cfg, EAGER_B, EAGER_PROMPT, seed=1)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, plan, batch, n_steps=EAGER_GEN,
                          cache_len=EAGER_PROMPT + EAGER_GEN, device="cuda")
    out = out.cpu()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok_s = EAGER_B * EAGER_GEN / dt
    log(f"  {tuple(out.shape)} tokens in {dt:.3f} s: {tok_s:.1f} output tok/s; peak device "
        f"memory {peak:.2f} GiB; launches {counts}")
    log(f"  request 0 tokens: {out[0].tolist()}")
    check(out.shape == (EAGER_B, EAGER_GEN) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab_size, "tokens of the wrong shape or outside the vocab")
    expect = expect_counts(**{kernel_name: cfg.n_layers,
                              "rmsnorm": norms_per_forward(cfg) * EAGER_GEN})
    check(counts == expect, f"launches {counts}, expected {expect} (one prefill, "
          f"{EAGER_GEN} forwards)")
    # the prefill's logits are finite (timed: the prompt's time to first token)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = make_prefill_step(cfg, plan)(params, batch)
    finite = bool(torch.isfinite(logits).all())
    prefill_s = time.perf_counter() - t0
    log(f"  prefill alone {prefill_s * 1e3:.1f} ms; logits finite: {finite}")
    check(finite, "non-finite prefill logits")
    del params, logits
    torch.cuda.empty_cache()
    return counts, {"tok_per_s": tok_s, "seconds": dt, "peak_gib": peak,
                    "prefill_ms": prefill_s * 1e3}


def phase_paths():
    """f32, full depth: the kernel path and the plain path (``fused=False``:
    ``blocked_attention`` / ``wkv_chunked`` and the plain norms on the card)
    give identical greedy tokens and prefill logits within rounding."""
    from repro_torch.serve import greedy_generate, make_prefill_step

    log("phase 11: f32 full depth, B=2, prompt 256, 16 new tokens: kernel path vs plain path")
    for arch, name in ((RWKV_ARCH, "wkv"), (SERVE_ARCH, "flash_attention")):
        cfg, plan, params = eager_model(arch, torch.float32, untie=True)
        batch = {"tokens": prompts(cfg, 2, 256, seed=2)}
        runs = {}
        for fused in (True, False):
            reset_counts()
            toks = greedy_generate(params, cfg, plan, batch, n_steps=16, cache_len=272,
                                   cache_dtype=torch.float32, device="cuda", fused=fused).cpu()
            launches = read_counts()
            logits, _ = make_prefill_step(cfg, plan, fused=fused)(params, batch)
            runs[fused] = (toks, launches, logits)
        (tk, lk, xk), (tp, lp, xp) = runs[True], runs[False]
        e = rel_err(xk, xp)
        same = bool(torch.equal(tk, tp))
        log(f"  {arch} (untied head): tokens identical {same}, distinct tokens in request 0: "
            f"{len(set(tk[0].tolist()))}/16, prefill logits rel err {e:.3g}, "
            f"launches {lk} (kernel path) / {lp} (plain path)")
        check(same, f"{arch}: kernel and plain paths disagree on greedy tokens")
        check(e < 1e-3, f"{arch}: prefill logits differ beyond f32 rounding")
        want = expect_counts(**{name: cfg.n_layers, "rmsnorm": norms_per_forward(cfg) * 16})
        check(lk == want and lp == expect_counts(), f"{arch}: launches {lk} / {lp}, kernel "
              f"path expected {want}")
        del params, runs, xk, xp
        torch.cuda.empty_cache()


def phase_engine_vs_eager():
    """qwen3-1.7b f32: the continuous engine's tokens equal the eager path's,
    one request at a time (tests/test_serve_engine.py:37-45 on the card)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.serve import ServingEngine, greedy_generate, random_stream

    log("phase 12: qwen3-1.7b f32 (untied head): ServingEngine vs greedy_generate, 4 requests")
    cfg, plan, params = eager_model(SERVE_ARCH, torch.float32, untie=True)
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=1024, decode_batch=4,
                              kv_dtype="fp32", rolled_steps=1)
    reqs = random_stream(cfg, 4, (64, 300), 16, stagger=2, seed=5)
    asked = {r.rid: list(r.prompt) for r in reqs}
    engine = ServingEngine(params, cfg, plan, serve, device="cuda")
    got = engine.run(reqs)
    del engine
    for rid, p in asked.items():
        want = greedy_generate(params, cfg, plan, {"tokens": torch.tensor([p])}, n_steps=16,
                               cache_len=len(p) + 16, cache_dtype=torch.float32,
                               device="cuda")[0].tolist()
        log(f"  {rid}: prompt {len(p)}, engine == greedy_generate: {got[rid] == want} "
            f"({len(set(want))} distinct tokens)")
        check(got[rid] == want, f"{rid}: engine tokens differ from greedy_generate")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- rmsnorm
# f32 output: 1e-5 (the JAX kernel test's); bf16 output: one bf16 step, as
# for the attention kernels (both sides compute in f32, round once).
RMS_F32_TOL = (1e-5, 1e-5)


def rms_inputs(shape, dtype, seed):
    """x (dtype) and a (d,) f32 scale drawn as the JAX test draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    return x, torch.randn(shape[-1], generator=g, device="cuda") * 0.1


def qkv_views(B, S, H, KH, D, dtype, seed):
    """q and k as the model hands them to qk-norm: views of one fused QKV
    projection, tokens (H + 2 KH) D elements apart."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, S, (H + 2 * KH) * D), generator=g, device="cuda").to(dtype)
    q, k, _ = torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    return q.reshape(B, S, H, D), k.reshape(B, S, KH, D)


def rms_check(name, x, s, residual=None):
    """Kernel vs plain version (``rmsnorm_ref``); returns (kernel output,
    plain output, max abs error)."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    got = ops.rmsnorm(x, s, residual)
    torch.cuda.synchronize()
    want = rmsnorm_ref(x, s, residual)
    tol = BF16_TOL if x.dtype == torch.bfloat16 else RMS_F32_TOL
    ok, err, _ = within(got, want, tol)
    ok = ok and got.dtype == x.dtype and got.shape == x.shape and bool(torch.isfinite(got).all())
    log(f"  {name}: max_abs_err={err:.3g} tol(atol, rtol)={tol} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"rmsnorm kernel disagrees with the plain version on {name}")
    return got, want, err


def rms_mean_over_d_minus_1(x, s, eps=1e-6):
    """The plain version with the mean of squares taken over d - 1."""
    xf = x.float()
    ms = xf.square().sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return (xf * torch.rsqrt(ms + eps) * (1.0 + s)).to(x.dtype)


def rms_bound(x):
    """Least time on an H100 SXM: x read and y written once, and the scale,
    at 3.35 TB/s (about 4 flops an element, far below the f32 peak)."""
    nbytes = 2 * x.numel() * x.element_size() + 4 * x.shape[-1]
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def rms_times(name, x, s, *, library_on_copy=False):
    """Kernel, plain version and the nearest library call
    (``F.rms_norm`` with the weight 1 + scale in x's dtype, made outside
    the timed region, on x itself or, with ``library_on_copy``, on a
    contiguous copy made outside it; the port never calls it)."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.models.layers import rmsnorm

    d = x.shape[-1]
    ms = time_ms(lambda: ops.rmsnorm(x, s))
    plain_ms = time_ms(lambda: rmsnorm(x, s), reps=10, warmup=2)
    weight = (1.0 + s).to(x.dtype)
    xl = x.contiguous() if library_on_copy else x
    lib_ms = time_ms(lambda: F.rms_norm(xl, (d,), weight, 1e-6))
    del xl
    b_ms, b_by = rms_bound(x)
    plan = ops.launch_plan(x.numel() // d, d, x.element_size(), True)
    log(f"  times {name}: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of "
        f"roofline), plain {plain_ms:.3f} ms, F.rms_norm{' (contiguous copy)' * library_on_copy} "
        f"{lib_ms:.4f} ms; launch plan (lanes a row, vectors a lane, rows a group, CTAs) {plan}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def phase_rmsnorm(cfg):
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    log("phase 13: rmsnorm kernel vs plain version on the card")
    before = ops.LAUNCHES
    errs = []
    n = 0
    # tests/test_kernels_rmsnorm.py: its shapes x dtypes, the fused residual
    for shape in [(64, 128), (2, 100, 64), (7, 33)]:
        for dt in (torch.float32, torch.bfloat16):
            errs.append(rms_check(f"{shape} {str(dt)[6:]}", *rms_inputs(shape, dt, n))[2])
            n += 1
    for dt in (torch.float32, torch.bfloat16):
        x, s = rms_inputs((32, 64), dt, n)
        r = rms_inputs((32, 64), dt, n + 1)[0]
        errs.append(rms_check(f"(32, 64) {str(dt)[6:]} + residual", x, s, r)[2])
        n += 2
    # every width of the port's rmsnorm configs, and d_head for qk-norm
    for d in (576, 2048, 3072, 4096, 12288, 128):
        for dt in (torch.float32, torch.bfloat16):
            x, s = rms_inputs((300, d), dt, n)
            _, want, err = rms_check(f"width (300, {d}) {str(dt)[6:]}", x, s)
            errs.append(err)
            n += 1
            if dt == torch.float32 and d in (128, 2048):
                planted(f"mean over d - 1 = {d - 1}", rms_mean_over_d_minus_1(x, s), want,
                        RMS_F32_TOL)
    # sub-warp rows (8 or 16 lanes a row, several rows a warp) at ragged
    # row counts, so that the last warp's groups and the grid's last stride
    # are partly empty
    for rows in (1, 3, 37, 1001):
        for d, dt in ((128, torch.bfloat16), (64, torch.float32), (64, torch.bfloat16),
                      (32, torch.float32)):
            x, s = rms_inputs((rows, d), dt, n)
            errs.append(rms_check(f"ragged ({rows}, {d}) {str(dt)[6:]}", x, s)[2])
            n += 1
    # qk-norm input: strided views of a fused QKV projection
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for dt in (torch.float32, torch.bfloat16):
        q, k = qkv_views(2, 37, H, KH, D, dt, n)
        s = rms_inputs((D,), torch.float32, n + 1)[1]
        n += 2
        for nm, v in (("q", q), ("k", k)):
            got, _, err = rms_check(f"{nm} view {tuple(v.shape)} {str(dt)[6:]}, token stride "
                                    f"{v.stride(1)}", v, s)
            errs.append(err)
            check(torch.equal(got, ops.rmsnorm(v.contiguous(), s)),
                  "the strided view and its contiguous copy disagree")

    # the main paths' shapes: the qwen3-1.7b prefill rows (B 8 x 2048 tokens)
    # and its q view, and the continuous slab (256 slots x 256 rows)
    d = cfg.d_model
    x, s = rms_inputs((EAGER_B * EAGER_PROMPT, d), torch.bfloat16, 50)
    _, want, err = rms_check(f"main prefill rows ({x.shape[0]}, {d}) bf16", x, s)
    errs.append(err)
    planted("(1 + scale) replaced by scale", rmsnorm_ref(x, s - 1.0), want, BF16_TOL)
    del want
    prefill = rms_times(f"prefill rows ({x.shape[0]}, {d}) bf16", x, s)
    del x
    q, _ = qkv_views(EAGER_B, EAGER_PROMPT, H, KH, D, torch.bfloat16, 51)
    sq = rms_inputs((D,), torch.float32, 52)[1]
    errs.append(rms_check(f"main q view {tuple(q.shape)} bf16", q, sq)[2])
    qview = rms_times(f"q view {tuple(q.shape)} bf16", q, sq)
    del q
    x, s = rms_inputs((SLAB_ROWS, d), torch.bfloat16, 53)
    errs.append(rms_check(f"main slab ({x.shape[0]}, {d}) bf16", x, s)[2])
    slab = rms_times(f"slab ({x.shape[0]}, {d}) bf16", x, s)
    del x
    torch.cuda.empty_cache()
    # qk-norm at the continuous slab: 256 slots x 256 rows of the fused QKV
    # projection, q and k views read in place (token stride (H + 2 KH) D)
    q, k = qkv_views(256, 256, H, KH, D, torch.bfloat16, 54)
    slab_views = {}
    for nm, v in (("q", q), ("k", k)):
        sv = rms_inputs((D,), torch.float32, 55)[1]
        errs.append(rms_check(f"slab {nm} view {tuple(v.shape)} bf16, token stride "
                              f"{v.stride(1)}", v, sv)[2])
        slab_views[f"slab_{nm}_view"] = rms_times(f"slab {nm} view {tuple(v.shape)} bf16", v, sv,
                                                  library_on_copy=True)
    del q, k
    torch.cuda.empty_cache()
    ops.LAUNCHES = before  # checking and timing launches are not main-path launches
    return max(errs), {"prefill": prefill, "q_view": qview, "slab": slab, **slab_views}


# ---------------------------------------------------------------- mm_pu
# (atol, rtol).  f32 output: the JAX test's 1e-4 / 1e-5 (random shapes
# 1e-3 / 1e-4); bf16 output: one bf16 step (JAX allows 2e-2): the kernel
# and the plain version both accumulate in f32 and round once.
MM_F32_TOL, MM_RANDOM_TOL = (1e-4, 1e-5), (1e-3, 1e-4)
MM_SHAPES = [(128, 128, 128), (256, 512, 384), (197, 768, 768), (64, 100, 32), (300, 64, 513)]


def mm_inputs(m, k, n, dtype, seed):
    """x (m, k) and w (k, n) * 0.05 as the JAX test draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=g, device="cuda") * 0.05).to(dtype)
    return x, w


def mm_check(name, x, w, tol=None, **kw):
    """Kernel vs plain version (``mm_pu_ref``) on the same inputs; returns
    (kernel output, plain output, max abs error)."""
    from repro_torch.kernels.mm_pu import ops
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref

    got = ops.mm_pu(x, w, **kw)
    torch.cuda.synchronize()
    want = mm_pu_ref(x, w, **kw)
    if tol is None:
        tol = BF16_TOL if want.dtype == torch.bfloat16 else MM_F32_TOL
    ok, err, _ = within(got, want, tol)
    ok = ok and got.dtype == want.dtype and got.shape == want.shape
    log(f"  {name}: max_abs_err={err:.3g} tol(atol, rtol)={tol} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"mm_pu kernel disagrees with the plain version on {name}")
    return got, want, err


def mm_controls(x, q, s, want, tol):
    """The planted controls of the int8 product x @ (q * s): the last K
    slice of x's kernel dropped, and the scale applied per output row
    instead of per column (row m scaled by s[m mod N])."""
    from repro_torch.kernels.mm_pu.ops import K_SLICE
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref

    K, M, N = q.shape[0], x.shape[0], q.shape[1]
    cut = (K - 1) // K_SLICE[x.dtype] * K_SLICE[x.dtype]
    planted(f"last K slice dropped (K {K} -> {cut})",
            mm_pu_ref(x[:, :cut], q[:cut], w_scale=s, out_dtype=want.dtype), want, tol)
    rows = s.reshape(-1)[torch.arange(M, device=x.device) % N]
    per_row = ((x.float() @ q.float()) * rows[:, None]).to(want.dtype)
    planted("scale per row instead of per column", per_row, want, tol)


def phase_mm_pu():
    from repro_torch.kernels.mm_pu import ops
    from repro_torch.kernels.mm_pu.ref import quantize_weights_int8

    log("phase 14: mm_pu kernel vs plain version on the card")
    before = ops.LAUNCHES
    errs = []
    # tests/test_kernels_mm_pu.py: SHAPES x dtypes, every activation with
    # bias and residual, the int8 dequant, random shapes
    for n, (m, k, nn) in enumerate(MM_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            errs.append(mm_check(f"({m}, {k}) @ ({k}, {nn}) {str(dt)[6:]}",
                                 *mm_inputs(m, k, nn, dt, n))[2])
    g = torch.Generator(device="cuda").manual_seed(10)
    b = torch.randn((1, 256), generator=g, device="cuda")
    r = torch.randn((256, 256), generator=g, device="cuda")
    for act in ("gelu", "silu", "relu", "relu2", "none"):
        x, w = mm_inputs(256, 256, 256, torch.float32, 11)
        errs.append(mm_check(f"256^3 f32 {act} + bias + residual", x, w, bias=b, residual=r,
                             activation=act)[2])
    x, w = mm_inputs(256, 384, 512, torch.float32, 12)
    q, s = quantize_weights_int8(w)
    _, want, err = mm_check("int8 dequant (256, 384) @ (384, 512)", x, q, w_scale=s)
    errs.append(err)
    mm_controls(x, q, s, want, MM_F32_TOL)
    # the tensor-core kernel (bf16 x) at the same shapes, ragged and
    # unaligned: bf16 w and int8 w, each with an activation, bias and a bf16
    # residual (launch_plan splits K on the narrow grids)
    acts = ("gelu", "silu", "relu", "relu2", "none")
    for n, (m, k, nn) in enumerate(MM_SHAPES):
        x, w = mm_inputs(m, k, nn, torch.bfloat16, 30 + n)
        b = torch.randn((1, nn), generator=g, device="cuda")
        r = torch.randn((m, nn), generator=g, device="cuda").to(torch.bfloat16)
        q, s = quantize_weights_int8(w.float())
        splits, kps = ops.launch_plan(m, nn, k)
        for wname, ww, kw in (("bf16 w", w, {}), ("int8 w", q, {"w_scale": s})):
            act = acts[(2 * n + len(kw)) % len(acts)]
            errs.append(mm_check(f"bf16 x ({m}, {k}) @ ({k}, {nn}) {wname} {act} + bias + "
                                 f"residual, {splits} K split(s) of {kps}", x, ww, bias=b,
                                 residual=r, activation=act, **kw)[2])
    rng = np.random.default_rng(13)
    for i in range(10):
        m, k, nn = (int(v) for v in rng.integers(8, 301, 3))
        errs.append(mm_check(f"random ({m}, {k}) @ ({k}, {nn})",
                             *mm_inputs(m, k, nn, torch.float32, 20 + i), tol=MM_RANDOM_TOL)[2])
    ops.LAUNCHES = before
    torch.cuda.empty_cache()
    return max(errs)


def mm_bound(x, w, out_dtype):
    """Least time on an H100 SXM: 2 M N K flops at the bf16 tensor-core rate
    (bf16 x with int8 or bf16 w: every operand exact in bf16), or x, w, the
    scale and the output once at 3.35 TB/s, whichever is larger."""
    M, K = x.shape
    N = w.shape[1]
    out_size = torch.finfo(out_dtype).bits // 8
    nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * N + M * N * out_size
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = 2 * M * N * K / PEAK_FLOPS["bf16" if x.dtype == torch.bfloat16 else "fp32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_int8_ffn(cfg_full):
    """tests/test_int8_serving.py's SwiGLU stage on the card at qwen3-1.7b's
    FFN width: layer 0's w1/w3/w2 (2048 -> 6144 -> 2048) of bf16
    ``init_params`` weights (depth cut to one layer), each quantized to
    int8 per output channel, three ``mm_pu`` products over bf16 tokens."""
    import dataclasses

    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.kernels.mm_pu import ops
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref, quantize_weights_int8
    from repro_torch.models.layers import mlp
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(cfg_full, n_layers=1)
    log(f"phase 15: int8 FFN stage at {cfg.name} width (d {cfg.d_model}, d_ff {cfg.d_ff}), "
        "bf16 tokens")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, derive_execution_plan(cfg), torch.bfloat16, generator=gen,
                         device="cuda")
    stack = params["blocks"]["stack"]  # one pattern-group: layer 0 is index 0 of each leaf
    ffn = {k: stack[0]["ffn"][k][0] for k in ("w1", "w3", "w2")}
    del params, stack
    (q1, s1), (q3, s3), (q2, s2) = (quantize_weights_int8(ffn[k]) for k in ("w1", "w3", "w2"))
    errs, out = [], {}
    for T in (EAGER_PROMPT, 256):
        x = torch.randn((T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        reset_counts()
        h = ops.mm_pu(x, q1, w_scale=s1, activation="silu")
        g = ops.mm_pu(x, q3, w_scale=s3)
        y = ops.mm_pu(h * g, q2, w_scale=s2)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == expect_counts(mm_pu=3), f"T={T}: launches {counts}, expected 3 mm_pu")
        # each product against its plain version on the same inputs
        products = {"w1 silu": (x, q1, s1, "silu", h), "w3": (x, q3, s3, "none", g),
                    "w2": (h * g, q2, s2, "none", y)}
        for name, (xin, q, s, act, got) in products.items():
            want = mm_pu_ref(xin, q, w_scale=s, activation=act)
            ok, err, _ = within(got, want, BF16_TOL)
            log(f"  T={T} {name} ({xin.shape[0]}, {q.shape[0]}) @ ({q.shape[0]}, {q.shape[1]}): "
                f"max_abs_err={err:.3g} tol(atol, rtol)={BF16_TOL} {'ok' if ok else 'MISMATCH'}")
            check(ok, f"mm_pu kernel disagrees with the plain version on T={T} {name}")
            errs.append(err)
            if T == EAGER_PROMPT and name == "w1 silu":
                mm_controls(x, q1, s1, mm_pu_ref(x, q1, w_scale=s1), BF16_TOL)
        # the stage against the plain stage and against the bf16 FFN
        hr = mm_pu_ref(x, q1, w_scale=s1, activation="silu")
        yr = mm_pu_ref(hr * mm_pu_ref(x, q3, w_scale=s3), q2, w_scale=s2)
        fp = mlp(ffn, x, "swiglu")
        e_plain, e_fp = rel_err(y, yr), rel_err(y, fp)
        finite = bool(torch.isfinite(y).all())
        log(f"  T={T} stage: shape {tuple(y.shape)} {y.dtype}, finite {finite}, rel err vs the "
            f"plain stage {e_plain:.3g} (tol 2e-2), vs the bf16 FFN {e_fp:.4f} (tol 0.05), "
            f"launches {counts}")
        check(finite and y.shape == (T, cfg.d_model), "int8 FFN output not finite or misshapen")
        check(e_plain < 2e-2, f"T={T}: the int8 stage differs from its plain version")
        check(e_fp < 0.05, f"T={T}: the int8 stage deviates {e_fp:.3f} from the bf16 FFN")
        # times per product: kernel, bound, plain, and cuBLAS on the
        # dequantized bf16 weight (made outside the timed region)
        for name, (xin, q, s, act, _) in products.items():
            wdq = (q.float() * s).to(torch.bfloat16)
            ms = time_ms(lambda: ops.mm_pu(xin, q, w_scale=s, activation=act))
            plain_ms = time_ms(lambda: mm_pu_ref(xin, q, w_scale=s, activation=act), reps=10,
                               warmup=2)
            lib_ms = time_ms(lambda: torch.matmul(xin, wdq))
            b_ms, b_by = mm_bound(xin, q, torch.bfloat16)
            flops = 2 * xin.shape[0] * q.shape[0] * q.shape[1]
            log(f"  times T={T} {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of roofline), plain "
                f"{plain_ms:.3f} ms, cuBLAS bf16 {lib_ms:.4f} ms")
            out[f"T={T} {name}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                    "bound_by": b_by, "library_ms": lib_ms}
            del wdq
        for name, (xin, q, _, _, _) in products.items():
            splits, kps = ops.launch_plan(xin.shape[0], q.shape[1], q.shape[0])
            tiles = -(-xin.shape[0] // ops.TILE) * -(-q.shape[1] // ops.TILE)
            log(f"  T={T} {name}: launch plan {tiles} tiles x {splits} K split(s) of {kps} = "
                f"{tiles * splits} CTAs")
            if T == 256 and name == "w2":
                check(splits > 1 and tiles * splits >= ops.N_SMS, "T=256 w2 does not split K")
        if T == EAGER_PROMPT:
            launches = counts["mm_pu"]
        del x, h, g, y, hr, yr, fp
    del ffn, q1, q3, q2
    torch.cuda.empty_cache()
    return max(errs), launches, out


# ---------------------------------------------------------------- MoE
MOE_ARCH = "qwen3-moe-30b-a3b"
# Phase 18's trace: every class, two tenants (shared system prompts, so
# prefix sharing runs on int8 pages), summarize prompts past one 256-row chunk.
MOE_MIX = {"classify": 8, "chat": 4, "summarize": 2}
MOE_SLAB = 128 * 256  # the derived plan's rows a dispatch: 128 slots x 256
# gshard in bf16 against float64 on the same routing, relative to the
# largest output: four bf16 roundings on the way (h and g, silu(h) g, the
# expert output, the layer output), each at most 2^-8 of its value.
MOE_F64_TOL = 4 * 2.0**-8
# Phase 19's eager run: B 4 prompts of 1024 tokens, 8 new tokens each.
MOE_EAGER_B, MOE_EAGER_PROMPT, MOE_EAGER_GEN = 4, 1024, 8
# Phase 18's first dispatch, kernel path vs plain path on the same routing,
# per live row: |deviation| / |row| after l + 1 layers within
# FIRST_DISPATCH_TOL sqrt(l + 1): each layer's own rounding (bf16 products,
# int8 re-quantization of K and V) may move a row by one bf16 step, and
# independent steps add as a random walk.  Element-wise, one bf16 step does
# not hold past the first layer: rounding alone moves most elements by more
# (the noise-floor run shows it).
FIRST_DISPATCH_TOL = 2.0**-7


def moe_weights(cfg, seed):
    """One MoE layer's FFN leaves as ``init_params`` draws them (bf16,
    scale 0.02): router (d, E), w1/w3 (E, d, F), w2 (E, F, d)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    draw = lambda *shape: (torch.randn(shape, generator=g, device="cuda") * 0.02).to(  # noqa: E731
        torch.bfloat16)
    return {"router": draw(d, E), "w1": draw(E, d, F_), "w3": draw(E, d, F_),
            "w2": draw(E, F_, d)}


def slab_rows(cfg, n_slots, width, n_live, seed):
    """(n_slots x width, d) bf16 rows shaped like a slab's normed hidden
    states: the first ``n_live[b]`` rows of slot b random, the rest one row
    shared by every dead row (dead rows carry token 0 and a zeroed attention
    output, so they route alike)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n_slots, width, cfg.d_model), generator=g, device="cuda")
    dead = torch.randn((cfg.d_model,), generator=g, device="cuda")
    for b in range(n_slots):
        x[b, int(n_live[b]):] = dead
    return x.reshape(n_slots * width, cfg.d_model).to(torch.bfloat16)


def queue_ranks_np(e, cap):
    """Plain host recomputation of gshard's capacity rule on (G, g K)
    expert ids: a stable sort by expert, rank = position - the expert's
    first position; kept iff rank < cap."""
    rank = np.empty_like(e)
    for gi in range(e.shape[0]):
        order = np.argsort(e[gi], kind="stable")
        se = e[gi][order]
        rank[gi][order] = np.arange(se.size) - np.searchsorted(se, se, side="left")
    return rank < cap


def moe_ref64(p, x, gates, idx, st, *, whole_t=False):
    """float64 recomputation of gshard's output on the card from the same
    routing (gates, idx): the capacity rule recomputed on the host
    (``queue_ranks_np``), each expert's FFN in float64 on its kept tokens,
    gate-weighted sums.  ``whole_t``: ranks over the whole T instead of per
    group (the planted control).  Returns (out (T, d) f64, kept (T, K))."""
    from repro_torch.models import moe

    T, d = x.shape
    E, K = st.n_experts, st.top_k
    g, G, cap = moe.gshard_groups(T, st)
    e = idx.cpu().numpy()
    kept = queue_ranks_np(e.reshape(1 if whole_t else G, -1), cap).reshape(T, K)
    out = torch.zeros((T, d), dtype=torch.float64, device="cuda")
    x64, gates64 = x.double(), gates.double()
    for ex in range(E):
        t, k = np.nonzero((e == ex) & kept)
        if t.size == 0:
            continue
        t_d, k_d = torch.from_numpy(t).cuda(), torch.from_numpy(k).cuda()
        xt = x64[t_d]
        h = F.silu(xt @ p["w1"][ex].double()) * (xt @ p["w3"][ex].double())
        out.index_add_(0, t_d, (h @ p["w2"][ex].double()) * gates64[t_d, k_d][:, None])
    return out, kept


def phase_moe_shapes(cfg):
    """The flash and RMSNorm kernels against their plain versions at
    qwen3-moe-30b-a3b's head shapes (H 32, KH 4, G 8): flash at phase 19's
    prefill (fused-QKV views and contiguous copies, phase 8's control
    planted), qk-norm on the q and k views of phase 18's slab and of phase
    19's prefill (token stride (H + 2 KH) D, read in place).  Returns (flash
    max abs error, RMSNorm max abs error)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B, S = MOE_EAGER_B, MOE_EAGER_PROMPT
    log(f"phase 16: flash and RMSNorm kernels vs plain versions at {cfg.name}'s head shapes "
        f"(H {H}, KH {KH}, G {H // KH}, D {D})")
    before = (flash_ops.LAUNCHES, rms_ops.LAUNCHES)
    g = torch.Generator(device="cuda").manual_seed(62)
    qkv = torch.randn((B, S, (H + 2 * KH) * D), generator=g, device="cuda").to(torch.bfloat16)
    qv, kv_, vv = torch.split(qkv, [H * D, KH * D, KH * D], dim=-1)
    views = (qv.reshape(B, S, H, D), kv_.reshape(B, S, KH, D), vv.reshape(B, S, KH, D))
    flash_errs = [flash_check(f"flash B={B} S={S} H={H} KH={KH} D={D} bf16, fused-QKV views",
                              *views)[2]]
    q, k, v = (x.contiguous() for x in views)
    del qkv, views
    _, want, err = flash_check("flash, contiguous", q, k, v)
    flash_errs.append(err)
    planted("P rounded once to bf16 (no hi + lo split)", flash_single_bf16_p(q, k, v), want,
            BF16_TOL)
    del q, k, v, want
    torch.cuda.empty_cache()
    rms_errs = []
    for n, (tag, b, w) in enumerate((("slab", 128, 256), ("prefill", B, S))):
        q, k = qkv_views(b, w, H, KH, D, torch.bfloat16, 63 + 2 * n)
        sv = rms_inputs((D,), torch.float32, 64 + 2 * n)[1]
        for nm, v in (("q", q), ("k", k)):
            got, want, err = rms_check(f"{tag} {nm} view {tuple(v.shape)} bf16, token stride "
                                       f"{v.stride(1)}", v, sv)
            rms_errs.append(err)
            check(torch.equal(got, rms_ops.rmsnorm(v.contiguous(), sv)),
                  "the strided view and its contiguous copy disagree")
            if (tag, nm) == ("slab", "q"):
                planted("(1 + scale) replaced by scale", rmsnorm_ref(v, sv - 1.0), want,
                        BF16_TOL)
            del got, want
        del q, k
    torch.cuda.empty_cache()
    flash_ops.LAUNCHES, rms_ops.LAUNCHES = before  # checks are not main-path launches
    return max(flash_errs), max(rms_errs)


def phase_moe(cfg):
    """The MoE functions at qwen3-moe-30b-a3b's width on the card (d 2048,
    E 128, K 8, F 768, bf16 rows and weights): gshard and sort agree when
    nothing drops; gshard at the slab's T with capacity 1.25 against a
    float64 recomputation of the same routing (the same choices kept, a
    planted control rejected); the layer's parts timed."""
    import dataclasses

    from repro_torch.models import moe

    E, K = cfg.n_experts, cfg.top_k
    log(f"phase 17: MoE functions at {cfg.name} width (d {cfg.d_model}, E {E}, K {K}, "
        f"F {cfg.moe_d_ff}), bf16")
    p = moe_weights(cfg, seed=50)
    # drop-free: capacity E / K gives gshard g slots an expert a group and
    # sort T an expert, more than any expert can receive (a token's K
    # choices are distinct); capacity E would ask 8x that (17 GB of xe at
    # T 4096)
    T = 4096
    x = torch.randn((T, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(51),
                    device="cuda").to(torch.bfloat16)
    st = moe.MoESettings(E, K, capacity_factor=float(E // K))
    combine, _ = moe.gshard_route(x, p["router"], st)
    kept = int((combine > 0).sum())
    del combine
    y_g, aux_g = moe.moe_gshard(p, x, st, "swiglu")
    y_s, aux_s = moe.moe_sort(p, x, dataclasses.replace(st, dispatch="sort"), "swiglu")
    e_gs, e_aux = rel_err(y_g, y_s), abs(float(aux_g) - float(aux_s))
    log(f"  T={T} capacity {E // K} (drop-free): gshard vs sort rel err {e_gs:.3g} (tol 2^-7 "
        f"of the largest output: one bf16 step), aux {float(aux_g):.6f} vs {float(aux_s):.6f}, "
        f"choices kept {kept} of {T * K}")
    check(kept == T * K, "a drop-free gshard dispatch dropped a choice")
    check(e_gs < 2.0**-7 and e_aux < 1e-5, "gshard and sort disagree drop-free")
    del x, y_g, y_s
    torch.cuda.empty_cache()

    # the slab at capacity 1.25: 128 slots x 256 rows, 16 slots prefilling,
    # 112 decoding one row, every other row dead
    st = moe.MoESettings(E, K, capacity_factor=1.25)
    g, G, cap = moe.gshard_groups(MOE_SLAB, st)
    rng = np.random.default_rng(52)
    n_live = np.ones(128, np.int64)
    n_live[:16] = rng.integers(1, 257, 16)
    x = slab_rows(cfg, 128, 256, n_live, seed=53)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y, _ = moe.moe_gshard(p, x, st, "swiglu")
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    gates, idx, _ = moe.router_topk(x, p["router"], K)
    want, kept = moe_ref64(p, x, gates, idx, st)
    combine, _ = moe.gshard_route(x, p["router"], st)
    t_idx, e_idx = torch.nonzero(combine.reshape(MOE_SLAB, E, cap).amax(-1) > 0, as_tuple=True)
    del combine
    mine = set(zip(t_idx.tolist(), e_idx.tolist()))
    t_k = np.nonzero(kept)
    theirs = set(zip(t_k[0].tolist(), idx.cpu().numpy()[t_k].tolist()))
    live = int(n_live.sum())
    e64 = rel_err(y, want)
    log(f"  T={MOE_SLAB} (g {g}, G {G}, cap {cap}), {live} live rows: choices kept "
        f"{len(mine)} of {MOE_SLAB * K} (host rule: {len(theirs)}, identical: {mine == theirs}); "
        f"vs float64 rel err {e64:.3g} (tol {MOE_F64_TOL:.3g}); extra device memory at peak "
        f"{peak:.2f} GiB")
    check(mine == theirs, "gshard keeps other choices than the capacity rule")
    check(e64 < MOE_F64_TOL, "gshard disagrees with its float64 recomputation")
    bad, _ = moe_ref64(p, x, gates, idx, st, whole_t=True)
    e_bad = rel_err(y, bad)
    log(f"  control ranks over the whole T: rel err {e_bad:.3g}: "
        f"{'rejected' if e_bad >= MOE_F64_TOL else 'ACCEPTED'}")
    check(e_bad >= MOE_F64_TOL, "the tolerance accepts ranks counted over the whole T")
    del want, bad, y

    # one layer's parts at the slab's T
    combine, _ = moe.gshard_route(x, p["router"], st)
    xe = moe.gshard_dispatch(combine, x)
    ye = moe._expert_ffn(p, xe, "swiglu")
    parts = {
        "router": time_ms(lambda: moe.router_topk(x, p["router"], K), reps=5),
        "route (router, ranks, combine weights)": time_ms(
            lambda: moe.gshard_route(x, p["router"], st), reps=5),
        "dispatch product": time_ms(lambda: moe.gshard_dispatch(combine, x), reps=5),
        "experts": time_ms(lambda: moe._expert_ffn(p, xe, "swiglu"), reps=5),
        "combine product (f32)": time_ms(lambda: moe.gshard_combine(combine, ye), reps=5),
    }
    del xe, ye, combine
    torch.cuda.empty_cache()
    parts["layer (moe_gshard)"] = time_ms(lambda: moe.moe_gshard(p, x, st, "swiglu"), reps=5)
    flops = {"dispatch product": 2 * MOE_SLAB * E * cap * cfg.d_model,
             "experts": 3 * 2 * E * G * cap * cfg.d_model * cfg.moe_d_ff,
             "combine product (f32)": 2 * MOE_SLAB * E * cap * cfg.d_model}
    for name, ms in parts.items():
        rate = f", {flops[name] / ms / 1e9:.1f} TFLOP/s" if name in flops else ""
        log(f"  time T={MOE_SLAB} {name}: {ms:.3f} ms{rate}")
    del p, x, gates, idx
    torch.cuda.empty_cache()
    return parts


def first_dispatch(params, cfg, plan, serve, reqs, *, fused, routing=None):
    """The trace's first mixed dispatch: one ``ServingEngine.step`` of a
    fresh engine, with the engine's ``forward`` and the MoE router wrapped.
    With ``routing`` (another run's ``handed``), each layer's router hands
    on that run's (gates, idx, aux) in place of its own, so both runs
    dispatch the same choices to the same capacity slots.  Returns (live
    rows' final hidden states (n, d), each MoE layer's router inputs on the
    live rows (layers, n, d), the router's own top-k there (layers, n, K),
    handed: the (gates, idx, aux) each layer dispatched)."""
    from repro_torch.models import moe
    from repro_torch.serve import ServingEngine
    from repro_torch.serve import engine as engine_mod

    engine = ServingEngine(params, cfg, plan, serve, fused=fused, device="cuda")
    for r in reqs:
        engine.submit(r)
    forward, router = engine_mod.forward, moe.router_topk
    live, rows, seen, handed = [], [], [], []

    def recording_forward(p, batch, **kw):
        W = batch["tokens"].shape[1]
        kinds = kw["page_state"]["q_lens"]
        live.append((torch.arange(W, device=kinds.device)[None] < kinds[:, None]).reshape(-1))
        x, cache = forward(p, batch, **kw)
        rows.append(x.reshape(-1, x.shape[-1])[live[-1]])
        return x, cache

    def recording_router(x, w, k):
        own = router(x, w, k)
        out = own if routing is None else routing[len(handed)]
        seen.append((x[live[-1]], own[1][live[-1]]))
        handed.append(out)
        return out

    engine_mod.forward, moe.router_topk = recording_forward, recording_router
    try:
        engine.step()
    finally:
        engine_mod.forward, moe.router_topk = forward, router
    check(engine.stats["steps"] == 1 and len(rows) == 1 and len(seen) == cfg.n_layers,
          f"the first step ran {len(rows)} forwards and {len(seen)} routers, expected one "
          f"mixed dispatch through {cfg.n_layers} MoE layers")
    del engine
    torch.cuda.empty_cache()
    return (rows[0], torch.stack([h for h, _ in seen]), torch.stack([i for _, i in seen]),
            handed)


def row_dev(got, want):
    """Per row: the deviation's norm over the row's norm."""
    return (got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)


def one_step_up(params, share, seed):
    """Raise ``share`` of the embedding's elements by one bf16 step (the bit
    pattern plus one) in place; returns the saved table."""
    e = params["embed"]
    saved = e.clone()
    g = torch.Generator(device="cuda").manual_seed(seed)
    bits = e.view(torch.int16)
    bits[torch.rand(e.shape, generator=g, device="cuda") < share] += 1
    return saved


def compare_first_dispatch(kernel, plain_, noise):
    """Kernel path vs plain path on the first dispatch (``first_dispatch``'s
    results, the plain path dispatching the kernel path's routing): every
    MoE layer's router inputs and the final rows on the live rows, within
    FIRST_DISPATCH_TOL sqrt(layers passed) of each row's norm.  ``noise``:
    the plain path again with one bf16 step added to 1% of the embedding's
    elements, the deviation rounding alone makes (reported).  The routing
    choices the plain path's own router would have made differently are
    counted, not held."""
    rows_k, h_k, own_k, _ = kernel
    rows_p, h_p, own_p, _ = plain_
    n_layers, n_rows = h_k.shape[:2]
    pairs = [(h_k[i], h_p[i]) for i in range(n_layers)] + [(rows_k, rows_p)]
    dev = [float(row_dev(a, b).max()) for a, b in pairs]
    floor = [float(row_dev(a, b).max()) for a, b in
             [(noise[1][i], h_p[i]) for i in range(n_layers)] + [(noise[0], rows_p)]]
    tol = [FIRST_DISPATCH_TOL * (i + 1) ** 0.5 for i in range(n_layers + 1)]
    outside = [within(a, b, BF16_TOL)[2] for a, b in (pairs[0], pairs[-1])]
    flip = (own_k.sort(-1).values != own_p.sort(-1).values).any(-1)  # (layers, rows)
    fmt = lambda xs: "[" + ", ".join(f"{x:.2g}" for x in xs) + "]"  # noqa: E731
    log(f"  first dispatch, {n_rows} live rows x {n_layers} MoE layers, the plain path "
        f"dispatching the kernel path's routing; largest |deviation| / |row| after each "
        f"layer's router inputs, then the final rows: kernel vs plain {fmt(dev)}; noise floor "
        f"(plain path, one bf16 step on 1% of the embedding) {fmt(floor)}; tol 2^-7 "
        f"sqrt(layers) {tol[0]:.3g} .. {tol[-1]:.3g}")
    log(f"  elements outside one bf16 step (atol, rtol)={BF16_TOL}: layer 0 {outside[0]:.3%}, "
        f"final rows {outside[1]:.3%}; the plain path's own router would have chosen "
        f"differently on {int(flip.sum())} row-layers ({int(flip.any(0).sum())} of {n_rows} "
        f"rows)")
    for i, (d, t) in enumerate(zip(dev, tol)):
        where = "the final rows" if i == n_layers else f"layer {i}'s router inputs"
        check(d <= t, f"{where} differ by {d:.3g} of a row between the kernel and plain paths "
              f"(tol {t:.3g})")
    check(bool(torch.isfinite(rows_k).all()), "non-finite hidden rows on the first dispatch")


def tpot_ms(finished) -> list:
    """Per request: (done - first token) over the tokens after the first."""
    return [(r.t_done - r.t_first) * 1e3 / (len(r.out) - 1) for r in finished
            if r.t_done and r.t_first and len(r.out) > 1]


def pct(xs) -> str:
    a = np.asarray(xs, np.float64)
    return (f"p50 {np.percentile(a, 50):.1f} p90 {np.percentile(a, 90):.1f} "
            f"p99 {np.percentile(a, 99):.1f} (n {a.size})")


def phase_moe_served(cfg, plan):
    """The MoE main path: qwen3-moe-30b-a3b at full width and depth, bf16
    weights, on the derived H100 plan (128 slots x 256 rows, int8 pages),
    serving the multi-tenant trace.  Returns (launch counts, summary,
    params), the weights kept for phase 19's eager run."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_trace, per_class_report

    log(f"phase 18 (main path): {cfg.name} full width and depth ({cfg.n_layers} layers), bf16 "
        f"weights, on the derived H100 plan, trace {MOE_MIX} x 2 tenants")
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048)
    log(f"  {serve.describe()}")
    check((serve.decode_batch, serve.mixed_slab_width, serve.kv_dtype) == (128, 256, "int8"),
          "the derived plan is not 128 slots x 256 rows of int8 pages")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.bfloat16, generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params: {cfg.param_count() / 1e9:.2f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    trace = lambda: make_trace(cfg, MOE_MIX, tenants=2, stagger=1, seed=1,  # noqa: E731
                               max_tokens=512)
    # the first mixed dispatch: kernel path vs plain path (gathered pages,
    # plain norms), the plain path dispatching the kernel path's routing:
    # near-tied top-8 choices would otherwise flip on the paths' rounding
    # and change the rows' outputs
    kernel = first_dispatch(params, cfg, plan, serve, trace(), fused=True)
    plain_ = first_dispatch(params, cfg, plan, serve, trace(), fused=False, routing=kernel[3])
    saved = one_step_up(params, 0.01, seed=70)
    noise = first_dispatch(params, cfg, plan, serve, trace(), fused=False, routing=kernel[3])
    params["embed"].copy_(saved)
    del saved
    compare_first_dispatch(kernel, plain_, noise)
    del kernel, plain_, noise
    torch.cuda.empty_cache()

    reqs = trace()
    want_len = {r.rid: r.max_new_tokens for r in reqs}
    torch.cuda.reset_peak_memory_stats()
    out, counts, s, finished = serve_once(cfg, plan, serve, params, reqs, fused=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    describe("served", s)
    log(f"  peak device memory {peak:.2f} GiB; prefix {s['prefix']}")
    log(f"  TTFT ms {pct([(r.t_first - r.t_admit) * 1e3 for r in finished])}; TPOT ms "
        f"{pct(tpot_ms(finished))}; latency s {s['latency_s']}")
    classes = per_class_report(finished)
    log(f"  tenants {json.dumps(s['tenants'])}")
    log(f"  classes {json.dumps(classes)}")
    check(len(out) == len(reqs) and s["requests"]["finished"] == len(reqs),
          "not every request finished")
    check(all(len(out[r]) == n and all(0 <= t < cfg.vocab_size for t in out[r])
              for r, n in want_len.items()), "a request emitted too few tokens or one outside "
          "the vocab")
    check(s["faults"]["quarantines"] == 0 and s["requests"]["shed"] == 0,
          "non-finite logits or shedding")
    check(set(s["tenants"]) == {"tenant0", "tenant1"}, "the summary lacks a tenant")
    check(set(classes) == set(MOE_MIX), "the per-class report lacks a class")
    check(s["prefix"]["hits"] > 0, "no prefix hit on the shared system prompts")
    log(f"  kernel launches on the main path: {counts} ({s['steps']} dispatches: "
        f"{cfg.n_layers} paged, {norms_per_forward(cfg)} rmsnorm each)")
    return counts, {**s, "peak_gib": peak}, params


def phase_moe_eager(cfg_full, plan, params):
    """qwen3-moe-30b-a3b eager at full width and depth (phase 18's bf16
    weights): ``greedy_generate``, B 4 x 1024-token prompts, 8 new tokens,
    exact flash and RMSNorm launch counts."""
    from repro_torch.serve import greedy_generate

    B, S, n = MOE_EAGER_B, MOE_EAGER_PROMPT, MOE_EAGER_GEN
    log(f"phase 19: {cfg_full.name} served by greedy_generate, bf16, full depth, B={B}, "
        f"prompt {S}, {n} new tokens")
    tokens = prompts(cfg_full, B, S, seed=6)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg_full, plan, {"tokens": tokens}, n_steps=n,
                          cache_len=S + n, device="cuda").cpu()
    dt = time.perf_counter() - t0
    counts = read_counts()
    log(f"  {tuple(out.shape)} tokens in {dt:.3f} s ({B * n / dt:.1f} tok/s); launches {counts}")
    check(out.shape == (B, n) and int(out.min()) >= 0 and int(out.max()) < cfg_full.vocab_size,
          "tokens of the wrong shape or outside the vocab")
    want = expect_counts(flash_attention=cfg_full.n_layers,
                         rmsnorm=norms_per_forward(cfg_full) * n)
    check(counts == want, f"launches {counts}, expected {want} (one prefill, {n} forwards)")
    return counts


def phase_moe_paths(cfg_full, plan):
    """qwen3-moe-30b-a3b with depth cut to 4 layers, f32 weights and pages,
    untied head: the continuous kernel path against the gather path,
    identical greedy tokens (phase 3's check).  At capacity E / K, where
    no choice can drop: at 1.25 the slab's dead rows compete for capacity,
    and the kernel zeroes their attention output while the gather path
    attends them to the trash block, so the two paths drop different live
    choices (JAX's two paths do the same)."""
    import dataclasses

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params
    from repro_torch.serve import random_stream

    cfg = dataclasses.replace(cfg_full, n_layers=4, tie_embeddings=False,
                              moe_capacity_factor=float(cfg_full.n_experts // cfg_full.top_k))
    log(f"phase 19: {cfg.n_layers} layers at full width, f32 weights + pages, untied head, "
        f"capacity {cfg.moe_capacity_factor:g} (drop-free): kernel vs gather path")
    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048, decode_batch=8,
                              kv_dtype="fp32", rolled_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.float32, generator=gen, device="cuda")
    reqs = lambda: random_stream(cfg, 8, (100, 600), 16, stagger=2, seed=1)  # noqa: E731
    fused, k_counts, s1, _ = serve_once(cfg, plan, serve, params, reqs(), fused=True)
    describe("kernel", s1)
    gather, _, s2, _ = serve_once(cfg, plan, serve, params, reqs(), fused=False)
    describe("gather", s2)
    check(len(fused) == 8 and all(len(t) == 16 for t in fused.values()), "requests unfinished")
    first_diff = next((r for r in fused if fused[r] != gather[r]), None)
    log(f"  greedy tokens identical: {fused == gather} (first differing request: "
        f"{first_diff}); distinct tokens in req000: {len(set(fused['req000']))}/16; kernel "
        f"path launches {k_counts}")
    check(fused == gather, "kernel and gather paths disagree on greedy tokens")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- speculation
# Speculative decoding's verify rows: a decode slot carries gamma + 1 query
# rows at its length.  The tensor-core entry treats a slot as a decode item
# while G x q_len rows fit one 16-row mma block (q_len <= 8 at qwen3-1.7b's
# G 2), so those rows take the key-split route, with a causal edge between
# them; phases 2 and 6 hold that route at q_len 1 only.
VERIFY_QLENS = (2, 3, 5, 8)
GAMMA = 4
# Phase 21(b)'s trace: two tenants of chat and classify requests.
SPEC_MIX = {"chat": 4, "classify": 4}


def verify_lens(B, W, seed, *, qlens=VERIFY_QLENS, n_prefill=4, split=512, max_ctx=2048):
    """Slots cycle through ``qlens`` and 1 (a plain decode row); the first
    ``n_prefill`` prefill W/2..W rows; the last is idle.  Contexts are drawn
    up to max_ctx (1-4 key splits), and every third slot after the prefill
    ones has its last row's causal edge on a split boundary: the first key
    of split s or the last key of split s - 1, s in 1..3."""
    rng = np.random.default_rng(seed)
    cycle = list(qlens) + [1]
    q_lens = np.array([cycle[b % len(cycle)] for b in range(B)], np.int64)
    q_lens[:n_prefill] = rng.integers(W // 2, W + 1, n_prefill)
    lens = np.array([rng.integers(0, max_ctx - int(q)) for q in q_lens])
    for n, b in enumerate(range(n_prefill, B - 1, 3)):
        edge = (1 + n % 3) * split - (n // 3) % 2
        lens[b] = edge - q_lens[b] + 1
    q_lens[-1] = 0
    return lens, q_lens


def no_causal_edge(args, *, bs):
    """A planted control: every live row of a slot sees all the slot's keys
    up to its last row, as a kernel that dropped the causal edge between
    verify rows would compute."""
    from repro_torch.kernels.paged_attention.ref import masked_attention, paged_mask
    from repro_torch.models.cache import paged_gather

    q, entry, table, lens, q_lens = args
    if q.dtype == torch.float32 and entry["k"].dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    k, v = paged_gather(entry, table, bs)
    valid = paged_mask(lens, q_lens, q.shape[1], k.shape[1])
    last = (lens.long() + q_lens.long() - 1)[:, None, None]
    valid = valid.any(dim=-1, keepdim=True) & (
        torch.arange(k.shape[1], device=q.device)[None, None] <= last)
    return masked_attention(q, k, v, valid).to(q.dtype)


def phase_verify(cfg, moe_cfg):
    """Paged attention at verify-row shapes, kernel vs plain version (one
    bf16 step; f32 2e-5), each case with a planted control: the tensor-core
    entry at qwen3-1.7b's derived shape, the split scheme at verify rows,
    the CUDA-core entry with f32 and int8 pages at qwen3-moe-30b-a3b's G 8;
    then the times with all 256 slots at q_len gamma + 1."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_split_ref

    log(f"phase 20: paged attention at verify-row shapes (q_len 2-8 on decode slots)")
    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    errs = []
    lens, q_lens = verify_lens(256, W, seed=70)
    args = make_inputs(256, W, H, KH, D, bs, MB, "bfloat16", lens, q_lens,
                       q_dtype=torch.bfloat16, seed=70)
    ent = ops.ENTRIES[torch.bfloat16, torch.bfloat16]
    decode_items = int(((q_lens > 0) & (q_lens * (H // KH) <= ops.DEC_ROWS)).sum())
    _, want, err = compare(f"verify G {H // KH} B=256 W={W} bf16 pages ({ent}; {decode_items} "
                           f"decode items, q_lens {sorted(set(q_lens.tolist()))[:6]}...)",
                           args, bs=bs, window=0)
    errs.append(err)
    planted("causal edge between verify rows dropped", no_causal_edge(args, bs=bs), want,
            BF16_TOL)
    del args, want
    torch.cuda.empty_cache()
    # the scheme (splits, f32 partials, P as hi + lo) at verify rows, on 10
    # slots: its emulation loops over slots and warps
    lens, q_lens = verify_lens(10, 8, seed=71, n_prefill=0)
    args = make_inputs(10, 8, H, KH, D, bs, MB, "bfloat16", lens, q_lens,
                       q_dtype=torch.bfloat16, seed=71)
    _, want, err = compare("verify scheme slots (10 x 8 rows)", args, bs=bs, window=0)
    errs.append(err)
    scheme = lambda **kw: paged_attention_split_ref(*args, block_size=bs,  # noqa: E731
                                                    split=ops.SPLIT, **kw)
    ok, e, _ = within(scheme(), want, BF16_TOL)
    log(f"  scheme emulated at verify rows: max_abs_err={e:.3g} {'ok' if ok else 'MISMATCH'}")
    check(ok, "the emulated split scheme disagrees with the plain version at verify rows")
    planted("split 1 (keys 512-1023) left out of the combine at verify rows",
            scheme(drop_split=1), want, BF16_TOL)
    planted("P rounded once to bf16 at verify rows", scheme(p_split=False), want, BF16_TOL)
    del args, want
    # the CUDA-core entry at qwen3-moe-30b-a3b's heads (G 8): 8 rows a slot row
    H8, KH8 = moe_cfg.n_heads, moe_cfg.n_kv_heads
    for kv, qdt in (("float32", torch.float32), ("int8", torch.bfloat16)):
        lens, q_lens = verify_lens(128, W, seed=72, qlens=(2, 3, 4, 5))
        args = make_inputs(128, W, H8, KH8, D, bs, MB, kv, lens, q_lens, q_dtype=qdt, seed=72)
        _, want, err = compare(f"verify G {H8 // KH8} B=128 {kv} pages, {str(qdt)[6:]} q "
                               f"({ops.ENTRIES[qdt, args[1]['k'].dtype]})", args, bs=bs,
                               window=0)
        errs.append(err)
        planted(f"causal edge dropped ({kv} pages)", no_causal_edge(args, bs=bs), want,
                tolerance(qdt))
        if kv == "int8":
            planted("int8 pages without their scales at verify rows", unscaled(args, bs=bs),
                    want, BF16_TOL)
        del args, want
        torch.cuda.empty_cache()
    err, times = phase_times(cfg, "verify", B=256, n_prefill=0, seed=73, q_len=GAMMA + 1)
    errs.append(err)
    return max(errs), times


def spec_plans(cfg):
    """Phase 21(a)'s and 22's plan: 32 slots x a 16-row slab, f32 pages,
    1024 positions, K = 1; and its speculative twin (gamma 4)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan

    kw = dict(max_seq_len=1024, decode_batch=32, prefill_chunk=16, mixed_slab_width=16,
              kv_dtype="fp32", rolled_steps=1)
    base = derive_serve_plan(cfg, MESH1, H100_SXM, **kw)
    spec = derive_serve_plan(cfg, MESH1, H100_SXM, draft=cfg.name, spec_len=GAMMA, **kw)
    return base, spec


def spec_stream(cfg):
    from repro_torch.serve import random_stream

    return random_stream(cfg, 8, (100, 300), 16, stagger=2, seed=1)


def phase_spec_self(cfg, plan, params):
    """qwen3-1.7b full width and depth in f32 (untied head): a self-drafting
    ModelDraft (the target's weights, its own paged pool and mixed step) at
    gamma 4 against the non-speculative engine on the same stream:
    identical tokens, and exact launch counts (both engines' forwards run
    the paged kernel once a layer and the RMSNorm kernel once a norm).
    Returns the non-speculative tokens (phase 22's clean run)."""
    from repro_torch.serve import ModelDraft, ServingEngine

    base, spec = spec_plans(cfg)
    log(f"phase 21(a): {cfg.name} f32 full depth, untied head, 32 slots x 16 rows: a "
        f"self-drafting ModelDraft at gamma {spec.spec_len} vs no speculation")
    plain_out, _, s0, _ = serve_once(cfg, plan, base, params, spec_stream(cfg), fused=True)
    describe("no speculation", s0)
    draft = ModelDraft(params, cfg, plan, base, target_vocab=cfg.vocab_size, device="cuda")
    engine = ServingEngine(params, cfg, plan, spec, draft=draft, device="cuda")
    reset_counts()  # count this run's launches only
    out = engine.run(spec_stream(cfg))
    counts = read_counts()
    s = engine.summary()
    describe("speculative", s)
    fwd = s["dispatches"] + draft.dispatch_counts["draft_step"]
    want = expect_counts(paged_attention=cfg.n_layers * fwd, rmsnorm=norms_per_forward(cfg) * fwd)
    log(f"  spec {json.dumps(s['spec'])}; launches {counts} over {s['dispatches']} target and "
        f"{draft.dispatch_counts['draft_step']} draft dispatches")
    check(counts == want, f"launches {counts}, expected {want}")
    check(len(out) == 8 and all(len(t) == 16 for t in out.values()), "requests unfinished")
    first_diff = next((r for r in out if out[r] != plain_out[r]), None)
    log(f"  speculative tokens identical to the plain engine's: {out == plain_out} (first "
        f"differing request: {first_diff}); distinct tokens in req000: "
        f"{len(set(out['req000']))}/16")
    check(out == plain_out, "speculative tokens differ from the non-speculative engine's")
    check(s["spec"]["draft_rows"] > 0 and s["spec"]["acceptance_rate"] > 0.5,
          "the self-drafting ModelDraft was not accepted")
    del engine, draft
    torch.cuda.empty_cache()
    return plain_out


def phase_spec_served(cfg, plan):
    """This slice's main path: qwen3-1.7b bf16 on the derived plan (256 x
    256, bf16 pages), n-gram drafting at gamma 4, a make_trace replay with
    tracing on; the same stream without speculation for the dispatch time.
    Returns (launch counts, summary)."""
    import tempfile

    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.plan import derive_serve_plan
    from repro_torch.models.params import init_params
    from repro_torch.obs import Observability, prometheus_roundtrip_ok, validate_chrome_trace
    from repro_torch.serve import NGramDraft, ServingEngine, make_trace

    serve = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048)
    spec = derive_serve_plan(cfg, MESH1, H100_SXM, max_seq_len=2048, draft="ngram",
                             spec_len=GAMMA)
    log(f"phase 21(b) (main path): {cfg.name} bf16 on the derived plan, n-gram drafting at "
        f"gamma {spec.spec_len}, trace {SPEC_MIX} x 2 tenants, tracing on")
    log(f"  {spec.describe()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, plan, torch.bfloat16, generator=gen, device="cuda")
    trace = lambda: make_trace(cfg, SPEC_MIX, tenants=2, stagger=1, seed=1,  # noqa: E731
                               max_tokens=512)
    plain_out, _, s0, _ = serve_once(cfg, plan, serve, params, trace(), fused=True)
    describe("no speculation", s0)
    obs = Observability(tracing=True)
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(params, cfg, plan, spec, draft=NGramDraft(), obs=obs, device="cuda")
    reqs = trace()
    reset_counts()  # count this run's launches only
    out = engine.run(reqs)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    s = engine.summary()
    describe("speculative", s)
    log(f"  spec {json.dumps(s['spec'])}; peak device memory {peak:.2f} GiB")
    log(f"  mean dispatch ms: speculative {s['mean_dispatch_ms']:.2f} over {s['dispatches']} "
        f"dispatches vs {s0['mean_dispatch_ms']:.2f} over {s0['dispatches']} without; "
        f"tok/s {s['tok_per_s']:.1f} vs {s0['tok_per_s']:.1f}; requests with the plain "
        f"engine's tokens: {sum(out[r] == plain_out.get(r) for r in out)}/{len(out)}")
    want = expect_counts(paged_attention=cfg.n_layers * s["steps"],
                         rmsnorm=norms_per_forward(cfg) * s["steps"])
    log(f"  kernel launches on the main path: {counts} ({s['steps']} dispatches)")
    check(counts == want, f"launches {counts}, expected {want}")
    check(len(out) == len(reqs) and s["requests"]["finished"] == len(reqs)
          and all(len(out[r.rid]) == r.max_new_tokens for r in reqs),
          "not every request finished with its tokens")
    # random weights rarely repeat an n-gram, so the drafter may propose
    # little here (phase 21(a) holds the verify path with drafts accepted)
    check(s["spec"]["enabled"] and s["spec"]["spec_len"] == GAMMA, "speculation is off")
    check(s["faults"]["quarantines"] == 0, "non-finite logits")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        n = obs.tracer.write(path)
        with open(path) as f:
            events = validate_chrome_trace(json.load(f))
    names = {e["name"] for e in events}
    log(f"  Chrome trace: {n} events, names {sorted(names)}, dropped "
        f"{obs.tracer.dropped}; Prometheus text {len(obs.metrics.to_prometheus())} bytes")
    check(len(events) == n > 0 and {"request", "first-token", "step"} <= names
          and ("spec-verify" in names) == (s["spec"]["tokens_per_spec_step"] is not None),
          "the Chrome trace lacks request lifecycles, dispatch or verify spans")
    check(prometheus_roundtrip_ok(obs.metrics), "the Prometheus text does not round-trip")
    cal = s["calibration"]
    for ph, rep in cal["phases"].items():
        roof = rep["predicted_ms_mean"] - H100_SXM.dispatch_overhead_s * 1e3
        log(f"  drift {ph}: n {rep['n']}, measured {rep['measured_ms_mean']:.3f} ms vs "
            f"predicted {rep['predicted_ms_mean']:.3f} ms a dispatch, ratio {rep['ratio']:.2f} "
            f"(p50 {rep['ratio_p50']:.2f}, p90 {rep['ratio_p90']:.2f}); implied per-dispatch "
            f"overhead beyond the roofline {rep['measured_ms_mean'] - roof:.3f} ms")
    log(f"  calibration: {cal['note']}")
    check(all(np.isfinite(rep["ratio"]) for rep in cal["phases"].values()) and cal["phases"],
          "no calibrated dispatch")
    del engine, params
    torch.cuda.empty_cache()
    return counts, {**s, "peak_gib": peak, "plain_mean_dispatch_ms": s0["mean_dispatch_ms"]}


def chaos_seed(rate, horizon, gap):
    """The first injector seed whose transient schedule trips at least once
    after the first two iterations, and never twice within ``gap``
    iterations, inside the horizon (the injector's draw at each
    iteration): with bursts longer than the retry limit each trip steps
    the ladder down one rung, and the next one waits until it has climbed
    back, so the ladder cannot run out."""
    from repro_torch.serve import FaultInjector

    for seed in range(10_000):
        inj = FaultInjector(seed, transient_rate=rate)
        trips = [t for t in range(horizon) if inj._rng(t, 1).random() < rate]
        if trips and trips[0] >= 2 and all(b - a > gap for a, b in zip(trips, trips[1:])):
            return seed
    raise RuntimeError("no chaos seed fits")


def phase_chaos(cfg, plan, params, clean):
    """Hardening on the card at phase 21(a)'s plan (f32): one chaos run
    (transient bursts past the retry limit, NaN poison, pool pressure,
    latency spikes, from one seed): the ladder reaches rung 2 (the gather
    step) and climbs back, every request that finishes has the clean run's
    tokens, poisoned slots are quarantined, no block leaks; then a snapshot
    taken mid-stream, restored on a fresh engine, finishes with the clean
    tokens."""
    import dataclasses

    from repro_torch.serve import FaultInjector, ServingEngine

    base, _ = spec_plans(cfg)
    serve = dataclasses.replace(base, retry_limit=2, ladder_recovery=4)
    rate, horizon = 0.1, 60
    seed = chaos_seed(rate, horizon, gap=serve.ladder_recovery + 2)
    inj = FaultInjector(seed, transient_rate=rate, transient_burst=serve.retry_limit + 2,
                        nan_rate=0.02, pressure_rate=0.1, pressure_frac=0.3, pressure_steps=3,
                        spike_rate=0.1, spike_ms=2.0, horizon=horizon)
    log(f"phase 22: {cfg.name} f32 at phase 21(a)'s plan, chaos {inj.to_record()}")
    engine = ServingEngine(params, cfg, plan, serve, injector=inj, device="cuda")
    for r in spec_stream(cfg):
        engine.submit(r)
    reset_counts()
    rungs = []
    while not engine.sched.idle and engine.iteration < 10_000:
        engine.step()
        rungs.append(engine.rung)
    counts = read_counts()
    s = engine.summary()
    out = {r.rid: list(r.out) for r in engine.sched.finished}
    d = engine.dispatch_counts
    log(f"  faults {json.dumps({k: v for k, v in s['faults'].items() if k != 'injector'})}; "
        f"injected {inj.counts}; dispatches {d}")
    log(f"  rungs by iteration: {''.join(str(r) for r in rungs)}")
    log(f"  finished {len(out)}/8, {s['requests']}; launches {counts}")
    want = expect_counts(paged_attention=cfg.n_layers * d["step"],
                         rmsnorm=norms_per_forward(cfg) * d["step"])
    check(counts == want, f"launches {counts}, expected {want} (the gather rung launches none)")
    check(2 in rungs and d.get("fallback_step", 0) >= 1, "the ladder never reached rung 2")
    check(rungs[-1] == 1 and s["faults"]["rung_recoveries"] >= 1,
          "the ladder did not climb back to the mixed rung")
    check(s["faults"]["quarantines"] >= 1 and inj.counts["nan"] >= 1,
          "no poisoned slot was quarantined")
    check(all(out[r] == clean[r] for r in out) and len(out) + s["requests"]["poisoned"] == 8,
          "a request that finished ok differs from the clean run")
    inj.release(engine.sched.alloc)
    check(engine.sched.alloc.in_use == 0, "the chaos run leaked blocks")
    del engine
    torch.cuda.empty_cache()

    engine = ServingEngine(params, cfg, plan, base, device="cuda")
    for r in spec_stream(cfg):
        engine.submit(r)
    while engine.stats["generated_tokens"] < 40 and not engine.sched.idle:
        engine.step()
    snap = json.dumps(engine.snapshot())
    at = (engine.iteration, engine.stats["generated_tokens"], len(engine.sched.finished))
    del engine
    torch.cuda.empty_cache()
    fresh = ServingEngine(params, cfg, plan, base, device="cuda")
    fresh.restore(json.loads(snap))
    restored = fresh.run()
    log(f"  snapshot at iteration {at[0]} ({at[1]} tokens, {at[2]} finished; {len(snap)} bytes "
        f"of JSON), restored on a fresh engine: clean tokens {restored == clean}")
    check(restored == clean, "the restored engine's tokens differ from the clean run's")
    del fresh
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main
def main() -> None:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device visible; this script needs one GPU")
        sys.exit(2)
    t_start = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi gave nothing"

    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mm_pu import kernel as mm_pu_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel

    log(f"phase 1: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (paged_kernel, wkv_kernel, flash_kernel, rmsnorm_kernel, mm_pu_kernel)
    t0 = time.time()
    _build.build_all([k.SOURCE for k in kernels])  # one nvcc per source, in parallel
    for k in kernels:
        k.library()
    log(f"  built + loaded {len(kernels)} kernel libraries in {time.time() - t0:.1f} s")
    for k in kernels:
        ptxas = _build.library_path(k.SOURCE).with_suffix(".log")
        if ptxas.exists():
            lines = ptxas.read_text().splitlines()
            used = [ln.strip() for ln in lines if "Used" in ln]
            spills = [ln.strip() for ln in lines
                      if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
            log(f"  {lines[0]}; ptxas: {len(used)} kernels; registers "
                f"{sorted({ln.split('Used ')[1].split(' registers')[0] for ln in used})}; "
                f"spill lines: {spills[:4]}")

    cfg = get_config(SERVE_ARCH)
    plan = derive_execution_plan(cfg)
    max_err = phase_kernels(cfg)
    phase_parity(cfg, plan)
    served_counts, served = phase_served(cfg, plan)
    phase_rolled(cfg, plan)
    log("phase 6: kernel vs plain version and times at the main path's shapes "
        "(derived plan: 256 slots x 256 rows)")
    err_d, decode = phase_times(cfg, "decode", B=256, n_prefill=0, seed=40)
    err_m, mixed = phase_times(cfg, "mixed", B=256, n_prefill=32, seed=41)
    max_err = max(max_err, err_d, err_m)
    log(f"  mixed shape: {json.dumps(mixed)}")

    wkv_err, wkv_times = phase_wkv(get_config(RWKV_ARCH))
    flash_err, flash_times = phase_flash(cfg)
    rwkv_counts, rwkv_run = phase_eager(RWKV_ARCH, "wkv", 9)
    qwen_counts, qwen_run = phase_eager(SERVE_ARCH, "flash_attention", 10)
    phase_paths()
    phase_engine_vs_eager()
    log(f"  eager runs: {json.dumps({RWKV_ARCH: rwkv_run, SERVE_ARCH: qwen_run})}")
    rms_err, rms_times_ = phase_rmsnorm(cfg)
    log(f"  rmsnorm times: {json.dumps(rms_times_)}")
    mm_err = phase_mm_pu()
    ffn_err, mm_launches, mm_times = phase_int8_ffn(cfg)
    log(f"  int8 FFN times: {json.dumps(mm_times)}")

    moe_cfg = get_config(MOE_ARCH)
    moe_plan = derive_execution_plan(moe_cfg)
    log(f"phase 16: paged attention with int8 pages at {MOE_ARCH}'s plan shapes (128 slots x "
        f"256 rows, H {moe_cfg.n_heads}, KH {moe_cfg.n_kv_heads}, G "
        f"{moe_cfg.n_heads // moe_cfg.n_kv_heads}): the CUDA-core entry")
    err_d8, decode8 = phase_times(moe_cfg, "int8 decode", B=128, n_prefill=0, seed=60,
                                  kv="int8")
    err_m8, mixed8 = phase_times(moe_cfg, "int8 mixed", B=128, n_prefill=16, seed=61,
                                 kv="int8")
    log(f"  int8 mixed shape: {json.dumps(mixed8)}")
    flash_err8, rms_err8 = phase_moe_shapes(moe_cfg)
    flash_err, rms_err = max(flash_err, flash_err8), max(rms_err, rms_err8)
    moe_parts = phase_moe(moe_cfg)
    moe_counts, moe_served, moe_params = phase_moe_served(moe_cfg, moe_plan)
    phase_moe_eager(moe_cfg, moe_plan, moe_params)
    del moe_params
    torch.cuda.empty_cache()
    phase_moe_paths(moe_cfg, moe_plan)
    log(f"  MoE layer parts (ms): {json.dumps(moe_parts)}")
    log(f"  MoE served: {json.dumps({k: moe_served[k] for k in ('mean_dispatch_ms', 'tok_per_s', 'peak_gib', 'slab', 'ttft_s', 'latency_s')})}")

    verify_err, verify_times = phase_verify(cfg, moe_cfg)
    cfg32, plan32, params32 = eager_model(SERVE_ARCH, torch.float32, untie=True)
    clean = phase_spec_self(cfg32, plan32, params32)
    del params32
    torch.cuda.empty_cache()
    spec_counts, spec_served = phase_spec_served(cfg, plan)
    cfg32, plan32, params32 = eager_model(SERVE_ARCH, torch.float32, untie=True)  # same seed
    phase_chaos(cfg32, plan32, params32, clean)
    del params32
    torch.cuda.empty_cache()
    log(f"  speculative served: {json.dumps({k: spec_served[k] for k in ('mean_dispatch_ms', 'plain_mean_dispatch_ms', 'tok_per_s', 'peak_gib', 'spec', 'ttft_s', 'latency_s')})}")
    log(f"total {time.time() - t_start:.1f} s")
    records = [
        {
            "name": "paged_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
            "launches": served_counts["paged_attention"],
            "max_abs_err": max_err,
            **decode,
        },
        {
            "name": "wkv",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:32",
            "launches": rwkv_counts["wkv"],
            "max_abs_err": wkv_err,
            **wkv_times,
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
            "launches": qwen_counts["flash_attention"],
            "max_abs_err": flash_err,
            **flash_times,
        },
        {
            "name": "rmsnorm",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:19",
            "launches": served_counts["rmsnorm"],
            "max_abs_err": rms_err,
            **rms_times_["slab"],
        },
        {
            "name": "mm_pu",
            "route": "cuda",
            "source": "src/repro_torch/kernels/mm_pu/csrc/mm_pu.cu",
            "replaces": "src/repro/kernels/mm_pu/kernel.py:41",
            "launches": mm_launches,
            "max_abs_err": max(mm_err, ffn_err),
            **mm_times[f"T={EAGER_PROMPT} w1 silu"],
        },
        {
            "name": "paged_attention_int8",
            "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
            "launches": moe_counts["paged_attention"],
            "max_abs_err": max(err_d8, err_m8),
            **decode8,
        },
        {
            "name": "paged_attention_verify",
            "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
            "launches": spec_counts["paged_attention"],
            "max_abs_err": verify_err,
            **verify_times,
        },
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)
