"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the repository around it (it imports ``src/
repro_torch``); without either it exits non-zero and prints no result.  It
builds the CUDA kernels from the checkout, holds each against its plain
PyTorch version at the main path's shapes, serves qwen3-1.7b at full width
and depth through the port's continuous-batching engine (random weights
from a seed), checks the outputs, times the kernels, and prints:

* the card's name and power limit (``nvidia-smi``);
* one JSON line ``{"kernels": [...]}`` (times, launches on the main path,
  byte/operation bound, plain-version and library times);
* last, ``{"ok": true, "device": {...}}``.

Phases: 1 setup + build, 2 kernel vs plain version, 3 full-depth f32
serving with the kernel vs the gather path (identical tokens), 4 bf16
serving on the derived H100 plan (the main path whose launches are
counted), 5 rolled decode loop (K=4 vs K=1), 6 kernel vs plain version
at the derived plan's decode and mixed shapes (256 slots x 256 rows), and
kernel timing.  Planted controls (a dropped key tile, a window boundary
one key off) show that the tolerances reject a wrong kernel.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor, f32 CUDA-core
SERVE_ARCH = "qwen3-1.7b"
MESH1 = {"data": 1, "model": 1}


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


def main_path_lens(B, W, n_prefill, seed, max_ctx=2048):
    """Slots 0..n_prefill-1 prefill up to W rows, the rest decode one;
    contexts up to max_ctx."""
    rng = np.random.default_rng(seed)
    q_lens = np.ones(B, np.int64)
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


def phase_kernels(cfg):
    log("phase 2: kernel vs plain version on the card")
    errs = []
    for n, (B, W, H, KH, D, bs, MB, kv, window) in enumerate(SMALL_CASES):
        lens, q_lens = small_case_lens(B, W, bs, MB, seed=n)
        args = make_inputs(B, W, H, KH, D, bs, MB, kv, lens, q_lens, seed=n)
        errs.append(compare(f"case{n} {kv} W={W} window={window}", args, bs=bs,
                            window=window)[2])
    # the schedule knob changes nothing: rows per CUDA block (the CUDA
    # analogue of the TPU kernel's pages_per_tile sweep)
    lens, q_lens = small_case_lens(2, 4, 4, 16, seed=7)
    args = make_inputs(2, 4, 4, 2, 32, 4, 16, "float32", lens, q_lens, seed=7)
    outs = [compare(f"sweep rows_per_cta={r}", args, bs=4, window=0, rows_per_cta=r)[0]
            for r in (1, 2, 4, 32)]
    spread = max(float((o - outs[0]).abs().max()) for o in outs)
    log(f"  sweep spread={spread:.3g}")
    check(spread <= 1e-6, "rows_per_cta changes the numbers")
    # pages wholly below the window are never read: corrupting them is inert
    q, entry, _, _, _ = make_inputs(1, 1, 2, 1, 32, 4, 8, "float32", [0], [1], seed=8)
    table = (torch.arange(8, dtype=torch.int32, device="cuda") + 1)[None]
    lens = torch.tensor([28], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([1], dtype=torch.int32, device="cuda")
    base = compare("swa clean", (q, entry, table, lens, q_lens), bs=4, window=8)[0]
    smashed = {"k": entry["k"].clone(), "v": entry["v"].clone()}
    smashed["k"][1:4], smashed["v"][1:4] = 1e3, -1e3
    got = compare("swa corrupted dead pages", (q, smashed, table, lens, q_lens), bs=4,
                  window=8)[0]
    check(float((got - base).abs().max()) <= 1e-6, "dead pages below the window leaked")

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
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serve import ServingEngine

    engine = ServingEngine(params, cfg, plan, serve, fused=fused, device="cuda")
    ops.LAUNCHES = 0  # count this run's launches only
    out = engine.run(reqs)
    launches = ops.LAUNCHES
    summary = engine.summary()
    del engine
    torch.cuda.empty_cache()
    return out, launches, summary


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
    fused, launches, s1 = serve_once(cfg, plan, serve, params, reqs(), fused=True)
    describe("kernel", s1)
    gather, g_launches, s2 = serve_once(cfg, plan, serve, params, reqs(), fused=False)
    describe("gather", s2)
    check(len(fused) == 8 and all(len(t) == 16 for t in fused.values()), "requests unfinished")
    same = fused == gather
    first_diff = next((r for r in fused if fused[r] != gather[r]), None)
    log(f"  greedy tokens identical: {same} (first differing request: {first_diff})")
    check(same, "kernel and gather paths disagree on greedy tokens")
    check(launches == cfg.n_layers * s1["dispatches"] and g_launches == 0,
          f"launches {launches} != {cfg.n_layers} x {s1['dispatches']} mixed steps")
    log(f"  kernel launches {launches} = {cfg.n_layers} layers x {s1['dispatches']} steps")
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
    out, launches, s = serve_once(cfg, plan, serve, params, reqs, fused=True)
    describe("served", s)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(s["requests"]["finished"] == 64 and len(out) == 64, "not every request finished")
    check(all(len(t) == 16 and all(0 <= x < cfg.vocab_size for x in t) for t in out.values()),
          "a request emitted a token outside the vocab or too few tokens")
    check(s["requests"]["shed"] == 0, "requests were shed")
    # the engine quarantines (and replays) a slot whose logits are not finite
    check(s["quarantines"] == 0, "non-finite logits")
    # one launch per layer per device iteration (mixed step or rolled one)
    check(launches > 0 and launches == cfg.n_layers * s["steps"],
          f"main path launched the kernel {launches} times for {s['steps']} iterations")
    log(f"  kernel launches on the main path: {launches}")
    del params
    torch.cuda.empty_cache()
    return launches, s


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
        runs[k], _, s = serve_once(cfg, plan, serve, params, reqs, fused=True)
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
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
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


def phase_times(cfg, name, B, n_prefill, seed):
    """Kernel vs plain version at one of the main path's shapes (the derived
    plan's B slots x 256-row slab over its 32,769-block pool), then times."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    lens, q_lens = main_path_lens(B, W, n_prefill, seed)
    args = make_inputs(B, W, H, KH, D, bs, MB, "bfloat16", lens, q_lens,
                       q_dtype=torch.bfloat16, seed=seed)
    q, entry, table, lens_t, q_lens_t = args
    before = ops.LAUNCHES
    _, want, err = compare(f"{name} B={B} bf16 pages", args, bs=bs, window=0)
    if n_prefill == 0:  # decode rows: skipping a slot's last 32-key tile must not pass
        planted("last 32-key tile dropped", drop_last_tile(args, bs=bs), want, BF16_TOL)
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
    log(f"  {name}: B={B} W={W} H={H} KH={KH} D={D} bf16 pages, {n_prefill} prefill "
        f"slots, live keys/slot mean {float((lens + q_lens).mean()):.0f}: kernel {ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of roofline), plain {plain_ms:.3f} ms, "
        f"gather+SDPA {lib_ms:.3f} ms")
    del args, q, entry
    torch.cuda.empty_cache()
    return err, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms}


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
    from repro_torch.kernels.paged_attention import kernel

    log(f"phase 1: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    kernel.library()
    log(f"  built + loaded {kernel.SOURCE.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    ptxas = _build.library_path(kernel.SOURCE).with_suffix(".log")
    if ptxas.exists():
        used = [ln.strip() for ln in ptxas.read_text().splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in ptxas.read_text().splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"  ptxas: {len(used)} kernels; {used[:1]} ... ; spill lines: {spills[:4]}")

    cfg = get_config(SERVE_ARCH)
    plan = derive_execution_plan(cfg)
    max_err = phase_kernels(cfg)
    phase_parity(cfg, plan)
    launches, served = phase_served(cfg, plan)
    phase_rolled(cfg, plan)
    log("phase 6: kernel vs plain version and times at the main path's shapes "
        "(derived plan: 256 slots x 256 rows)")
    err_d, decode = phase_times(cfg, "decode", B=256, n_prefill=0, seed=40)
    err_m, mixed = phase_times(cfg, "mixed", B=256, n_prefill=32, seed=41)
    max_err = max(max_err, err_d, err_m)
    log(f"  mixed shape: {json.dumps(mixed)}")
    log(f"total {time.time() - t_start:.1f} s")
    record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:52",
        "launches": launches,
        "max_abs_err": max_err,
        **decode,
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
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
