"""Time variants of the port's CUDA kernels on one CUDA card, against the
committed sources, in one process.

    python3 scripts/kernel_variants.py [flash] [mm_pu] [paged] [rmsnorm]

(no argument: all four).  Each variant is the committed source with a few
lines replaced (``VARIANTS`` below: other tile constants, and diagnostics
that leave a part out, whose results may be wrong by design), or the
committed library launched with other runtime arguments (``RUNS``: the
paged kernel's key split, the norm's launch plan).  All sources are built
in parallel (one ``nvcc`` each, under ``build/kernel_variants/``), bound
with ``ctypes`` and launched through the wrappers' own ``launch`` on the
main shapes: flash at the qwen3-1.7b prefill (B 8, S 2048, H 16, KH 8,
D 128, bf16, causal); MM PU at the int8 FFN stage's T=2048 ``w1`` (2048 x
2048 @ 2048 x 6144, silu) and T=256 ``w2`` (256 x 6144 @ 6144 x 2048)
products, int8 and bf16 w; paged attention at ``chip_smoke.py`` phase 6's
decode and mixed shapes (256 slots x 256-row slab, bf16 pages), with the
CUDA-core entry (``paged_attention_forward``) and, as a diagnostic, its grid
cut to row block 0 (the gap is what its dead CTAs cost); RMSNorm at the
continuous slab (65,536 x 2048 bf16), the prefill rows (16,384 x 2048) and
the slab's q view (65,536 x 16 x 128, token stride 4096).  Each variant is
timed twice, the list in order and then reversed (A..Z..A), so that the
order of the runs favours none.  Prints the card's name and power limit,
each variant's registers and spills, and per shape and variant: whether it
matches the plain version within one bf16 step, and its two times.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MM_TILE = "constexpr int BM = 128, BN = 128, BK = 64;"
MM_STAGES = "constexpr int kStages = 3;"
MM_WARPS = "constexpr int kWarpsM = 2, kWarpsN = 4;"
FLASH_STAGES = "constexpr int kStages = 2;          // K/V ring depth"
FLASH_KEYS = "constexpr int kKeys = 64;           // keys per tile"
FLASH_BOUNDS = "__launch_bounds__(kThreads, 1)\nflash_attention_mma_kernel("
PAGED_STAGES = "constexpr int kStages = 2;          // K/V ring depth"
PAGED_GRID = "dim3 grid((W + rows_per_cta - 1) / rows_per_cta, KH, B);"
RMS_AHEAD = "constexpr bool kAhead = GL < 32;"
RMS_ROWS = "constexpr int kRows = NV >= 4 ? 1 : 4 / NV;"
RMS_LOAD = "if (j < nvec) v[k][t] = *reinterpret_cast<const uint4*>(xr + j * VEC);"
RMS_STORE = "  *reinterpret_cast<uint4*>(yr + j * VEC) = Vec<T>::pack(f);"
VARIANTS = {
    "flash": {
        "committed": [],
        "3 stages": [(FLASH_STAGES, FLASH_STAGES.replace("2;", "3;"))],
        "32-key tiles, 3 CTAs an SM": [
            (FLASH_KEYS, FLASH_KEYS.replace("64;", "32;")),
            (FLASH_BOUNDS, FLASH_BOUNDS.replace("kThreads, 1", "kThreads, 3"))],
    },
    "mm_pu": {
        "committed": [],
        "32-deep slices, 4 stages": [(MM_TILE, MM_TILE.replace("BK = 64", "BK = 32")),
                                     (MM_STAGES, "constexpr int kStages = 4;")],
        "64 x 64 warp tiles (4 warps)": [(MM_WARPS, MM_WARPS.replace("kWarpsN = 4", "kWarpsN = 2"))],
        "128 x 256 CTA tile (16 warps)": [(MM_TILE, MM_TILE.replace("BN = 128", "BN = 256")),
                                          (MM_WARPS, MM_WARPS.replace("kWarpsN = 4", "kWarpsN = 8"))],
        "diagnostic: no loads in the K loop": [
            ("      if (nxt < nk)\n        load_slice", "      if (nxt < nk && sl < 0)\n        load_slice")],
        "diagnostic: no epilogue": [
            ("        finish4(v, m, n, N,", "        if (v.x == 12345.f) finish4(v, m, n, N,")],
        "diagnostic: no mma": [
            ("          mma_bf16_16816(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], "
             "bfr[j >> 1][2 * (j & 1) + 1]);",
             "          acc[i][j][0] += __uint_as_float(af[i][0] ^ bfr[j >> 1][2 * (j & 1)]);")],
    },
    "paged": {
        "committed": [],
        "ring depth 3": [(PAGED_STAGES, PAGED_STAGES.replace("2;", "3;"))],
        "CUDA-core entry, grid cut to row block 0 (diagnostic)": [(PAGED_GRID,
                                                                   "dim3 grid(1, KH, B);")],
    },
    "rmsnorm": {
        "committed": [],
        "rows in flight ahead on every row": [(RMS_AHEAD, "constexpr bool kAhead = true;")],
        "no rows in flight ahead": [(RMS_AHEAD, "constexpr bool kAhead = false;")],
        "half the rows a group": [(RMS_ROWS, "constexpr int kRows = NV >= 2 ? 1 : 2 / NV;")],
        "twice the rows a group": [
            (RMS_ROWS, "constexpr int kRows = NV >= 16 ? 1 : NV >= 4 ? 2 : 8 / NV;")],
        "evict-first loads and stores (.cs)": [
            (RMS_LOAD, RMS_LOAD.replace("*reinterpret_cast<const uint4*>(xr + j * VEC)",
                                        "__ldcs(reinterpret_cast<const uint4*>(xr + j * VEC))")),
            (RMS_STORE, "  __stcs(reinterpret_cast<uint4*>(yr + j * VEC), Vec<T>::pack(f));")],
    },
}
# Runs of a built variant with other runtime arguments: tag -> (variant, arguments).
RUNS = {
    "paged": {
        "committed": ("committed", {}),
        "split 256": ("committed", {"split": 256}),
        "split 1024": ("committed", {"split": 1024}),
        "ring depth 3": ("ring depth 3", {}),
        "CUDA-core entry": ("committed", {"core": True}),
        "CUDA-core entry, grid cut to row block 0 (diagnostic)": (
            "CUDA-core entry, grid cut to row block 0 (diagnostic)", {"core": True}),
    },
    "rmsnorm": {
        "committed": ("committed", {}),
        "F.rms_norm (library call)": (None, {}),
        "half the rows a group": ("half the rows a group", {"rows": 0.5}),
        "twice the rows a group": ("twice the rows a group", {"rows": 2}),
        "one wave of resident CTAs (2 an SM), grid stride": ("committed", {"ctas_per_sm": 2}),
        "one pass, no grid stride (a CTA per 8 warps' rows)": ("committed", {"ctas_per_sm": 0}),
        "rows in flight ahead on every row": ("rows in flight ahead on every row", {}),
        "no rows in flight ahead": ("no rows in flight ahead", {}),
        "evict-first loads and stores (.cs)": ("evict-first loads and stores (.cs)", {}),
    },
}


def write_variant(source: Path, tag: str, subs) -> Path:
    """``source`` with ``subs`` applied, under build/kernel_variants/."""
    common = ROOT / "src/repro_torch/kernels/csrc/common.cuh"
    text = source.read_text().replace('#include "../../csrc/common.cuh"', f'#include "{common}"')
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {tag!r}: {old!r} is not in {source.name}")
        text = text.replace(old, new)
    slug = hashlib.sha1(tag.encode()).hexdigest()[:8]
    path = ROOT / "build/kernel_variants" / f"{source.stem}-{slug}" / source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def bind(path: Path, argtypes: dict) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(_build.library_path(path)))
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def timed(variants: dict, make_run, want) -> None:
    """Each variant: (matches within one bf16 step, max abs error), then
    its times in list order and in reversed order."""
    import chip_smoke as cs

    times = {tag: [] for tag in variants}
    for order in (list(variants), list(reversed(variants))):
        for tag in order:
            times[tag].append(cs.time_ms(make_run(variants[tag])))
    for tag, lib in variants.items():
        ok, err, _ = cs.within(make_run(lib)(), want, cs.BF16_TOL)
        print(f"    {tag}: matches {ok} (max abs err {err:.3g}), ms {times[tag][0]:.4f} / "
              f"{times[tag][1]:.4f}", flush=True)


def paged_core(lib, q, entry, table, lens, q_lens, bs, stream):
    """The CUDA-core entry (``paged_attention_forward``) on bf16 q and pages,
    as the wrapper launched it before the tensor-core entry."""
    import math

    import torch

    B, W, H, D = q.shape
    KH = entry["k"].shape[2]
    out = torch.empty_like(q)
    rc = lib.paged_attention_forward(
        q.data_ptr(), entry["k"].data_ptr(), entry["v"].data_ptr(), None, None, table.data_ptr(),
        lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(), B, W, H, KH, D, bs, table.shape[1],
        0, 64 // (H // KH), 1.0 / math.sqrt(D), 1, 1, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_forward failed (code {rc})")
    return out


def run_paged(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pops

    cfg = get_config("qwen3-1.7b")
    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_prefill, seed in (("decode", 0, 40), ("mixed", 32, 41)):
        lens, q_lens = cs.main_path_lens(256, W, n_prefill, seed)
        q, entry, table, lens_t, q_lens_t = cs.make_inputs(
            256, W, H, KH, D, bs, MB, "bfloat16", lens, q_lens, q_dtype=torch.bfloat16, seed=seed)
        want = cs.plain((q, entry, table, lens_t, q_lens_t), bs=bs)

        def make_run(run, q=q, entry=entry, table=table, lens_t=lens_t, q_lens_t=q_lens_t):
            lib, kw = run
            if kw.get("core"):
                return lambda: paged_core(lib, q, entry, table, lens_t, q_lens_t, bs, stream)
            return lambda: pops.launch(lib, q, entry, table, lens_t, q_lens_t, block_size=bs,
                                       window=0, rows_per_cta=0, stream=stream, **kw)

        print(f"  paged attention, {name} shape (256 slots x {W} rows, {n_prefill} prefill "
              f"slots, bf16 pages):", flush=True)
        timed({tag: (libs[v], kw) for tag, (v, kw) in RUNS["paged"].items()}, make_run, want)
        del q, entry, want
        torch.cuda.empty_cache()


def run_rmsnorm(libs: dict) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    stream = torch.cuda.current_stream().cuda_stream
    q, _ = cs.qkv_views(256, 256, 16, 8, 128, torch.bfloat16, 54)
    qp, _ = cs.qkv_views(8, 2048, 16, 8, 128, torch.bfloat16, 51)
    sq = cs.rms_inputs((128,), torch.float32, 55)[1]
    shapes = {"slab (65536, 2048)": cs.rms_inputs((256 * 256, 2048), torch.bfloat16, 53),
              "prefill rows (16384, 2048)": cs.rms_inputs((8 * 2048, 2048), torch.bfloat16, 50),
              "slab q view (256, 256, 16, 128)": (q, sq),
              "prefill q view (8, 2048, 16, 128)": (qp, sq)}
    for name, (x, sc) in shapes.items():
        d = x.shape[-1]
        group, nv, r, grid = rops.launch_plan(x.numel() // d, d, 2, True)

        def make_run(run, x=x, sc=sc, group=group, nv=nv, r=r, grid=grid):
            lib, kw = run
            if lib is None:
                w = (1.0 + sc).to(x.dtype)
                return lambda: F.rms_norm(x, (d,), w, 1e-6)
            rr = max(1, int(r * kw.get("rows", 1)))
            per_cta = rops.WARPS * (32 // group) * rr
            g = -(-(x.numel() // d) // per_cta)  # one pass
            if kw.get("ctas_per_sm"):
                g = min(g, rops.N_SMS * kw["ctas_per_sm"])
            elif "ctas_per_sm" not in kw:
                g = rops.launch_plan(x.numel() // d, d, 2, True)[3] if rr == r else (
                    g if group == 32 else min(g, rops.N_SMS * rops.resident_ctas(nv, rr)))
            return lambda: rops.launch(lib, x, sc, eps=1e-6, stream=stream, plan=(group, nv, rr, g))

        print(f"  rmsnorm, {name} bf16, plan (lanes a row, vectors a lane, rows a group, CTAs) "
              f"{(group, nv, r, grid)}:", flush=True)
        timed({tag: (libs[v], kw) for tag, (v, kw) in RUNS["rmsnorm"].items()}, make_run,
              rmsnorm_ref(x, sc))


def main(argv: list) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mm_pu import kernel as mk
    from repro_torch.kernels.mm_pu import ops as mops
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref, quantize_weights_int8
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rmsnorm import kernel as rk

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device visible", flush=True)
        return 2
    which = argv or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sources = {"flash": fk.SOURCE, "mm_pu": mk.SOURCE, "paged": pk.SOURCE, "rmsnorm": rk.SOURCE}
    paths = {(k, tag): write_variant(sources[k], tag, subs)
             for k in which for tag, subs in VARIANTS[k].items()}
    t0 = time.time()
    _build.build_all(list(paths.values()))
    print(f"built {len(paths)} variants in {time.time() - t0:.1f} s", flush=True)
    for (k, tag), path in paths.items():
        log = _build.library_path(path).with_suffix(".log").read_text().splitlines()
        regs = [ln.split("Used ")[1].split(" reg")[0] for ln in log if "Used" in ln]
        spills = [ln.strip() for ln in log if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"  {k} {tag}: {log[0]}; registers {regs}; spills {spills}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    if "flash" in which:
        libs = {tag: bind(paths[("flash", tag)], {n: fk._ARGTYPES for n in fk.ENTRIES})
                for tag in VARIANTS["flash"]}
        q, k, v = cs.flash_inputs(8, 2048, 16, 8, 128, torch.bfloat16, seed=20)
        print("  flash, B 8 S 2048 H 16 KH 8 D 128 bf16 causal:", flush=True)
        timed(libs, lambda lib: lambda: fops.launch(lib, q, k, v, causal=True, window=0,
                                                    prefix=0, stream=stream),
              cs.flash_plain(q, k, v))
        del q, k, v

    if "mm_pu" in which:
        libs = {tag: bind(paths[("mm_pu", tag)], mk._ARGTYPES) for tag in VARIANTS["mm_pu"]}
        g = torch.Generator(device="cuda").manual_seed(0)
        for name, (m, kk, n) in {"T=2048 w1": (2048, 2048, 6144),
                                 "T=256 w2": (256, 6144, 2048)}.items():
            x = torch.randn((m, kk), generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn((kk, n), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
            qw, s = quantize_weights_int8(w)
            for wname, ww, sc in (("int8", qw, s), ("bf16", w, None)):
                print(f"  mm_pu {name} ({m}, {kk}) @ ({kk}, {n}) {wname} w, silu:", flush=True)
                timed(libs, lambda lib: lambda: mops.launch(lib, x, ww, bias=None, residual=None,
                                                             w_scale=sc, activation="silu",
                                                             out_dtype=None, stream=stream),
                      mm_pu_ref(x, ww, w_scale=sc, activation="silu"))
        torch.cuda.empty_cache()

    if "paged" in which:
        run_paged({tag: bind(paths[("paged", tag)], pk._ARGTYPES) for tag in VARIANTS["paged"]})
    if "rmsnorm" in which:
        libs = {tag: bind(paths[("rmsnorm", tag)], {"rmsnorm_forward": rk._ARGTYPES})
                for tag in VARIANTS["rmsnorm"]}
        run_rmsnorm({**libs, None: None})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
