"""Time variants of the tensor-core flash-attention and MM PU kernels on one
CUDA card, against the committed sources, in one process.

    python3 scripts/kernel_variants.py

Each variant is the committed source with a few lines replaced (``VARIANTS``
below: other tile constants, and diagnostics that leave a part out, whose
results are wrong by design).  All are built in parallel (one ``nvcc`` each,
under ``build/kernel_variants/``), bound with ``ctypes`` and launched
through the wrappers' own ``launch`` on the main shapes: flash at the
qwen3-1.7b prefill (B 8, S 2048, H 16, KH 8, D 128, bf16, causal); MM PU at
the int8 FFN stage's T=2048 ``w1`` (2048 x 2048 @ 2048 x 6144, silu) and
T=256 ``w2`` (256 x 6144 @ 6144 x 2048) products, int8 and bf16 w.  Each
variant is timed twice, the list in order and then reversed, so that the
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


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mm_pu import kernel as mk
    from repro_torch.kernels.mm_pu import ops as mops
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref, quantize_weights_int8

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device visible", flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sources = {"flash": fk.SOURCE, "mm_pu": mk.SOURCE}
    paths = {(k, tag): write_variant(sources[k], tag, subs)
             for k, group in VARIANTS.items() for tag, subs in group.items()}
    t0 = time.time()
    _build.build_all(list(paths.values()))
    print(f"built {len(paths)} variants in {time.time() - t0:.1f} s", flush=True)
    for (k, tag), path in paths.items():
        log = _build.library_path(path).with_suffix(".log").read_text().splitlines()
        regs = [ln.split("Used ")[1].split(" reg")[0] for ln in log if "Used" in ln]
        spills = [ln.strip() for ln in log if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"  {k} {tag}: {log[0]}; registers {regs}; spills {spills}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    libs = {tag: bind(paths[("flash", tag)], {n: fk._ARGTYPES for n in fk.ENTRIES})
            for tag in VARIANTS["flash"]}
    q, k, v = cs.flash_inputs(8, 2048, 16, 8, 128, torch.bfloat16, seed=20)
    print("  flash, B 8 S 2048 H 16 KH 8 D 128 bf16 causal:", flush=True)
    timed(libs, lambda lib: lambda: fops.launch(lib, q, k, v, causal=True, window=0, prefix=0,
                                                stream=stream), cs.flash_plain(q, k, v))
    del q, k, v

    libs = {tag: bind(paths[("mm_pu", tag)], mk._ARGTYPES) for tag in VARIANTS["mm_pu"]}
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (m, kk, n) in {"T=2048 w1": (2048, 2048, 6144), "T=256 w2": (256, 6144, 2048)}.items():
        x = torch.randn((m, kk), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((kk, n), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
        qw, s = quantize_weights_int8(w)
        for wname, ww, sc in (("int8", qw, s), ("bf16", w, None)):
            print(f"  mm_pu {name} ({m}, {kk}) @ ({kk}, {n}) {wname} w, silu:", flush=True)
            timed(libs, lambda lib: lambda: mops.launch(lib, x, ww, bias=None, residual=None,
                                                         w_scale=sc, activation="silu",
                                                         out_dtype=None, stream=stream),
                  mm_pu_ref(x, ww, w_scale=sc, activation="silu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
