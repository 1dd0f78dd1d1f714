"""Time the paged-attention and RMSNorm-backward kernels of two checkouts
on one CUDA card, in one process, in the order A, B, B, A.

    python3 scripts/ab_kernels.py PARENT_DIR [CHANGE_DIR]

Each checkout's ``paged_attention.cu`` and ``rmsnorm_bwd.cu`` are built
from its own sources (one ``nvcc`` each, in parallel) and launched through
its own wrappers' ``launch`` / ``launch_backward`` (loaded from its
``ops.py`` by path, so the two C signatures may differ), on the same
inputs: paged attention at ``chip_smoke.py``'s main shapes (qwen3-1.7b's
256 x 256 slab with bf16 pages, decode and mixed; qwen3-moe-30b-a3b's
128 x 256 slab with int8 pages, decode, mixed and verify rows at q_len 5),
and the RMSNorm backward at qwen3-1.7b's training rows (the norm rows and
the q / k views, bf16).  Prints the card's name and power limit, then per
shape each checkout's two times and whether its output matches the plain
version (one bf16 step; the backward at ``chip_smoke.GRAD_BF16_TOL``).
CHANGE_DIR defaults to this checkout.
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = "src/repro_torch/kernels"


def load_module(path: Path, name: str):
    """A module of a checkout, loaded by path under its own name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def checkout(tree: Path, tag: str) -> dict:
    """The checkout's two libraries (built) and wrappers."""
    from repro_torch.kernels import _build

    paged_src = tree / KERNELS / "paged_attention/csrc/paged_attention.cu"
    bwd_src = tree / KERNELS / "rmsnorm/csrc/rmsnorm_bwd.cu"
    _build.build_all([paged_src, bwd_src])
    pk = load_module(tree / KERNELS / "paged_attention/kernel.py", f"{tag}_paged_kernel")
    rk = load_module(tree / KERNELS / "rmsnorm/kernel.py", f"{tag}_rms_kernel")
    paged = ctypes.CDLL(str(_build.library_path(paged_src)))
    for name, types in pk._ARGTYPES.items():
        getattr(paged, name).argtypes = types
        getattr(paged, name).restype = ctypes.c_int
    bwd = ctypes.CDLL(str(_build.library_path(bwd_src)))
    bwd.rmsnorm_backward.argtypes = rk.BACKWARD_ARGTYPES
    bwd.rmsnorm_backward.restype = ctypes.c_int
    return {"paged": paged, "bwd": bwd,
            "paged_ops": load_module(tree / KERNELS / "paged_attention/ops.py", f"{tag}_paged"),
            "rms_ops": load_module(tree / KERNELS / "rmsnorm/ops.py", f"{tag}_rms")}


def ab(name: str, runs: dict, check) -> None:
    """``runs``: tag -> a call; times in A, B, B, A order, then checks."""
    import chip_smoke as cs

    tags = list(runs)
    times = {t: [] for t in tags}
    for t in tags + tags[::-1]:
        times[t].append(cs.time_ms(runs[t]))
    print(f"  {name}:", flush=True)
    for t in tags:
        print(f"    {t}: ms {times[t][0]:.4f} / {times[t][1]:.4f}, matches {check(runs[t]())}",
              flush=True)


def main(argv: list) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref

    if not torch.cuda.is_available() or not argv:
        print(__doc__ if argv else "ab_kernels: no CUDA device visible", flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = {"parent": Path(argv[0]).resolve(),
             "change": Path(argv[1]).resolve() if len(argv) > 1 else ROOT}
    libs = {tag: checkout(tree, tag) for tag, tree in trees.items()}
    stream = torch.cuda.current_stream().cuda_stream

    qwen, moe = get_config("qwen3-1.7b"), get_config("qwen3-moe-30b-a3b")
    shapes = [("qwen3-1.7b bf16 pages, decode", qwen, 256, 0, 40, "bfloat16", 1),
              ("qwen3-1.7b bf16 pages, mixed", qwen, 256, 32, 41, "bfloat16", 1),
              ("qwen3-moe int8 pages, decode", moe, 128, 0, 60, "int8", 1),
              ("qwen3-moe int8 pages, mixed", moe, 128, 16, 61, "int8", 1),
              ("qwen3-moe int8 pages, verify q_len 5", moe, 128, 0, 74, "int8", 5)]
    for name, cfg, B, n_prefill, seed, kv, q_len in shapes:
        H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
        lens, q_lens = cs.main_path_lens(B, W, n_prefill, seed, q_len=q_len)
        args = cs.make_inputs(B, W, H, KH, D, bs, MB, kv, lens, q_lens, q_dtype=torch.bfloat16,
                              seed=seed)
        want = cs.plain(args, bs=bs)
        runs = {tag: (lambda lib=lib: lib["paged_ops"].launch(
                    lib["paged"], *args, block_size=bs, window=0, rows_per_cta=0,
                    stream=stream)) for tag, lib in libs.items()}
        ab(name, runs, lambda got, want=want: cs.within(got, want, cs.BF16_TOL)[0])
        del args, want
        torch.cuda.empty_cache()

    qv, kv_ = cs.qkv_views(8, 2048, 16, 8, 128, torch.bfloat16, 122)
    sq = torch.randn(128, device="cuda") * 0.1
    g = torch.Generator(device="cuda").manual_seed(10)
    for name, (x, sc) in {"rmsnorm backward, norm rows (16384, 2048)":
                          cs.rms_inputs((8 * 2048, 2048), torch.bfloat16, 123),
                          "rmsnorm backward, q view (8, 2048, 16, 128)": (qv, sq),
                          "rmsnorm backward, k view (8, 2048, 8, 128)": (kv_, sq)}.items():
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        want = rmsnorm_backward_ref(x, sc, dy)
        runs = {tag: (lambda lib=lib: lib["rms_ops"].launch_backward(
                    lib["bwd"], x, sc, dy, eps=1e-6, stream=stream)) for tag, lib in libs.items()}
        ab(name, runs, lambda got, want=want: (
            cs.grad_within(got[0], want[0], cs.GRAD_BF16_TOL)[0]
            and cs.grad_within(got[1], want[1], (1e-4, 1e-4), unit_floor=False)[0]))
        del dy, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
