"""First-call harness for the WKV reference's intermittent difference.

``tests/test_torch_rwkv6.py::test_plain_wkv_matches_jax_kernel[shape0]`` has
failed in some whole test runs: ``kernels/rwkv6/ref.wkv_ref``'s first call in
a process gave 36.949623 where JAX and every later call give 36.946003.
This script starts many fresh processes (``--procs``, ``--parallel`` at a
time); each builds the test's inputs (shape (2, 128, 2, 32), numpy seed 0),
runs the recurrence three times (twice as a copy of ``wkv_ref`` that keeps
the state after every token, then ``wkv_ref`` itself) and reports whether
the first call differs from the later ones.  When it does, the child finds
the first token whose output differs and compares the states there bit
for bit: how many elements and which bits differ, and where.  Every other
child runs pinned to one core (``taskset -c``) where ``taskset`` exists.
The summary records the CPU model, microcode and kernel.

    python scripts/wkv_first_call.py --procs 400 --parallel 4 --out wkv_first_call.json

It imports no JAX and reads nothing of the test run it is started beside.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (2, 128, 2, 32)  # shape0 of test_plain_wkv_matches_jax_kernel


def _inputs():
    """The test's ``_mk(*SHAPE)`` inputs in the kernel layout: r, k, v,
    log w as (B H, S, D), u as (H, D)."""
    import numpy as np
    import torch

    B, S, H, D = SHAPE
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, S, H, D))))) * (0.95 - 0.45) + 0.45
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)

    def kl(x):
        return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D)

    return kl(r), kl(k), kl(v), kl(np.log(w.astype(np.float32))), torch.from_numpy(u)


def _recurrence(r, k, v, logw, u, n_heads):
    """``wkv_ref``'s loop, the state kept after every token."""
    import torch

    BH, S, D = r.shape
    B = BH // n_heads
    w = torch.exp(logw.float())
    uu = u.float().repeat(B, 1)
    r32, k32, v32 = r.float(), k.float(), v.float()
    state = torch.zeros((BH, D, D), dtype=torch.float32)
    outs, states = [], []
    for t in range(S):
        kv = k32[:, t, :, None] * v32[:, t, None, :]
        outs.append(torch.einsum("bk,bkd->bd", r32[:, t], state + uu[:, :, None] * kv))
        state = w[:, t, :, None] * state + kv
        states.append(state.clone())
    return torch.stack(outs, dim=1), torch.stack(states, dim=1)


def child() -> dict:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.rwkv6.ref import wkv_ref

    args = _inputs()
    H = SHAPE[2]
    t0 = time.perf_counter()
    first, s_first = _recurrence(*args, H)
    second, s_second = _recurrence(*args, H)
    third = wkv_ref(*args, n_heads=H)
    out = {"pid": os.getpid(), "threads": torch.get_num_threads(),
           "affinity": sorted(os.sched_getaffinity(0)), "ms": (time.perf_counter() - t0) * 1e3,
           "first_equals_second": bool(torch.equal(first, second)),
           "second_equals_ref": bool(torch.equal(second, third)),
           "max_abs_first_vs_second": float((first - second).abs().max())}
    if not out["first_equals_second"]:
        rows = (first != second).any(dim=-1)  # (BH, S)
        bh, t = (int(x) for x in torch.nonzero(rows)[0])
        t = int(torch.nonzero(rows[bh])[0])
        a, b = s_first[bh, max(t - 1, 0)], s_second[bh, max(t - 1, 0)]
        xor = (a.view(torch.int32) ^ b.view(torch.int32))
        at = torch.nonzero(xor)
        out["first_diff"] = {
            "row": bh, "token": t, "state_before": "token %d" % max(t - 1, 0),
            "elements_differing_before": int((xor != 0).sum()),
            "elements_differing_after": int((s_first[bh, t] != s_second[bh, t]).sum()),
            "where_before": at[:8].tolist(),
            "bits_before": [f"{int(x) & 0xffffffff:032b}" for x in xor[xor != 0][:8]],
            "output": [float(first[bh, t].abs().max()), float(second[bh, t].abs().max())],
        }
    return out


def machine() -> dict:
    info = {"kernel": platform.release(), "cpus": os.cpu_count()}
    try:
        text = Path("/proc/cpuinfo").read_text()
        for key in ("model name", "microcode", "flags"):
            vals = sorted({ln.split(":", 1)[1].strip() for ln in text.splitlines()
                           if ln.startswith(key)})
            info[key] = vals if key != "flags" else [f for f in vals[0].split()
                                                     if f.startswith("avx512")] if vals else []
    except OSError as e:
        info["cpuinfo"] = str(e)
    return info


def run_one(i: int, pin: bool) -> dict:
    cmd = [sys.executable, __file__, "--child"]
    if pin and shutil.which("taskset"):
        cmd = ["taskset", "-c", str(i % (os.cpu_count() or 1))] + cmd
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    if p.returncode != 0:
        return {"i": i, "pinned": pin, "error": p.stderr[-500:]}
    return {"i": i, "pinned": pin, **json.loads(p.stdout.strip().splitlines()[-1])}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--procs", type=int, default=100)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child()))
        return
    t0 = time.time()
    with ThreadPoolExecutor(a.parallel) as pool:
        runs = list(pool.map(lambda i: run_one(i, pin=i % 2 == 1), range(a.procs)))
    differ = [r for r in runs if not r.get("first_equals_second", True)]
    summary = {
        "machine": machine(), "procs": a.procs, "parallel": a.parallel,
        "seconds": time.time() - t0, "errors": sum("error" in r for r in runs),
        "first_call_differs": len(differ),
        "by_pinning": {str(p): {"runs": sum(r["pinned"] == p for r in runs),
                                "differ": sum(r["pinned"] == p for r in differ)}
                       for p in (False, True)},
        "later_calls_disagree_with_wkv_ref": sum(not r.get("second_equals_ref", True)
                                                 for r in runs),
        "differing": differ[:20],
    }
    text = json.dumps(summary, indent=1)
    if a.out:
        Path(a.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
