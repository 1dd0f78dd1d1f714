"""Runs phases of ``chip_smoke.py`` alone on the card: the flash, RMSNorm
and WKV kernels (forward and backward) are built first, then each phase
named on the command line, in order:

    39      phase 39 (a): ``--dp 2`` on two ranks (FSDP) and its control
    43      phase 43: phi4-mini-3.8b FSDP, f32 and bf16 at 4 layers
    44      phase 44: rwkv6-1.6b FSDP beside replicated data parallelism
    45      phase 45: rwkv6-1.6b tensor parallelism, f32 at 4 layers and bf16 at full depth
    45dp    phase 45 with replicated data parallelism of the bf16 run beside it
    46      phase 46: recurrentgemma-9b tensor parallelism at 3 and 6 layers
    47      phase 47: whisper-small tensor parallelism at full depth, f32 and bf16
    48      phases 31 and 35 (qwen3-1.7b and rwkv6-1.6b training), then phase 48:
            the dry run against their readings, launch.serve --from-family,
            launch.dryrun --calibrate (the paged-attention kernel built too)
    49      phase 49: phi4-mini-3.8b at 20 layers, ZeRO weights under the pipeline on
            four ranks, beside its one-process run, with its two controls
    gloo    scripts/gloo_transport.py (the two-rank transport's parts)

    python3 scripts/chip_phases.py 39 43 44

Prints the card's name and power limit first; every reading is the chip
script's own log line.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(which: list) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.time()
    paged = [pk] if "48" in which else []
    _build.build_all([fk.SOURCE, fk.BACKWARD_SOURCE, rk.SOURCE, rk.BACKWARD_SOURCE, wk.SOURCE,
                      wk.BACKWARD_SOURCE] + [k.SOURCE for k in paged])
    for lib in (fk.library, fk.backward_library, rk.library, rk.backward_library, wk.library,
                wk.backward_library, *(k.library for k in paged)):
        lib()
    cs.log(f"built in {time.time() - t0:.1f} s")
    tp = [int(n[:2]) for n in which if n in ("45", "45dp", "46", "47")]
    references = ["rwkv6 bf16 dp"] if "45dp" in which else []
    which = [n for n in which if n not in ("45", "45dp", "46", "47")] + (["tp"] if tp else [])
    for name in which:
        t = time.time()
        if name == "gloo":
            subprocess.run([sys.executable, str(ROOT / "scripts" / "gloo_transport.py")],
                           check=True)
            continue
        if name == "39":
            cs.MESH_PATHS = {"dp": cs.MESH_PATHS["dp"]}
            cs.MESH_CONTROLS = {"skip_grad_sum": cs.MESH_CONTROLS["skip_grad_sum"]}
            r = cs.phase_mesh_ranks()
        elif name == "43":
            r = cs.phase_fsdp(43, ["phi4 f32", "phi4 bf16"], ["phi4 f32"])
        elif name == "44":
            r = cs.phase_fsdp(44, ["rwkv6 bf16 dp", "rwkv6 bf16"], ["rwkv6 bf16"])
        elif name == "tp":  # phases 45-47 share one spawn of the two ranks
            r = cs.phase_tp_archs(tp, references)[0]
        elif name == "49":
            r = cs.phase_pipeline_zero()
        elif name == "48":  # phase 48 reads phases 31 and 35
            train = cs.phase_train()
            rwkv = cs.phase_train_rwkv()
            r = cs.phase_dryrun(*train, *rwkv)
        else:
            cs.fail(f"no phase {name}")
        cs.log(f"phase {name}: {json.dumps(r)}; took {time.time() - t:.1f} s")
    cs.end_phase()
    cs.log(f"total {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or ["39", "43", "44"])
