"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` file under a kernel's ``csrc/`` exports a plain C function
(device helpers they share sit in ``kernels/csrc/common.cuh``) and is
compiled by ``nvcc`` into its own shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Builds happen
at first use, land in ``build/repro_torch_kernels/`` at the repository root
and are cached by a hash of the source, the shared headers and the flags;
``build_all`` runs one
``nvcc`` per source in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
COMMON_DIR = Path(__file__).resolve().parent / "csrc"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: keyed by its content, the shared headers'
    (``kernels/csrc/*.cuh``, which every source may include) and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(COMMON_DIR.glob("*.cuh")))
    h = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns the
    library's path.  The compiler's wall time and report (registers,
    spills) are kept beside it as ``.log``.  Raises with the compiler's
    output on failure."""
    return build_all([source])[0]


def build_all(sources) -> list:
    """``build`` for several sources, with one ``nvcc`` process per source
    that is not built yet, all started together; returns the libraries'
    paths in order.  Raises after every compiler has finished if any
    failed, with the failures' output."""
    sources = [Path(s) for s in sources]
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    try:
        for src, out in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = tempfile.TemporaryFile("w+", dir=BUILD_DIR)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)], stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((src, out, tmp, proc, log))
        t0, seconds = time.monotonic(), {}
        while len(seconds) < len(running):  # each compiler's own wall time
            for src, _, _, proc, _ in running:
                if src not in seconds and proc.poll() is not None:
                    seconds[src] = time.monotonic() - t0
            time.sleep(0.05)
        errors = []
        for src, out, tmp, proc, log in running:
            log.seek(0)
            report = log.read()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}) on {src}:\n{report}")
                continue
            out.with_suffix(".log").write_text(f"nvcc {src.name}: {seconds[src]:.1f} s\n{report}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc, log in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
