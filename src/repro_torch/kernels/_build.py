"""Build the port's CUDA kernels from the sources in the checkout.

Each ``.cu`` file under a kernel's ``csrc/`` exports a plain C function and
is compiled by ``nvcc`` into its own shared library, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  Builds happen
at first use, land in ``build/repro_torch_kernels/`` at the repository root
and are cached by a hash of the source and the flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: keyed by its content and the flags."""
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{h}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns the
    library's path.  The compiler's report (registers, spills) is kept
    beside it as ``.log``.  Raises with the compiler's output on failure."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}\n{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
