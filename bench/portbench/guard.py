"""The import guard: nothing a run loads may be the JAX package or JAX.

Names are compared by their top-level part (before the first dot), whole:
``repro_torch`` begins with ``repro`` and is the program, ``repro`` is the
JAX package.  Nothing under ``benchmarks/`` (the JAX package's benchmark)
may be loaded either."""
from __future__ import annotations

import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
ROOT = Path(__file__).resolve().parents[2]


def forbidden_modules(modules=None) -> list:
    """The loaded module names whose top-level name is forbidden, and any
    module loaded from a file under ``benchmarks/``."""
    modules = sys.modules if modules is None else modules
    bad = sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)
    jax_bench = ROOT / "benchmarks"
    for name, mod in list(modules.items()):
        f = getattr(mod, "__file__", None)
        if f:
            try:
                if Path(f).resolve().is_relative_to(jax_bench):
                    bad.append(name)
            except (OSError, ValueError):
                continue
    return bad


def check(where: str) -> None:
    """Raise, naming what was found, if a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"{where}: the run loaded {', '.join(bad)}: the benchmark drives "
                          "repro_torch only, never JAX, the JAX package or benchmarks/")
