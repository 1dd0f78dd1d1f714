"""Drawing traffic from the seed.

Sizes come as a fixed set for every seed, in another order: ``n`` lengths at
the quantiles (i + 1/2) / n of their distribution, shuffled by the seed.  So
two seeds run the same work in a different arrangement, and a run's spread
is the system's, not the draw's.  Token ids are uniform over the vocabulary."""
from __future__ import annotations

import hashlib
import math

import numpy as np


def rng(seed: int, salt: str) -> np.random.Generator:
    key = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return np.random.default_rng(int.from_bytes(key[:8], "little"))


def quantile_set(n: int, dist: dict) -> np.ndarray:
    """``n`` values at the quantiles (i + 1/2) / n of ``dist``:
    ``{"dist": "loguniform", "lo", "hi"}`` (whole numbers in [lo, hi]),
    ``{"dist": "fixed", "value"}``, ``{"dist": "exponential", "mean"}``."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, dist["value"], dtype=np.float64)
    if kind == "loguniform":
        lo, hi = math.log(dist["lo"]), math.log(dist["hi"] + 1)
        return np.minimum(np.floor(np.exp(lo + q * (hi - lo))), dist["hi"])
    if kind == "exponential":
        return -dist["mean"] * np.log1p(-q)
    raise ValueError(f"distribution {kind!r}")


def shuffled_set(n: int, dist: dict, g: np.random.Generator) -> np.ndarray:
    return g.permutation(quantile_set(n, dist))


def sample(dist: dict, g: np.random.Generator) -> float:
    """One free draw of ``dist`` (beyond a fixed set)."""
    kind = dist["dist"]
    if kind == "fixed":
        return float(dist["value"])
    if kind == "loguniform":
        lo, hi = math.log(dist["lo"]), math.log(dist["hi"] + 1)
        return float(min(math.floor(math.exp(g.uniform(lo, hi))), dist["hi"]))
    if kind == "exponential":
        return float(g.exponential(dist["mean"]))
    raise ValueError(f"distribution {kind!r}")


def tokens(g: np.random.Generator, n: int, vocab: int) -> list:
    return g.integers(0, vocab, int(n)).tolist()


class Tenants:
    """``n`` tenants, each with a shared prefix of ``prefix_len`` tokens
    (its system prompt or header) drawn once from the seed."""

    def __init__(self, n: int, prefix_len: int, vocab: int, g: np.random.Generator):
        self.prefixes = [tokens(g, prefix_len, vocab) for _ in range(n)]

    def __len__(self) -> int:
        return len(self.prefixes)
