"""Deterministic, resumable data pipeline (the port's
``repro/data/pipeline.py``).

Synthetic LM stream: every batch is a pure function of (seed, step), so a
restart at step k replays the same batches with no data state to persist.
A memory-mapped token-file source serves real corpora with the same
(seed, step) -> batch determinism, by drawing the step's file offsets from
numpy's generator seeded by (seed, step): its batches are the JAX
package's, token for token.

The synthetic stream is the JAX one's order-2 progression (tokens[t + 1] =
tokens[t] + 31 mod V) with 10% of the positions replaced by uniform noise,
drawn from a ``torch.Generator`` seeded by (seed, step): the same
distribution, other numbers than ``jax.random`` gives (ROADMAP, deliberate
divergences).  The loss has structure to descend.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: Optional[str] = None  # raw uint32 tokens, memory-mapped


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose stream is a pure function of (seed, step)."""
    key = np.random.SeedSequence((seed, step)).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(key) & 0x7FFF_FFFF_FFFF_FFFF)


def synthetic_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Order-2 structured stream: tokens[t + 1] = f(tokens[t]) + noise.
    Returns int32 ``tokens`` and ``targets`` (B, S) on ``device`` (the
    card by default; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    g = _generator(cfg.seed, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    start = torch.randint(0, V, (B, 1), generator=g)
    mult = 31 % V or 1
    seq = (start + torch.arange(S + 1)[None, :] * mult) % V  # deterministic progression
    noise_mask = torch.rand((B, S + 1), generator=g) < 0.1
    noise = torch.randint(0, V, (B, S + 1), generator=g)
    seq = torch.where(noise_mask, noise, seq).to(torch.int32)
    return {"tokens": seq[:, :-1].to(dev), "targets": seq[:, 1:].to(dev)}


class TokenFileSource:
    """Memory-mapped corpus of raw token ids (little-endian uint32)."""

    def __init__(self, path: str, dtype=np.uint32):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")

    def batch(self, cfg: DataConfig, step: int, device="cuda") -> dict:
        dev = resolve_device(device)
        n = len(self.tokens)
        B, S = cfg.global_batch, cfg.seq_len
        rng = np.random.default_rng((cfg.seed, step))
        offs = rng.integers(0, max(n - S - 1, 1), size=(B,))
        rows = np.stack([self.tokens[o: o + S + 1].astype(np.int64) for o in offs])
        rows = torch.from_numpy(np.asarray(rows % cfg.vocab_size, np.int32))
        return {"tokens": rows[:, :-1].to(dev), "targets": rows[:, 1:].to(dev)}


class DataIterator:
    """Step-indexed iterator over ``device`` batches; ``seek(step)`` makes
    resume trivial."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)
        self.source = TokenFileSource(cfg.token_file) if cfg.token_file else None

    def seek(self, step: int) -> None:
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = (
            self.source.batch(self.cfg, self.step, self.device)
            if self.source is not None
            else synthetic_batch(self.cfg, self.step, self.device)
        )
        self.step += 1
        return b
