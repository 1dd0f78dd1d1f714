"""Training batches: ``batch`` rows of ``seq_len`` tokens a step, one step
after another, each row's ids uniform over the vocabulary and drawn on the
device from (seed, step), so every row of every step differs.

A mix file of this kind holds::

    {"kind": "train_batches", "batch": 8, "seq_len": 4096,
     "check_steps": 3,                       # steps the reference follows
     "optimizer": {"peak_lr": 3e-4, ...}}    # AdamW, as the job configures it
"""
from __future__ import annotations

import torch

from bench.portbench.weights import generator


class TrainBatches:
    kind = "train"

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.B, self.S = int(mix["batch"]), int(mix["seq_len"])
        self.vocab, self.seed, self.device = vocab, seed, device

    @property
    def tokens_per_step(self) -> int:
        return self.B * self.S

    def batch(self, step: int) -> dict:
        g = generator(self.seed, f"train_batch:{step}", self.device)
        seq = torch.randint(0, self.vocab, (self.B, self.S + 1), generator=g,
                            device=self.device, dtype=torch.int32)
        return {"tokens": seq[:, :-1].contiguous(), "targets": seq[:, 1:].contiguous()}


def make(mix: dict, vocab: int, seed: int, device) -> TrainBatches:
    return TrainBatches(mix, vocab, seed, device)
