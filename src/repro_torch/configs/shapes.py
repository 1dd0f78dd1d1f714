"""The assigned input-shape set for the LM-family archs (a copy of
``repro/configs/shapes.py``).

train_4k / prefill_32k trace the training / prefill step; decode_32k /
long_500k the decode step (one new token against a seq_len-deep cache).
long_500k requires a sub-quadratic path and is skipped for pure
full-attention archs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch, shape) cell."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape is LONG_500K and not cfg.supports_long_context():
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""


def cells(cfg: ArchConfig):
    for shape in ALL_SHAPES:
        ok, reason = applicable(cfg, shape)
        yield shape, ok, reason
