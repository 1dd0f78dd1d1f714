"""Config registry: ``get_config(name)`` / ``--arch <id>`` (a copy of the
registry in ``repro/configs/__init__.py``; the data files beside it are
copies of the JAX package's)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ShapeSpec,
    applicable,
    cells,
)

_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "qwen3-1.7b": "qwen3_1_7b",
    "smollm-135m": "smollm_135m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "paligemma-3b": "paligemma_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-small": "whisper_small",
    # the paper's own evaluation models
    "bert-base": "bert_base",
    "vit-base": "vit_base",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k not in ("bert-base", "vit-base"))
ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-").lower()
    if key.endswith("-reduced"):
        return get_config(key[: -len("-reduced")]).reduced()
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "ALL_SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "applicable",
    "cells",
    "get_config",
    "ASSIGNED_ARCHS",
    "ALL_ARCHS",
]
