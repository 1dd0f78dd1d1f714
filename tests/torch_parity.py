"""Shared set-up for the PyTorch port's parity tests: the same reduced
config in both packages, JAX weights bridged to torch, numpy in between.

Not a test module: ``tests/test_torch_*.py`` import it.  Everything runs on
the CPU (JAX on its CPU backend, the port with ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core.plan import derive_plan
from repro.models.params import init_params as jax_init_params
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.core.plan import derive_execution_plan

MESH1 = {"data": 1, "model": 1}


def to_numpy(tree):
    """JAX tree -> the same tree of host numpy arrays (what the bridge takes)."""
    return jax.tree.map(np.asarray, tree)


def t2n(x: torch.Tensor) -> np.ndarray:
    """Torch tensor -> numpy, bf16 widened to f32."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def configs(arch: str = "smollm-135m", **replace):
    """The reduced config of ``arch`` in both packages (+ field overrides)."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    return jcfg, tcfg


def model_pair(arch: str = "smollm-135m", dtype=jnp.float32, seed: int = 0,
               moe_dispatch: str = "gshard", **replace):
    """(jcfg, jplan, jparams, tcfg, tplan, tparams): JAX weights from
    ``repro.models.params.init_params`` and their bridged torch copy; both
    plans take ``moe_dispatch``."""
    jcfg, tcfg = configs(arch, **replace)
    jplan = derive_plan(jcfg, MESH1, batch=4, seq_len=16, training=False,
                        moe_dispatch=moe_dispatch)
    tplan = derive_execution_plan(tcfg, moe_dispatch=moe_dispatch)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg, jplan, dtype=dtype)
    return jcfg, jplan, jparams, tcfg, tplan, from_jax(to_numpy(jparams), device="cpu")
