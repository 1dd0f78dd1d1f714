"""Weight bridge (JAX init_params -> torch): tree shape and exact values
for f32 and bf16 trees, and the port's own init_params builds the same tree
(keys, shapes, dtypes) as the JAX one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.params import init_params
from torch_parity import model_pair, t2n

_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _paths(tree, prefix=()):
    """{path: leaf} over dicts/tuples, None kept as a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {prefix + ("#len",): len(tree)}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m"])
def test_bridge_round_trips_tree_and_values(arch, dtype):
    _, _, jparams, _, _, tparams = model_pair(arch, dtype=dtype)
    jp, tp = _paths(jparams), _paths(tparams)
    assert jp.keys() == tp.keys()
    for path, j in jp.items():
        t = tp[path]
        if path[-1] == "#len" or j is None:
            assert t == j, path
            continue
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32), path
        # bit-exact: bf16 compares its 16-bit patterns
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), j.view(np.int16), err_msg=str(path)
            )
        else:
            np.testing.assert_array_equal(t2n(t), j, err_msg=str(path))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_init_params_has_the_jax_tree(dtype):
    """Same keys, tuple lengths, shapes and dtypes as the JAX init (the
    numbers differ: a torch.Generator is not a jax.random key)."""
    _, _, jparams, tcfg, tplan, _ = model_pair("qwen3-1.7b", dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    mine = init_params(tcfg, tplan, _DT[dtype], generator=gen, device="cpu")
    jp, tp = _paths(jparams), _paths(mine)
    assert jp.keys() == tp.keys()
    for path, j in jp.items():
        t = tp[path]
        if path[-1] == "#len" or j is None:
            assert t == j, path
            continue
        assert tuple(t.shape) == j.shape, path
        want = torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32
        assert t.dtype == want, path
    # seeded: the same generator seed gives the same weights
    again = init_params(tcfg, tplan, _DT[dtype], generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert torch.equal(again["embed"], mine["embed"])
    # same scales: embed ~ N(0, 0.02^2)
    assert abs(float(mine["embed"].float().std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "paligemma-3b", "whisper-small",
                                  "bert-base", "vit-base"])
def test_port_init_params_other_archs_have_the_jax_tree(arch):
    """The eager path's other archs: RG-LRU leaves (``lam`` the JAX
    linspace, not a draw), the cross-attention leaves and the ``encoder``
    tree (whisper-small), learned ``pos`` and no ``embed`` without a
    vocabulary (vit-base), ``cls_head``: same keys, tuple lengths, shapes
    and dtypes as the JAX init, in bf16."""
    # vit-base with its own vocabulary of 1 (the reduced config has 512)
    _, _, jparams, tcfg, tplan, _ = model_pair(
        arch, dtype=jnp.bfloat16, **({"vocab_size": 1} if arch == "vit-base" else {}))
    mine = init_params(tcfg, tplan, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    jp, tp = _paths(jparams), _paths(mine)
    assert jp.keys() == tp.keys()
    for path, j in jp.items():
        t = tp[path]
        if path[-1] == "#len" or j is None:
            assert t == j, path
            continue
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32), path
        if path[-1] == "lam":  # not random: equal to JAX's within f32 rounding
            np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=1e-6, atol=1e-6)
    assert ("embed" in mine) == (tcfg.vocab_size > 1)
