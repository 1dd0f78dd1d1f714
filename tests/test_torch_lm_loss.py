"""The port's ``lm_loss`` and every gradient leaf against
``jax.value_and_grad(repro.models.transformer.lm_loss)`` for every reduced
arch, both packages on the same bridged f32 weights and the same numpy
batch: the MoE aux loss (qwen3-moe-30b-a3b, mixtral-8x7b), paligemma-3b's
prefix slice, whisper-small's encoder, rwkv6-1.6b and recurrentgemma-9b's
recurrences and vit-base's classifier loss among them.  On the CPU the
port's kernel wrappers run their plain versions, which autograd
differentiates.  The loss within rtol 1e-5, gradients within 2e-4 (rtol
and atol: the JAX flash-backward test's).  Helpers in
``test_torch_train.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.core.plan import derive_plan
from repro.models.transformer import lm_loss as jax_lm_loss
from repro_torch.core.plan import derive_execution_plan
from repro_torch.models.transformer import lm_loss
from repro_torch.train.train_step import value_and_grad
from test_torch_train import B, GRAD_TOL, LOSS_RTOL, S, assert_trees_close, both, numpy_batch
from torch_parity import MESH1, model_pair


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """Every reduced arch: the loss and every gradient leaf in f32."""
    jcfg, _, jparams, tcfg, _, tparams = model_pair(arch)
    jplan = derive_plan(jcfg, MESH1, batch=B, seq_len=S)
    tplan = derive_execution_plan(tcfg, training=True, batch=B, seq_len=S)
    assert tplan.remat == jplan.remat and tplan.microbatches == jplan.microbatches
    jb, tb = both(numpy_batch(jcfg))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(p, jb, cfg=jcfg, plan=jplan))(jparams)
    tloss, tgrads = value_and_grad(
        lambda p, b: lm_loss(p, b, cfg=tcfg, plan=tplan), tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert_trees_close(tgrads, jgrads, GRAD_TOL, GRAD_TOL, f"{arch} grad")
    if tcfg.is_moe:  # the aux loss reaches the loss
        from repro_torch.models.transformer import forward

        with torch.no_grad():
            _, _, aux = forward(tparams, tb, cfg=tcfg, plan=tplan, with_aux=True)
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b", "paligemma-3b"])
def test_stacked_params_unbound_once(arch):
    """``lm_loss`` takes each stacked parameter's groups with one unbind:
    every autograd edge into a stacked leaf comes from an UnbindBackward,
    none from a SelectBackward (whose backward adds each group's gradient
    into a full-size zero tensor of the stack)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    cfg = get_config(arch + "-reduced")
    plan = derive_execution_plan(cfg, training=True, batch=2, seq_len=16)
    params = init_params(cfg, plan, torch.float32, device="cpu")
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    stacked = {id(x) for x in tree_leaves(tree["blocks"]["stack"])}
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 16, 2, seed=0), 0, device="cpu")
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.zeros((2, cfg.n_prefix_embeds, cfg.d_model))
    loss = lm_loss(tree, batch, cfg=cfg, plan=plan)
    into_stacked, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        for nxt, _ in fn.next_functions:
            if nxt is not None and id(getattr(nxt, "variable", None)) in stacked:
                into_stacked.setdefault(type(fn).__name__, set()).add(id(nxt.variable))
            todo.append(nxt)
    assert set(into_stacked) == {"UnbindBackward0"}, sorted(into_stacked)
    assert into_stacked["UnbindBackward0"] == stacked
