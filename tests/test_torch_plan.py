"""The port's serving planner (a copy of the JAX one) against
``repro.core.plan.derive_serve_plan`` field for field, on a HardwareSpec
carrying the JAX TPU_V5E numbers, and its H100 entry's derived plan."""
import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.plan import derive_plan
from repro.core.plan import derive_serve_plan as jax_serve_plan
from repro.core.plan import serve_feasible as jax_feasible
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.hardware import H100_SXM, HardwareSpec, get_hardware
from repro_torch.core.plan import derive_execution_plan, derive_serve_plan, serve_feasible
from torch_parity import MESH1

V5E = HardwareSpec(
    **{f.name: getattr(TPU_V5E, f.name) for f in dataclasses.fields(HardwareSpec)}
)
SERVABLE = ("qwen3-1.7b", "smollm-135m", "phi4-mini-3.8b", "mistral-large-123b",
            "mixtral-8x7b", "qwen3-moe-30b-a3b")
KNOBS = [
    {},
    {"max_seq_len": 4096, "decode_batch": 8},
    {"max_seq_len": 32768, "fused_attention": False},
    {"kv_dtype": "int8", "block_size": 8, "prefill_chunk": 64, "rolled_steps": 4},
    {"slo_ttft_ms": 50.0, "typical_prompt_len": 512, "draft": "ngram"},
]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_are_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch + "-reduced")) == dataclasses.asdict(
        jax_get_config(arch + "-reduced")
    )
    assert serve_feasible(get_config(arch)) == jax_feasible(jax_get_config(arch))


@pytest.mark.parametrize("kw", KNOBS)
@pytest.mark.parametrize("arch", SERVABLE)
def test_serve_plan_matches_jax_field_for_field(arch, kw):
    mine = derive_serve_plan(get_config(arch), MESH1, V5E, **kw)
    theirs = jax_serve_plan(jax_get_config(arch), MESH1, TPU_V5E, **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "smollm-135m-reduced", "rwkv6-1.6b"])
def test_execution_plan_fuses_qkv_as_jax(arch):
    jax_plan = derive_plan(jax_get_config(arch), MESH1, batch=4, seq_len=16, training=False)
    assert derive_execution_plan(get_config(arch)).fuse_qkv == jax_plan.fuse_qkv


@pytest.mark.parametrize("kw", [{}, {"moe_dispatch": "sort"}])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_execution_plan_moe_dispatch_as_jax(arch, kw):
    """``moe_dispatch``: "gshard" unless the caller names another, as JAX's
    serving plan (the launcher never names another)."""
    jax_plan = derive_plan(jax_get_config(arch), MESH1, batch=4, seq_len=16, training=False,
                           **kw)
    assert derive_execution_plan(get_config(arch), **kw).moe_dispatch == jax_plan.moe_dispatch
    with pytest.raises(ValueError):
        derive_execution_plan(get_config(arch), moe_dispatch="einsum")


def test_h100_plan_for_qwen3_moe():
    """qwen3-moe-30b-a3b on the H100 entry at 2048 positions: 60.4 GB of
    bf16 weights leave a 19.6 GB KV budget, which the planner fills with
    int8 pages: 128 slots x a 256-row slab, 16,385 16-token blocks."""
    sp = derive_serve_plan(get_config("qwen3-moe-30b-a3b"), MESH1, H100_SXM, max_seq_len=2048)
    assert (sp.decode_batch, sp.block_size, sp.n_blocks, sp.kv_dtype) == (128, 16, 16385, "int8")
    assert (sp.mixed_slab_width, sp.rolled_steps, sp.prefix_sharing) == (256, 1, True)
    assert serve_feasible(get_config("qwen3-moe-30b-a3b")) == (True, "")


def test_h100_plan_for_qwen3():
    """The data-sheet H100 entry: machine balance ~295 FLOP/B -> 256 decode
    slots; one MXU-sized 16-token block; 227 KB of shared memory fits one
    bf16 page pair per tile; the 3.4 GB weight stream (~1 ms) leaves no
    dispatch overhead worth rolling."""
    assert get_hardware("h100") is H100_SXM
    cfg = get_config("qwen3-1.7b")
    sp = derive_serve_plan(cfg, MESH1, H100_SXM)
    assert (sp.decode_batch, sp.block_size, sp.kv_dtype) == (256, 16, "bf16")
    assert (sp.mixed_slab_width, sp.pages_per_tile, sp.rolled_steps) == (256, 1, 1)
    assert derive_serve_plan(cfg, MESH1, H100_SXM, decode_batch=8).n_blocks == 1025
    with pytest.raises(ValueError):
        derive_serve_plan(get_config("rwkv6-1.6b"), MESH1, H100_SXM)


TRAIN_GRID = [(8, 2048), (32, 4096), (2, 128), (64, 8192), (4, 32768), (1, 512)]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_training_plan_matches_jax(arch):
    """remat and microbatches as ``derive_plan(training=True)`` derives them
    on a 1 x 1 mesh, on the TPU_V5E numbers, over a grid of (batch, seq)
    (qwen3-1.7b at B 32 x S 4096: 8 microbatches)."""
    for batch, seq in TRAIN_GRID:
        theirs = derive_plan(jax_get_config(arch), MESH1, TPU_V5E, batch=batch, seq_len=seq,
                             training=True, grad_compression="int8")
        mine = derive_execution_plan(get_config(arch), training=True, batch=batch, seq_len=seq,
                                     hw=V5E, grad_compression="int8")
        assert (mine.remat, mine.microbatches, mine.grad_compression) == (
            theirs.remat, theirs.microbatches, theirs.grad_compression), (batch, seq)
    if arch == "qwen3-1.7b":
        mine = derive_execution_plan(get_config(arch), training=True, batch=32, seq_len=4096,
                                     hw=V5E)
        assert mine.microbatches == 8


def test_training_plan_on_the_h100():
    """The H100's 80 GB: qwen3-1.7b at B 8 x S 2048 rematerializes in one
    microbatch; serving plans keep the training fields at their defaults;
    an unknown compression mode raises."""
    cfg = get_config("qwen3-1.7b")
    plan = derive_execution_plan(cfg, training=True, batch=8, seq_len=2048, hw=H100_SXM)
    assert (plan.remat, plan.microbatches, plan.grad_compression) == (True, 1, "none")
    serve = derive_execution_plan(cfg)
    assert (serve.remat, serve.microbatches, serve.grad_compression) == (False, 1, "none")
    with pytest.raises(ValueError, match="grad_compression"):
        derive_execution_plan(cfg, training=True, grad_compression="fp8")
