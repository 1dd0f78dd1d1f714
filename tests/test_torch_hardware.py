"""The port's hardware registry, the VCK5000 design case and the shape set
against the JAX package: ``tests/test_hardware.py``'s registry, hazard and
energy-table tests on the port's entries (the H100, the VCK5000, their
variants), the VCK5000 entry field for field JAX's, ``design_case_vck5000``
and ``ALL_SHAPES`` / ``applicable`` for every arch equal to JAX's."""
import dataclasses
import math

import pytest

from repro.configs import ALL_SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jax_hw
from repro.core.plan import design_case_vck5000 as jax_design_case
from repro_torch.configs import ALL_ARCHS, ALL_SHAPES, applicable, cells, get_config
from repro_torch.core import hardware as hw_mod
from repro_torch.core.hardware import (
    ENERGY_PJ,
    H100_SXM,
    HARDWARE_VARIANTS,
    VCK5000,
    HardwareSpec,
    energy_params,
    get_hardware,
    register_variant,
    registered_hardware,
)
from repro_torch.core.plan import derive_plan, derive_serve_plan, design_case_vck5000
from repro_torch.core.pu import pick_pu


# ---------------------------------------------------------------- registry
def test_registry_resolves_builtin_devices():
    assert get_hardware("h100") is H100_SXM
    assert get_hardware("vck5000") is VCK5000


def test_unknown_name_lists_registered_variants():
    with pytest.raises(KeyError) as e:
        get_hardware("tpu_v9")
    msg = str(e.value)
    assert "h100" in msg and "vck5000" in msg


def test_declared_variants_are_registered():
    names = registered_hardware()
    for name in HARDWARE_VARIANTS:
        assert name in names
    nvl = get_hardware("h100-nvlink")
    assert nvl.ici_bandwidth == 450e9 and nvl.ici_links_per_chip == 1
    # non-replaced fields inherit from the base spec
    assert dataclasses.replace(nvl, name="h100", ici_bandwidth_per_link=0.0,
                               ici_links_per_chip=0) == H100_SXM
    int8w = get_hardware("vck5000-int8w")
    assert int8w == dataclasses.replace(VCK5000, name="vck5000-int8w", peak_ops_int8=290e12,
                                        tdp_watts=300.0)


def test_register_variant_replaces_fields_only(monkeypatch):
    monkeypatch.setattr(hw_mod, "_REGISTRY", dict(hw_mod._REGISTRY))
    v = register_variant("h100-testonly", "h100", tdp_watts=1.0)
    assert v.tdp_watts == 1.0
    assert v.peak_flops_bf16 == H100_SXM.peak_flops_bf16
    assert get_hardware("h100-testonly") is v


def test_jax_tpu_entries_stay_out():
    """TPU figures are JAX's: the port registers none of them."""
    assert not any(n.startswith("tpu") for n in registered_hardware())
    assert registered_hardware() == ("h100", "h100-nvlink", "vck5000", "vck5000-int8w")


# ------------------------------------------------- the entries against JAX
def test_vck5000_is_jax_field_for_field():
    assert dataclasses.asdict(VCK5000) == dataclasses.asdict(jax_hw.VCK5000)
    assert get_hardware("vck5000-int8w") == HardwareSpec(
        **dataclasses.asdict(jax_hw.get_hardware("vck5000-int8w")))
    assert ENERGY_PJ == jax_hw.ENERGY_PJ
    assert [f.name for f in dataclasses.fields(HardwareSpec)] == [
        f.name for f in dataclasses.fields(jax_hw.HardwareSpec)]


def test_h100_has_no_price_and_no_node():
    """The H100 keeps its data-sheet figures with no price and no tech node:
    the search charges the whole TDP (its fallback) and $/token reads 0."""
    assert H100_SXM.tech_node == "" and H100_SXM.dollars_per_hour == 0.0
    assert energy_params(H100_SXM) == {} and H100_SXM.tdp_watts == 700.0


def test_nvlink_variant_plans_as_the_h100():
    """The plan reads no interconnect field: the variant's plans are the
    H100's."""
    for arch in ("qwen3-1.7b", "mixtral-8x7b", "rwkv6-1.6b"):
        cfg = get_config(arch)
        for mesh in ({"data": 1, "model": 1}, {"data": 16, "model": 16}):
            assert (derive_plan(cfg, mesh, get_hardware("h100-nvlink"), batch=256, seq_len=4096)
                    == derive_plan(cfg, mesh, H100_SXM, batch=256, seq_len=4096))
            if arch != "rwkv6-1.6b":  # no serve plan for a recurrent arch
                assert (derive_serve_plan(cfg, mesh, get_hardware("h100-nvlink"), max_seq_len=2048)
                        == derive_serve_plan(cfg, mesh, H100_SXM, max_seq_len=2048))


@pytest.mark.parametrize("mnk", [(128, 128, 128), (1, 4096, 4096), (8192, 512, 3), (7, 9, 11)])
@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
def test_matmul_time_equals_jax(mnk, dtype_bytes):
    for port, jx in ((VCK5000, jax_hw.VCK5000), (H100_SXM, jax_hw.HardwareSpec(
            **dataclasses.asdict(H100_SXM)))):
        assert port.matmul_time_s(*mnk, dtype_bytes) == jx.matmul_time_s(*mnk, dtype_bytes)


# ------------------------------------------------- degenerate-device hazards
def _degenerate(**kw) -> HardwareSpec:
    base = dict(
        name="degenerate",
        peak_flops_bf16=1e12,
        peak_ops_int8=2e12,
        vmem_bytes=1 << 20,
        hbm_bytes=16 * 1024**3,
        hbm_bandwidth=0.0,
        ici_bandwidth_per_link=0.0,
        ici_links_per_chip=0,
    )
    base.update(kw)
    return HardwareSpec(**base)


def test_zero_bandwidth_machine_balance_is_inf():
    hw = _degenerate()
    assert math.isinf(hw.machine_balance_bf16)
    assert hw.ici_bandwidth == 0.0


def test_zero_bandwidth_matmul_time_is_inf_not_crash():
    assert math.isinf(_degenerate().matmul_time_s(128, 128, 128))


def test_planner_total_on_degenerate_device():
    cfg = get_config("smollm-135m")
    hw = _degenerate()
    mesh = {"data": 1, "model": 1}
    plan = derive_plan(cfg, mesh, hw, batch=4, seq_len=64, training=False)
    assert plan is not None
    serve = derive_serve_plan(cfg, mesh, hw, max_seq_len=128)
    assert serve.decode_batch >= 1
    tile = pick_pu(8, cfg.d_model, cfg.d_model, hw, dtype_bytes=2)
    assert tile.block_m >= 1


def test_vck5000_no_ici_paths_total():
    cfg = get_config("smollm-135m")
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, VCK5000, max_seq_len=256)
    assert serve.decode_batch >= 1
    assert VCK5000.ici_bandwidth == 0.0


# ------------------------------------------------------------ energy table
def test_energy_params_merges_node_row_with_overrides():
    ep = energy_params(VCK5000)
    assert ep["mem_byte"] == 150.0  # device override wins
    assert ep["flop_bf16"] == ENERGY_PJ["7nm"]["flop_bf16"]  # node row
    assert ep == jax_hw.energy_params(jax_hw.VCK5000)


def test_energy_params_empty_without_tech_node():
    hw = _degenerate(tech_node="")
    assert energy_params(hw) == {}
    hw2 = dataclasses.replace(hw, energy_pj=(("mem_byte", 9.0),))
    assert energy_params(hw2) == {"mem_byte": 9.0}


def test_spec_stays_hashable():
    hash(H100_SXM)
    hash(get_hardware("vck5000-int8w"))
    hash(get_hardware("h100-nvlink"))


# ------------------------------------------------ design case and shapes
@pytest.mark.parametrize("kw", [{}, {"seq_len": 512}, {"d_model": 1024, "d_ff": 4096,
                                                         "n_heads": 16},
                                {"seq_len": 4096, "d_model": 4096, "d_ff": 16384,
                                 "n_heads": 32}])
def test_design_case_vck5000_equals_jax(kw):
    assert design_case_vck5000(**kw) == jax_design_case(**kw)


def test_design_case_reproduces_the_paper():
    case = design_case_vck5000()
    assert case["factor1"] == pytest.approx(1.5, rel=0.05)
    assert case["factor2_mb"] == pytest.approx(7.56, rel=0.05)
    assert case["p_atb"] == 4 and case["mode"] == "spatial"


def test_shapes_and_applicable_equal_jax_for_every_arch():
    assert [dataclasses.astuple(s) for s in ALL_SHAPES] == [
        dataclasses.astuple(s) for s in JAX_SHAPES]
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        got = [(s.name, *applicable(cfg, s)) for s in ALL_SHAPES]
        assert got == [(s.name, *jax_applicable(jcfg, s)) for s in JAX_SHAPES], arch
        assert [(s.name, ok, why) for s, ok, why in cells(cfg)] == got
