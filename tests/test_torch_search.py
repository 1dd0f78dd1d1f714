"""The design-space search, the serve tile, ``--from-family`` and the plan
autotuner against the JAX package.

On a spec built from JAX's ``tpu_v5e`` fields (TPU figures stay out of the
port's registry) the port's ``search_family``, ``family_report`` (record and
markdown) and ``pick_from_family`` give JAX's points, plans and frontier,
floats to 1e-12 relative.  On the H100's fields they agree but for the
tile: JAX's tile search has no tile on the H100 (its hook is stubbed on the
JAX side to run it), the port's tile is the MM kernel's CTA tile."""
import argparse
import dataclasses
import math

import pytest

import repro.core.autotune as jax_autotune
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jax_hw
from repro.core.pu import MMTileSpec as JaxTile
from repro.core.search import family_report as jax_family_report
from repro.core.search import search_family as jax_search_family
from repro.launch.serve import ServeArgs
from repro.launch.serve import build_parser as jax_serve_parser
from repro.launch.serve import pick_from_family as jax_pick_from_family
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.core import hardware as hw_mod
from repro_torch.core.autotune import (Candidate, autotune, default_candidates,
                                       resolve_serve_tile)
from repro_torch.core.hardware import H100_SXM, HardwareSpec, get_hardware
from repro_torch.core.plan import H100_MM_CTA_TILE, derive_serve_plan
from repro_torch.core.search import (SearchSpace, default_space, dominates, expected_accepted,
                                     family_report, pareto_frontier, search_family)
from repro_torch.launch.mesh import DryRunMesh
from repro_torch.launch.serve import build_parser, pick_from_family

TPU = HardwareSpec(**dataclasses.asdict(jax_hw.TPU_V5E))
ARCHS = ("qwen3-1.7b", "smollm-135m", "qwen3-moe-30b-a3b")


def same(a, b, path="") -> None:
    """``a`` equals ``b``, floats to 1e-12 relative (inf equal to inf)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert (math.isinf(a) and a == b) or a == pytest.approx(b, rel=1e-12, abs=0), path
    else:
        assert a == b, path


def _records(result, tile: bool = True) -> tuple:
    def rec(p):
        r = p.to_record()
        r["step_s"] = p.step_s
        r["unrounded"] = (p.tokens_per_s, p.usd_per_mtok, p.mj_per_tok)
        if not tile:
            r.pop("tile")
        return r

    return [rec(p) for p in result.points], [rec(p) for p in result.frontier]


@pytest.mark.parametrize("arch", ARCHS)
def test_family_equals_jax_on_the_tpu_fields(arch):
    got = search_family(arch, TPU)
    want = jax_search_family(arch, jax_hw.TPU_V5E)
    assert len(got.points) == len(want.points) and got.frontier
    same(_records(got), _records(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_family_report_equals_jax(arch, tmp_path, monkeypatch):
    """The record and its markdown, written as JAX writes them (the port's
    registry gets the TPU spec for the call only)."""
    monkeypatch.setattr(hw_mod, "_REGISTRY", {**hw_mod._REGISTRY, "tpu_v5e": TPU})
    result, record = family_report(arch, "tpu_v5e", max_seq_len=1024, out_dir=tmp_path / "p")
    jresult, jrecord = jax_family_report(arch, "tpu_v5e", max_seq_len=1024,
                                         out_dir=tmp_path / "j")
    assert record["markdown"] == jrecord["markdown"]
    same(record, jrecord)
    assert ((tmp_path / "p" / f"tpu_v5e__{arch}.json").read_text()
            == (tmp_path / "j" / f"tpu_v5e__{arch}.json").read_text())


def test_vck5000_family_equals_jax():
    """The paper's platform is in both registries: same points, frontier
    and tiles, one chip (no interconnect)."""
    got = search_family("qwen3-1.7b", "vck5000")
    want = jax_search_family("qwen3-1.7b", "vck5000")
    same(_records(got), _records(want))
    assert {p.mesh["model"] for p in got.points} == {1}


@pytest.mark.parametrize("hw_name", ["h100", "h100-nvlink"])
def test_family_on_the_h100_fields_differs_only_in_tile(hw_name, monkeypatch):
    """JAX's search on the same fields, its tile hook stubbed (its VMEM tile
    search finds no tile on the H100): every other field is equal; the
    port's tile is the MM kernel's CTA tile, its $/token 0 (no price)."""
    hw = get_hardware(hw_name)
    monkeypatch.setattr(jax_autotune, "resolve_serve_tile",
                        lambda cfg, serve, hw: JaxTile("STUB", 1, 1, 1))
    got = search_family("qwen3-1.7b", hw)
    want = jax_search_family("qwen3-1.7b", jax_hw.HardwareSpec(**dataclasses.asdict(hw)))
    same(_records(got, tile=False), _records(want, tile=False))
    assert {p.tile for p in got.points} == {"CTA(128x128x64)"}
    assert all(p.usd_per_mtok == 0.0 for p in got.points)
    models = {p.mesh["model"] for p in got.points}
    assert models == ({1, 2, 4} if hw_name == "h100-nvlink" else {1})


def test_resolve_serve_tile():
    cfg, jcfg = get_config("qwen3-1.7b"), jax_get_config("qwen3-1.7b")
    for gamma in (0, 4):
        serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, TPU, max_seq_len=2048,
                                  spec_len=gamma, draft="ngram" if gamma else "none")
        assert dataclasses.asdict(resolve_serve_tile(cfg, serve, TPU)) == dataclasses.asdict(
            jax_autotune.resolve_serve_tile(jcfg, serve, jax_hw.TPU_V5E))
        tile = resolve_serve_tile(cfg, serve, H100_SXM)
        assert (tile.block_m, tile.block_n, tile.block_k) == H100_MM_CTA_TILE


class _Mesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("criterion", ["throughput", "cost", "energy"])
@pytest.mark.parametrize("model", [1, 2])
def test_pick_from_family_equals_jax(criterion, model, capsys):
    argv = ["--arch", "qwen3-1.7b", "--max-seq", "1024", "--from-family", criterion]
    a = build_parser().parse_args(argv)
    ja = ServeArgs.from_namespace(jax_serve_parser().parse_args(argv))
    mesh = {"data": 1, "model": model}
    got = pick_from_family(a, get_config("qwen3-1.7b"), mesh, TPU)
    printed = capsys.readouterr().out
    want = jax_pick_from_family(ja, jax_get_config("qwen3-1.7b"), _Mesh(mesh), jax_hw.TPU_V5E)
    assert got.to_record() == want.to_record()
    assert printed == capsys.readouterr().out


# ------------------------------------------------------ search invariants
def test_single_candidate_space_degenerates_to_planner():
    cfg = get_config("qwen3-1.7b")
    space = SearchSpace(spec_lens=(None,), draft="none")
    result = search_family(cfg, H100_SXM, space)
    assert len(result.points) == 1
    assert result.points[0].plan == derive_serve_plan(cfg, {"data": 1, "model": 1}, H100_SXM,
                                                      max_seq_len=space.max_seq_len)


def test_frontier_is_non_dominated_and_deterministic():
    r = search_family("qwen3-1.7b", "h100-nvlink")
    assert r.frontier and all(p.feasible for p in r.frontier)
    for p in r.frontier:
        assert not any(dominates(q, p) for q in r.frontier if q is not p)
    again = search_family("qwen3-1.7b", "h100-nvlink")
    assert [p.to_record() for p in r.points] == [p.to_record() for p in again.points]
    assert pareto_frontier(r.points + r.points) == r.frontier
    assert expected_accepted(0, 0.6) == 1.0 and expected_accepted(4, 1.0) == 5.0
    assert default_space(H100_SXM).mesh_models == (1,)


# ------------------------------------------------------------ autotune
def test_candidate_sets():
    dense = default_candidates(get_config("qwen3-1.7b"))
    moe = default_candidates(get_config("mixtral-8x7b"))
    assert {c.name for c in dense} == {"planner-default", "force-spatial", "force-temporal",
                                       "split-qkv"}
    assert "moe-sort-dispatch" in {c.name for c in moe}


def test_autotune_picks_the_shortest_step():
    """On a (pod 2, data 2, model 2) dry-run mesh every candidate traces but
    the pipeline over the pods, which the port refuses with a model axis;
    the winner has the shortest roofline step of those that fit, and the
    refused candidate keeps its error."""
    shape = dataclasses.replace(TRAIN_4K, seq_len=64, global_batch=8)
    cands = default_candidates(get_config("qwen3-1.7b-reduced")) + [
        Candidate("pipeline", {"pod_role": "pipeline"})]
    best, scored = autotune("qwen3-1.7b-reduced", shape, mesh=DryRunMesh({"pod": 2, "data": 2, "model": 2}),
                            candidates=cands)
    ok = [c for c in scored if c.step_s is not None]
    assert len(ok) == 4 and best is not None and all(c.fits for c in ok)
    assert best.step_s == min(c.step_s for c in ok)
    assert all(c.compute_s > 0 and c.collective_s >= 0 for c in ok)
    refused = scored[-1]
    assert refused.step_s is None and "pipeline" in refused.error, refused


def test_serve_launcher_flag():
    a = build_parser().parse_args(["--arch", "qwen3-1.7b", "--from-family", "energy"])
    assert a.from_family == "energy"
    assert build_parser().parse_args(["--arch", "qwen3-1.7b"]).from_family is None
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--arch", "qwen3-1.7b", "--from-family", "latency"])
    assert isinstance(a, argparse.Namespace)
