"""The port stands alone: no file of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, importing it pulls in
neither, and its entry points raise without CUDA unless the caller asks for
the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)"),
    re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)"),
    re.compile(r"^\s*import\s+.*\bjax\b"),
]


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def test_no_jax_or_repro_imports():
    bad = []
    for f in _sources():
        for n, line in enumerate(f.read_text().splitlines(), 1):
            if any(p.search(line) for p in FORBIDDEN):
                bad.append(f"{f.relative_to(ROOT)}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_importing_the_port_pulls_in_neither():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.bridge, repro_torch.models.params\n"
        "import repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.rwkv6.ops, repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.rmsnorm.ops, repro_torch.kernels.mm_pu.ops\n"
        "import repro_torch.core.pu\n"
        "import repro_torch.models.rwkv6\n"
        "import repro_torch.launch.train, repro_torch.train.train_step\n"
        "import repro_torch.train.compression, repro_torch.data.pipeline\n"
        "import repro_torch.launch.dryrun, repro_torch.core.search, repro_torch.core.autotune\n"
        "import repro_torch.core.roofline, repro_torch.core.op_cost, repro_torch.configs.shapes\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_execution_plan
    from repro_torch.launch.serve import main
    from repro_torch.models.params import init_params

    cfg = get_config("smollm-135m-reduced")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, derive_execution_plan(cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "smollm-135m-reduced", "--requests", "1"])
    assert resolve_device("cpu").type == "cpu"
    # the dry run needs no card; its --calibrate serves on one and raises
    from repro_torch.launch import dryrun

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--calibrate"])
    assert resolve_device("meta").type == "meta"


def test_dry_run_needs_no_card(tmp_path):
    """``launch.dryrun`` traces a production cell on the meta device with no
    card and no process group, in a process that never imports JAX."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'smollm-135m', '--shape', 'decode_32k', '--mesh', 'single',"
        f" '--out-dir', {str(tmp_path)!r}])\n"
        "assert not torch.distributed.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"status": "ok"' in (tmp_path / "single" / "smollm-135m__decode_32k.json").read_text()


def test_device_defaults_raise_without_cuda():
    """Every entry point that places tensors defaults to the card: without
    one it raises unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    from repro_torch.bridge import from_jax
    from repro_torch.configs import get_config
    from repro_torch.core.plan import derive_execution_plan, derive_serve_plan
    from repro_torch.models.cache import init_cache, init_paged_cache
    from repro_torch.models.params import init_params
    from repro_torch.serve import greedy_generate

    cfg = get_config("qwen3-1.7b-reduced")
    plan = derive_execution_plan(cfg)
    serve = derive_serve_plan(cfg, {"data": 1, "model": 1}, max_seq_len=32, decode_batch=2)
    tree = {"w": np.ones((2, 2), np.float32)}
    calls = {
        "from_jax": lambda **kw: from_jax(tree, **kw),
        "init_paged_cache": lambda **kw: init_paged_cache(cfg, plan, serve, **kw),
        "init_cache": lambda **kw: init_cache(cfg, plan, 2, 8, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu") is not None, name
    params = init_params(cfg, plan, torch.float32, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(params, cfg, plan, batch, n_steps=2, cache_len=6)
    assert greedy_generate(params, cfg, plan, batch, n_steps=2, cache_len=6,
                           device="cpu").shape == (1, 2)
