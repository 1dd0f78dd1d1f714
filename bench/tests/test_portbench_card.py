"""On the card, at each cell's own size: the program comes out correct and
the float8 control, judged by the same limits, not correct.  Skips without a
card (decided inside the test).  Run on the card with

    python -m pytest -q -m card bench/tests
"""
import json
import subprocess
import sys

import pytest

from bench.portbench import spec

SEED = 6_000_000_001


@pytest.mark.card
@pytest.mark.parametrize("name", ["qwen3-1.7b.decode", "qwen3-1.7b.code", "rwkv6-1.6b.train",
                                  "qwen3-1.7b.train"])
def test_the_control_fails_where_the_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name, "--seed", str(SEED),
                          "--seconds", "5", "--trace", "0", "--control", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    # the float8 reference, judged as the program is, comes out not correct
    assert res["controls_correct"]["fp8"] is False, res["readings"]
