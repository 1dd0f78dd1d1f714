"""pytest settings of the benchmark's own tests (``python -m pytest bench/tests``).

``card``: a test that needs an NVIDIA GPU; it decides inside the test
whether there is one and skips without.  The port is imported from
``src``, as the harness imports it."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")
