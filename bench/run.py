"""Run one cell of the port's benchmark on the card:

    python bench/run.py --workload qwen3-1.7b.decode --seed 7 --seconds 30 --trace 0

Prints one JSON line (the last of standard output); exits non-zero, printing
no result, without a card or in a tree without the port (``src/``)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

from bench.portbench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
