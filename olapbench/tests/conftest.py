"""The benchmark's CPU tests: the program from ``src/``, the benchmark as
the ``olapbench`` package. Run from the repository root:
``python -m pytest -q olapbench/tests`` (the card's tests are marked
``gpu`` and skip here)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
