"""The benchmark's own tests: on the CPU, at a tiny size, with the port's
plain kernel versions. Run from the repository's root:
``python -m pytest -q bench/tests``."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
