"""The benchmark's own tests: ``python -m pytest benchmarks/tests``.  They
run on the CPU at small sizes; those marked ``cuda`` skip without a card."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
