"""CPU tests of the benchmark harness: python -m pytest prove_bench/tests -q
from the repository root.  None of them needs the card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
