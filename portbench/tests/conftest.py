"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q``
(the card's, marked ``cuda``, skip without one)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
