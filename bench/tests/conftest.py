"""The benchmark's tests: ``python -m pytest -q bench/tests`` from the
repository's root (``-m cuda`` for the ones that need the card)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
