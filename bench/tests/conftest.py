"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of the repository.  The program is imported from ``src``."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
