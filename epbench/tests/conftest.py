"""The benchmark's CPU tests: run from the repository's root as
``PYTHONPATH=src:. python -m pytest -q epbench/tests`` (the port under
``src/``, the harness as the package ``epbench``)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
