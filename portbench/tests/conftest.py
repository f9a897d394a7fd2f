"""The benchmark's own tests: ``python -m pytest portbench/tests``. Tests
marked ``card`` need a CUDA card; each decides inside itself whether there
is one, and skips without."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
