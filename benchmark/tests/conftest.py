"""Tests of the benchmark itself.  ``card`` marks a test that needs an
NVIDIA card; it decides inside the test, and skips without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
