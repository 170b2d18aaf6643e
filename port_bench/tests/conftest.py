"""The harness's own tests (``python3 -m pytest port_bench/tests``).

Tests marked ``card`` need an NVIDIA card; each decides inside the test
whether there is one and skips here with the reason."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
