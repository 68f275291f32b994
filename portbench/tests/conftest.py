"""CPU tests of the benchmark; tests marked ``card`` need a CUDA card and
decide inside the test whether one is there (run them on the card with
``python3 -m pytest portbench/tests -m card``)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")
