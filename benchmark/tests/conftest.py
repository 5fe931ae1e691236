"""The benchmark's own tests.  They run on the CPU at tiny sizes, except
those marked `cuda`, which decide inside the test whether there is a card.
Nothing here imports JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")
