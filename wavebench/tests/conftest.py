"""CPU tests of the benchmark harness (``python -m pytest wavebench/tests``
from the repository root).  Nothing here imports JAX; the ``gpu`` marker
is the repository's card marker."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
