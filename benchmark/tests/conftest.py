"""The benchmark's own CPU tests: `python -m pytest benchmark/tests -q`.
They import the program and the benchmark, never JAX."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "bench_dry: drives whole cells at tiny sizes on the CPU")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
