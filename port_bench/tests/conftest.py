"""The benchmark's own tests: CPU tests of the harness at tiny sizes, and
tests marked ``chip`` that need a CUDA device (run them on a machine with
one: ``python -m pytest port_bench/tests -m chip``). Whether a device is
there is decided inside the ``cuda`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
