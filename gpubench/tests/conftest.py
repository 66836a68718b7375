"""The `chip` marker: tests that need an NVIDIA card skip without one,
deciding inside the test."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips on the CPU")


@pytest.fixture
def tiny(tmp_path):
    """The tiny copy of the benchmark: `(root, bench_dir)`."""
    from gpubench.tests import tiny as tiny_bench
    return tmp_path, tiny_bench.make(tmp_path)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
