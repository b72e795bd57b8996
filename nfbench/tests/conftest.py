"""The harness's own tests.  Run with ``python -m pytest nfbench/tests``;
the ``cuda`` tests run only where a card is present (on the card:
``python -m pytest nfbench/tests -m cuda``)."""

import copy

import pytest

from nfbench import run


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_cell(workload: str, **kw) -> dict:
    """A cell of BENCHMARK.json cut by its deployment kind's ``tiny`` to a
    size the CPU runs in seconds."""
    found = copy.deepcopy(run.find_cell(run.load_benchmark(), workload))
    return run.named("deployments", found["config"]["kind"]).tiny(found, **kw)


# every cell of BENCHMARK.json, so that a cell added there is tested here
CELLS = tuple(w["name"] for w in run.load_benchmark()["workloads"])
