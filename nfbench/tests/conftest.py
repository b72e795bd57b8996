"""The harness's own tests.  Run with ``python -m pytest nfbench/tests``;
the ``cuda`` tests run only where a card is present (on the card:
``python -m pytest nfbench/tests -m cuda``)."""

import copy
import math

import pytest


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


def tiny_cell(workload: str, late=(12, 14)) -> dict:
    """A cell of BENCHMARK.json cut to a size the CPU steps in seconds: a
    4,096-NPC world at the program's own geometry for that size, and check
    frames early in the window."""
    from nfbench import run

    found = copy.deepcopy(run.find_cell(run.load_benchmark(), workload))
    cfg = found["config"]
    n = 4096
    cfg["entities"] = n
    cfg["recipe"]["seeded"] = n
    ext = max(64.0, float(math.sqrt(n / 0.4)))
    cfg["geometry"].update(extent=ext, width=int(ext / 4.0), kv=16, ka=6)
    cfg["rows"] = {"NPC": n, "Player": 64}
    cfg["occupied_rows"] = {"NPC": n, "Player": 0}
    found["traffic"].update(early_frames=4, late_frames=list(late), trace_from=5,
                            trace_frames=3)
    return found


CELLS = ("world_1m.frames",)
