"""The control of the check at a tiny size: the reference in the
precision below the configuration's, judged as the program is judged,
comes out not correct; a world's reference in float32 in its place
passes."""

import pytest
import torch

from nfbench import run
from nfbench.control import control_run

from .conftest import CELLS, tiny_cell

WORLD_CELLS = [c for c in CELLS
               if run.find_cell(run.load_benchmark(), c)["config"]["kind"] == "world"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_bfloat16_control_fails(workload, seed, cpu_threads):
    found = tiny_cell(workload)
    numbers = control_run(found, seed, torch.device("cpu"))
    chk = run.parts(found)[2]
    assert not chk.passed(numbers)
    assert any(numbers[n] > lim for n, lim in chk.LIMITS.items())
    if found["config"]["kind"] == "world":
        assert numbers["cells_off"] > 0


@pytest.mark.parametrize("workload", WORLD_CELLS)
def test_float32_in_the_controls_place_passes(workload, cpu_threads):
    found = tiny_cell(workload)
    numbers = control_run(found, 3, torch.device("cpu"), fdt=torch.float32)
    assert run.parts(found)[2].passed(numbers)
