"""The control of the check at a tiny size: the reference in bfloat16,
judged as the program is judged, comes out not correct."""

import pytest
import torch

from nfbench.check import passed
from nfbench.control import control_run

from .conftest import CELLS, tiny_cell


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_bfloat16_control_fails(workload, seed, cpu_threads):
    numbers = control_run(tiny_cell(workload), seed, torch.device("cpu"))
    assert not passed(numbers)
    assert numbers["cells_off"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_float32_in_the_controls_place_passes(workload, cpu_threads):
    numbers = control_run(tiny_cell(workload), 3, torch.device("cpu"), fdt=torch.float32)
    assert passed(numbers)
