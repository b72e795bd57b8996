"""The reference against itself at a tiny size: rooms are independent
(a batch equals its rooms stepped alone), a trajectory repeats, and the
bfloat16 control departs from it."""

import pytest
import torch

from nfbench import program
from nfbench.checks.world import cells_off, reference_inputs
from nfbench.deployments import world
from nfbench.reference.build import initial_rooms
from nfbench.reference.tick import Geometry, step
from nfbench.run import derived_seed

from .conftest import tiny_cell


@pytest.fixture(scope="module")
def rooms_start():
    """Three tiny worlds in one batch, each from its own seed's draws; the
    cells the tick never touches come from one program start state."""
    torch.set_num_threads(1)
    cfg = tiny_cell("world_1m.frames")["config"]
    seeds = [derived_seed(s) for s in (99, 100, 2**33 + 1)]
    dep = world.deploy(cfg, seeds[0], torch.device("cpu"))
    snap = program.Snapshot(dep.leaves())
    snap.take(dep.leaves())
    lay = dep.layout()
    dep.close()
    base = {k: v.expand(len(seeds), *v.shape[1:]).clone() for k, v in snap.as_rooms().items()}
    draws = [reference_inputs(cfg, s, torch.device("cpu")) for s in seeds]
    inputs = {k: torch.cat([d[k] for d in draws]) for k in draws[0]}
    geo = Geometry.from_config(cfg["geometry"])
    return initial_rooms(base, lay, geo, cfg["recipe"], inputs), lay, geo


def _run(st, lay, geo, n, fdt=torch.float32):
    for _ in range(n):
        st, ctr = step(st, lay, geo, fdt)
    return st, ctr


def test_a_batch_equals_its_rooms_alone(rooms_start):
    st, lay, geo = rooms_start
    whole, ctr = _run(st, lay, geo, 40)
    for r in (0, 1, 2):
        alone, ctr1 = _run({k: v[r:r + 1] for k, v in st.items()}, lay, geo, 40)
        assert cells_off(alone, {k: v[r:r + 1] for k, v in whole.items()}) == 0
        assert all(int(ctr1[n][0]) == int(ctr[n][r]) for n in ctr)
    assert cells_off({k: v[:1] for k, v in whole.items()},
                     {k: v[1:2] for k, v in whole.items()}) > 0


def test_a_trajectory_repeats(rooms_start):
    st, lay, geo = rooms_start
    a, _ = _run(st, lay, geo, 10)
    b, _ = _run(st, lay, geo, 10)
    assert cells_off(a, b) == 0
    assert int(a["tick"][0]) == 10


def test_bfloat16_departs(rooms_start):
    st, lay, geo = rooms_start
    a, _ = _run(st, lay, geo, 5)
    b, _ = _run(st, lay, geo, 5, torch.bfloat16)
    assert cells_off(a, b) > 100
