"""The port's game role against the JAX package's, byte for byte, with
4-tick trains (the scenario and the checks of ``test_torch_game_role.py``):
each frame fans four stacked ticks out in tick order."""

from __future__ import annotations

import pytest

from test_torch_game_role import both, check_streams, check_worlds


@pytest.fixture(scope="module")
def streams():
    return both("train")


def test_served_streams_equal_jax_per_frame(streams):
    check_streams(streams)


def test_served_digest_and_counters_equal_jax(streams):
    check_worlds(streams)
