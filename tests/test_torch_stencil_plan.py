"""The launch planner of the port's fold kernels
(noahgameframe_tpu_torch/ops/stencil_cuda.py ``plan_fold``): its tiles
cover the grid exactly once, a block's shared memory stays within the
H100's 232,448 bytes, and the chunk kernels are chosen exactly when a
one-cell tile's halo does not fit.  Pure arithmetic; no card needed."""

import numpy as np
import pytest

from noahgameframe_tpu_torch.ops import stencil_cuda as sc

# (width, victim bucket, attacker bucket): the 1M geometry, the boost
# ceiling (x8), grids around the tile sizes, and buckets up to 2048
SHAPES = [
    (395, 16, 6), (395, 128, 48), (1, 64, 32), (2, 32, 16), (9, 16, 6), (13, 16, 6),
    (17, 8, 8), (6, 16, 12), (3, 1024, 1024), (64, 2048, 6), (40, 256, 256),
    (100, 512, 400), (2048, 16, 6), (2048, 2048, 2048), (7, 1, 1), (33, 4, 0),
]


def _coverage(plan):
    """How many blocks' tiles cover each cell of the grid."""
    w = plan.width
    y0, x0, hy, hx = plan.tiles()
    assert (hy >= 1).all() and (hx >= 1).all()
    diff = np.zeros((w + 1, w + 1), np.int64)
    np.add.at(diff, (y0, x0), 1)
    np.add.at(diff, (y0, x0 + hx), -1)
    np.add.at(diff, (y0 + hy, x0), -1)
    np.add.at(diff, (y0 + hy, x0 + hx), 1)
    return diff.cumsum(0).cumsum(1)[:w, :w]


@pytest.mark.parametrize("kind", ["combat", "fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "w%d_kv%d_ka%d" % s)
def test_plan_covers_fits_and_chunks_exactly_when_needed(kind, shape):
    w, kv, ka = shape
    plan = sc.plan_fold(kind, w, kv, ka)
    assert plan.kind == kind and plan.width == w
    assert (_coverage(plan) == 1).all()
    assert plan.smem <= sc.SMEM_LIMIT == 232_448
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= sc.MAX_THREADS
    assert 1 <= plan.ty <= w and 1 <= plan.tx <= w
    one_cell_fits = sc.tile_bytes(kind, 1, 1, kv, ka) <= sc.SMEM_LIMIT
    assert (plan.chunk > 0) == (not one_cell_fits)
    if plan.chunk:
        assert (plan.ty, plan.tx) == (1, 1) and plan.blocks == w * w
        assert 1 <= plan.chunk <= max(kv, ka, 1)
    else:
        assert plan.smem == sc.tile_bytes(kind, plan.ty, plan.tx, kv, ka)


@pytest.mark.parametrize("kind", ["combat", "fused"])
def test_plan_at_1m_is_tiled_within_the_target(kind):
    """The main path's geometry gets a multi-cell tile small enough that
    four blocks share an SM."""
    plan = sc.plan_fold(kind, 395, 16, 6)
    assert plan.chunk == 0 and plan.ty * plan.tx >= 32
    assert plan.smem <= sc.SMEM_TARGET


@pytest.mark.parametrize("kind", ["combat", "fused"])
def test_plan_chunks_under_a_smaller_limit_and_raises_when_nothing_fits(kind):
    limit = sc.tile_bytes(kind, 1, 1, 16, 6) - 1
    plan = sc.plan_fold(kind, 10, 16, 6, smem_limit=limit)
    assert plan.chunk > 0 and plan.smem <= limit
    assert (_coverage(plan) == 1).all()
    with pytest.raises(ValueError):
        sc.plan_fold(kind, 10, 16, 6, smem_limit=16)
