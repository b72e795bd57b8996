"""The wander phase and the tick key's fold_in as custom ops
(``nf::wander``, ``nf::fold_in``): their fake versions, the CPU's plain
path, and the ops' vmap rules with the CUDA launch emulated by the plain
versions.  The kernels themselves are held against the plain versions on
the card in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from noahgameframe_tpu_torch.core import prng
from noahgameframe_tpu_torch.core.rounding import recip32
from noahgameframe_tpu_torch.game.world import build_benchmark_world
from noahgameframe_tpu_torch.ops import stencil_cuda as sc
from noahgameframe_tpu_torch.parallel.rooms import no_vmap_fallback

EXTENT = 64.0
COLS = dict(pos_col=1, tgt_col=3, speed_col=0, gate_col=2, hp_col=4)
SCALARS = dict(speed_scale=recip32(10000.0), dt=float(np.float32(1 / 30)), extent=EXTENT)


def population(n, seed):
    """(alive, i32, vec, key): n rows of a 4-column vec bank and a 6-column
    i32 bank, with arrivals, gates, dead rows and walkers at the walls."""
    rng = np.random.default_rng(seed)
    vec = rng.uniform(-1.0, EXTENT + 1.0, (n, 4, 3)).astype(np.float32)
    vec[: n // 4, 3, :2] = vec[: n // 4, 1, :2]  # forced arrivals
    i32 = rng.integers(-5, 50, (n, 6)).astype(np.int32)
    i32[:, 0] = rng.integers(0, 400_000, n)  # MOVE_SPEED: up to 40 units/s
    i32[:, 2] = np.where(rng.random(n) < 0.2, 1, 0)  # MOVE_GATE
    i32[:, 4] = rng.integers(-1, 3, n) * 50  # HP <= 0 on half
    alive = rng.random(n) < 0.8
    key = prng.fold_in(prng.prng_key(seed, "cpu"), seed)
    return torch.from_numpy(alive), torch.from_numpy(i32), torch.from_numpy(vec), key


def test_fake_versions_give_shapes_and_dtypes():
    with FakeTensorMode():
        vec = torch.empty((5, 4, 3), dtype=torch.float32)
        out = torch.ops.nf.wander(torch.empty(5, dtype=torch.bool),
                                  torch.empty((5, 6), dtype=torch.int32), vec,
                                  torch.empty(2, dtype=torch.int64), *COLS.values(),
                                  *SCALARS.values(), 10)
        assert out.shape == (5, 4, 3) and out.dtype == torch.float32
        key = torch.empty(2, dtype=torch.int64)
        for data in (torch.empty((), dtype=torch.int32), None):
            k = torch.ops.nf.fold_in(key, data, 7)
            assert k.shape == (2,) and k.dtype == torch.int64


class _NfOps(TorchDispatchMode):
    """Records the ``nf::`` ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "nf":
            self.seen.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_cpu_tensors_never_reach_the_ops():
    """On the CPU the wrappers are their plain versions, a world's tick
    dispatches no nf:: op and no kernel launch is counted."""
    sc.reset_launch_counts()
    alive, i32, vec, key = population(512, 1)
    got = sc.wander(alive, i32, vec, key, **COLS, **SCALARS, offset=6)
    want = sc.wander_plain(alive, i32, vec, key, **COLS, **SCALARS, offset=6)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    tick = torch.tensor(5, dtype=torch.int32)
    assert torch.equal(sc.fold_in(key, tick), prng.fold_in(key, tick))
    assert torch.equal(sc.fold_in(key, 3), prng.fold_in(key, 3))
    w = build_benchmark_world(256, seed=4, device="cpu")
    with _NfOps() as mode:
        w.tick()
    assert mode.seen == []
    assert sc.KERNELS["wander"].launches == sc.KERNELS["fold_in"].launches == 0


def test_wander_plain_walks_draws_and_clamps():
    """The plain phase: dead rows and rows that do not arrive keep their
    targets, arrivals draw from flat counter ``offset + 2 * row + comp``,
    positions end inside [0, extent] and every other component is kept."""
    alive, i32, vec, key = population(4096, 2)
    out = sc.wander_plain(alive, i32, vec, key, **COLS, **SCALARS, offset=10)
    drew = (out[:, 3, :2] != vec[:, 3, :2]).any(-1)
    assert bool(drew.any()) and not bool((drew & ~alive).any())
    draw = prng.uniform(key, (4096 + 5, 2), 0.0, EXTENT)[5:]
    assert torch.equal(out[drew, 3, :2], draw[drew])
    assert float(out[:, 1, :2].min()) == 0.0 and float(out[:, 1, :2].max()) == EXTENT
    keep = torch.ones(4, 3, dtype=torch.bool)
    keep[1, :2] = keep[3, :2] = False
    assert torch.equal(out[:, keep], vec[:, keep])


def _emulated_launch_wander(alive, i32, vec, key, lead, cols, speed_scale, dt, extent, offset):
    for x, trail in ((alive, 1), (i32, 2), (vec, 3), (key, 1)):
        assert x.is_contiguous() and x.dim() == len(lead) + trail
    if not lead:
        return _emulated_launch_wander(alive[None], i32[None], vec[None], key[None], (1,), cols,
                                       speed_scale, dt, extent, offset)[0]
    sc.KERNELS["wander"].launches += 1
    return torch.stack([sc.wander_plain(alive[r], i32[r], vec[r], key[r], *cols, speed_scale, dt,
                                        extent, offset) for r in range(lead[0])])


def _emulated_launch_fold_in(key, data, value, lead):
    assert key.shape == (*lead, 2) and (data is None or data.shape == lead)
    if not lead:
        return _emulated_launch_fold_in(key[None], None if data is None else data[None], value,
                                        (1,))[0]
    sc.KERNELS["fold_in"].launches += 1
    return torch.stack([prng.fold_in(key[r], value if data is None else data[r])
                        for r in range(lead[0])])


@pytest.mark.parametrize("rooms", [1, 3])
def test_vmap_rules_make_one_launch_for_all_rooms(monkeypatch, rooms):
    """Under torch.func.vmap each op makes one launch for all rooms, with
    batched and unbatched keys and data, and gives the vmapped plain
    version (the launch is emulated by the plain version room by room)."""
    monkeypatch.setattr(sc, "_launch_wander", _emulated_launch_wander)
    monkeypatch.setattr(sc, "_launch_fold_in", _emulated_launch_fold_in)
    pops = [population(256, 10 + r) for r in range(rooms)]
    alive, i32, vec, key = (torch.stack([p[i] for p in pops]) for i in range(4))
    ticks = torch.tensor([0, 2**31 - 1, -1][:rooms], dtype=torch.int32)

    def op(a, i, v, k):
        return torch.ops.nf.wander(a, i, v, k, *COLS.values(), *SCALARS.values(), 8)

    def plain(a, i, v, k):
        return sc.wander_plain(a, i, v, k, **COLS, **SCALARS, offset=8)

    sc.reset_launch_counts()
    with no_vmap_fallback():
        got = torch.func.vmap(op)(alive, i32, vec, key)
        shared = torch.func.vmap(op, in_dims=(0, 0, 0, None))(alive, i32, vec, key[0])
        k1 = torch.func.vmap(lambda k, t: torch.ops.nf.fold_in(k, t, 0))(key, ticks)
        k2 = torch.func.vmap(lambda k: torch.ops.nf.fold_in(k, None, 3))(key)
        k3 = torch.func.vmap(lambda t: torch.ops.nf.fold_in(key[0], t, 0))(ticks)
        want = torch.func.vmap(plain)(alive, i32, vec, key)
        want_shared = torch.func.vmap(plain, in_dims=(0, 0, 0, None))(alive, i32, vec, key[0])
    assert sc.KERNELS["wander"].launches == 2 and sc.KERNELS["fold_in"].launches == 3
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(shared.view(torch.int32), want_shared.view(torch.int32))
    for r in range(rooms):
        assert torch.equal(k1[r], prng.fold_in(key[r], ticks[r]))
        assert torch.equal(k2[r], prng.fold_in(key[r], 3))
        assert torch.equal(k3[r], prng.fold_in(key[0], ticks[r]))
