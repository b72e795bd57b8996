"""The port's per-entry cost count (telemetry/costbook.py: ``CostCounter``,
``count_cost`` and the ``last`` record of every cost-book entry) against
hand counts, under the module's rules: one flop per output element of an
elementwise op, one per input element of a reduction,
``torch.utils.flop_counter``'s ``2 m n k`` for a matmul; operand plus
output bytes per op; the peak of live intermediates less the outputs for
``temp_bytes`` on the CPU.  The custom op ``nf::combat_fold`` is counted
by its operands and outputs (on meta tensors here, where the op has no
CPU kernel), which equal its plain version's at a 4 x 4-cell geometry.
A ticked world's ``kernel.step`` carries the three costs with no op left
uncounted, ``roofline_fold`` yields its ``tick`` stage, and the three
``nf_entry_*`` gauges are sampled.  Tolerance 0: the counts are exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from noahgameframe_tpu_torch.game.world import build_benchmark_world
from noahgameframe_tpu_torch.ops import stencil as st
from noahgameframe_tpu_torch.ops import stencil_cuda as sck
from noahgameframe_tpu_torch.telemetry import roofline_fold
from noahgameframe_tpu_torch.telemetry.costbook import CostBook, CostCounter, count_cost
from test_torch_parity import one_intra_op_thread  # noqa: F401

N = 1000
F32 = 4


def _entry(fn, state):
    """``fn`` as a cost-book entry, dispatched once on the CPU: the first
    eager run is the counted one."""
    book = CostBook()
    dispatch = book.wrap("probe", fn)
    _state, out = dispatch(state)
    return book.entries["probe"].last, out


def test_three_op_elementwise_entry():
    def fn(s):
        a, b = s
        c = a * b
        d = c + a
        e = d - b
        return s, e

    g = torch.Generator().manual_seed(0)
    state = (torch.rand(N, generator=g), torch.rand(N, generator=g))
    last, out = _entry(fn, state)
    assert torch.equal(out, state[0] * state[1] + state[0] - state[1])
    assert last["flops"] == 3 * N
    assert last["bytes_accessed"] == 3 * (3 * N * F32)  # two operands, one output, 3 ops
    assert last["temp_bytes"] == 2 * N * F32  # c and d live beside the output e
    assert last["cost_ops"] == 3 and last["uncounted_ops"] == {}


def test_reductions():
    def fn(x):
        return x, (x.sum(), x.amax(dim=1))

    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    last, (s, m) = _entry(fn, x)
    assert float(s) == float(x.sum()) and m.shape == (64,)
    assert last["flops"] == 2 * 64 * 32  # one per input element, each reduction
    assert last["bytes_accessed"] == (2048 * F32 + F32) + (2048 * F32 + 64 * F32)
    assert last["temp_bytes"] == 0  # both results are outputs


def test_small_matmul():
    def fn(s):
        a, b = s
        return s, a @ b

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    last, out = _entry(fn, (a, b))
    assert out.shape == (8, 4)
    assert last["flops"] == 2 * 8 * 16 * 4
    assert last["bytes_accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * F32
    assert last["temp_bytes"] == 0


def test_an_op_without_a_rule_is_moved_data_and_named():
    x = torch.rand(256)
    _out, cost = count_cost(lambda s: (s, torch.histc(s, bins=8)), x)
    assert cost["uncounted_ops"] == {"aten::histc": 1}
    assert cost["flops"] == 0 and cost["bytes_accessed"] == 256 * F32 + 8 * F32


def _tables(width: int, kv: int, ka: int, seed: int = 0):
    """Split victim and attacker tables of ``width`` x ``width`` cells:
    random positions in cells of 4.0, camps, one scene and group, the
    attackers' effective ATK and rows (a slot half the time empty)."""
    rng = np.random.RandomState(seed)
    cells = width * width

    def table(k, feats):
        p = np.zeros((cells * k + 1, feats + 1), np.float32)
        live = rng.rand(cells * k) < 0.5
        p[:-1, 0:2] = rng.uniform(0, 4.0 * width, (cells * k, 2))
        p[:-1, -1] = live
        return p, live

    v, vl = table(kv, 5)
    v[:-1, 2] = rng.randint(0, 2, cells * kv)
    v[:-1, 3:5] = 1.0
    a, al = table(ka, 7)
    a[:-1, 2] = rng.randint(1, 30, cells * ka) * al
    a[:-1, 3] = rng.randint(0, 2, cells * ka)
    a[:-1, 4:6] = 1.0
    a[:-1, 6] = np.arange(cells * ka)
    z = torch.zeros((), dtype=torch.int32)

    def ct(p, k):
        return st.CellTable(torch.from_numpy(p), z, z, width, 4.0, k)

    return ct(v, kv), ct(a, ka)


def test_combat_fold_op_bytes_equal_its_plain_versions_operands_and_outputs():
    width, kv, ka, radius = 4, 8, 6, 4.0
    vic, att = _tables(width, kv, ka)
    inc, bestr = sck.combat_fold_plain(vic, att, radius)
    assert inc.shape == bestr.shape == (width, width, kv)
    hand = (vic.payload.nbytes + att.payload.nbytes) + (inc.nbytes + bestr.nbytes)
    vmeta, ameta = vic.payload.to("meta"), att.payload.to("meta")
    with CostCounter() as c:
        out = torch.ops.nf.combat_fold(vmeta, ameta, width, kv, ka, radius * radius,
                                       4, 8, 128, 0, 0)
    assert [o.shape for o in out] == [inc.shape, bestr.shape]
    # [16 cells x 8 + dump, 5 + 1] and [16 x 6 + 1, 7 + 1] float32 in, two
    # [4, 4, 8] int32 out
    assert c.bytes_accessed == hand == ((16 * 8 + 1) * 6 + (16 * 6 + 1) * 8) * F32 + 2 * 128 * 4
    # the fold's flops have no rule: the op is named, not dropped
    assert c.uncounted == {"nf::combat_fold": 1} and c.flops == 0


def test_kernel_step_costs_fold_and_gauges():
    w = build_benchmark_world(512, seed=3, device="cpu")
    k = w.kernel
    k.tick()
    last = k.costbook.entries["kernel.step"].last
    assert last["flops"] > 0 and last["bytes_accessed"] > last["flops"]
    assert last["temp_bytes"] > 0 and last["uncounted_ops"] == {}
    # every signature miss is counted again (a re-capture on a card)
    k.invalidate()
    k.tick()
    again = k.costbook.entries["kernel.step"].last
    assert again["cause"] != "first" and again["seq"] > last["seq"]
    assert again["flops"] > 0 and again["uncounted_ops"] == {}
    fold = roofline_fold(k.costbook, {"frames": 2, "stages": {"tick": {"mean_ms": 1.5}}},
                         platform="gpu")
    tick = fold["stages"]["tick"]
    calls = k.costbook.entries["kernel.step"].calls
    assert tick["entries"] == ["kernel.step"]
    assert tick["bytes_per_frame"] == pytest.approx(again["bytes_accessed"] * calls / 2)
    assert tick["frac_of_peak_bytes"] == pytest.approx(
        again["bytes_accessed"] * calls / 2 / 1.5e-3 / 3.35e12)
    text = w.telemetry.exposition()
    for name in ("nf_entry_flops", "nf_entry_bytes_accessed", "nf_entry_temp_bytes"):
        assert f'{name}{{entry="kernel.step"}}' in text


@pytest.mark.cuda
def test_graph_capture_counts_its_first_warmup():
    """On the card the counted run is the capture's first warm-up: the
    graph entry's record carries the three costs, the temp bytes come
    from the allocator's peak, and the fold is seen as ``nf::combat_fold``,
    the wander phase as ``nf::wander`` and the tick key and ``ctx.rng()``
    as ``nf::fold_in`` (bytes counted, flops named)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph capture has no CPU mode")
    w = build_benchmark_world(4096, seed=3, device="cuda")
    w.kernel.set_graph_tick(True)
    launches = sck.KERNELS["combat_fold"].launches
    w.kernel.tick()
    last = w.kernel.costbook.entries["kernel.step"].last
    assert last["graph"] and last["flops"] > 0 and last["temp_bytes"] > 0
    assert last["uncounted_ops"] == {"nf::combat_fold": 1, "nf::fold_in": 2, "nf::wander": 1}
    # the counted warm-up is one of the capture's warm-ups: no extra launch
    assert sck.KERNELS["combat_fold"].launches - launches == 2 + 1
