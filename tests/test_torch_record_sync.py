"""The port's device record-diff lanes (Kernel.register_record_diff) and
forced diff columns (Kernel.force_diff_property) against the JAX package
on the CPU: the device cases of tests/test_record_sync.py, the per-tick
int8 codes equal JAX's, ``train(K=4)`` stacks the same codes and counts
as four ticks, and a forced column reaches property subscribers from the
tick path.  Tolerance 0."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noahgameframe_tpu.core.store import StoreConfig as JStoreConfig
from noahgameframe_tpu.core.store import with_class as jwith_class
from noahgameframe_tpu.kernel.kernel import Kernel as JKernel
from noahgameframe_tpu.kernel.module import Module as JModule
from noahgameframe_tpu_torch.core.store import StoreConfig, state_to_numpy, with_class
from noahgameframe_tpu_torch.kernel.kernel import (
    REC_ADDED,
    REC_REMOVED,
    REC_UPDATED,
    Kernel,
)
from noahgameframe_tpu_torch.kernel.module import Module

from fixtures import base_registry
from test_torch_parity import assert_tree_equal, jax_tree
from test_torch_scene import port_registry
from test_torch_parity import one_intra_op_thread  # noqa: F401


class _JaxMutator(JModule):
    """tests/test_record_sync.py's device phase: bumps Count in row 0 and
    clears row 1's used flag for every alive player."""

    name = "RecMutator"

    def __init__(self):
        super().__init__()
        self.add_phase("mutate", self._phase, order=50)

    def _phase(self, state, ctx):
        rs = ctx.store.spec("Player").records["BagItems"]
        cs = state.classes["Player"]
        rec = cs.records["BagItems"]
        alive = cs.alive
        i32 = rec.i32.at[:, 0, rs.cols["Count"].col].add(jnp.where(alive & rec.used[:, 0], 1, 0))
        used = rec.used.at[:, 1].set(rec.used[:, 1] & ~alive)
        rec = rec.replace(i32=i32, used=used)
        return jwith_class(state, "Player", cs.replace(records={**cs.records, "BagItems": rec}))


class _PortMutator(Module):
    """The same phase on the port's tensors."""

    name = "RecMutator"

    def __init__(self):
        super().__init__()
        self.add_phase("mutate", self._phase, order=50)

    def _phase(self, state, ctx):
        rs = ctx.store.spec("Player").records["BagItems"]
        cs = state.classes["Player"]
        rec = cs.records["BagItems"]
        alive = cs.alive
        i32 = rec.i32.clone()
        col = rs.cols["Count"].col
        i32[:, 0, col] = i32[:, 0, col] + (alive & rec.used[:, 0]).to(torch.int32)
        used = rec.used.clone()
        used[:, 1] = rec.used[:, 1] & ~alive
        rec = rec.replace(i32=i32, used=used)
        return with_class(state, "Player", cs.replace(records={**cs.records, "BagItems": rec}))


def _kernels():
    kw = dict(class_names=["IObject", "Player", "NPC"], diff_flags=("public", "private", "upload"))
    a = JKernel(base_registry(), JStoreConfig(default_capacity=16), **kw)
    b = Kernel(port_registry(base_registry()), StoreConfig(default_capacity=16), device="cpu",
               **kw)
    a.build([a, _JaxMutator()])
    b.build([b, _PortMutator()])
    for k in (a, b):
        k.store.guids.pin(300)
    return a, b


def _both(fn):
    """``fn(kernel, log)`` on both kernels; returns both logs."""
    logs = [], []
    for k, log in zip(_kernels(), logs):
        fn(k, log)
        log.append(k)
    return logs


def _codes(seen):
    return [np.asarray(c).tolist() for c in seen]


def test_device_record_diff_codes():
    def run(k, log):
        g = k.create_object("Player", {"Name": "p"})
        _, row = k.store.row_of(g)
        for item, n in (("potion", 1), ("scroll", 9)):
            k.state, _ = k.store.record_add_row(k.state, g, "BagItems",
                                                {"ItemConfig": item, "Count": n})
        seen = []
        k.register_record_diff("Player", "BagItems",
                               lambda c, r, codes: seen.append(codes.copy()))
        out = k.tick()
        log += [_codes(seen), row, k.store.record_get(k.state, g, "BagItems", 0, "Count"),
                k.last_counters, {c: int(n) for c, n in out.rec_diff_count.items()}]
        assert seen[0][row, 0] == REC_UPDATED and seen[0][row, 1] == REC_REMOVED

    la, lb = _both(run)
    assert lb[:-1] == la[:-1]
    assert la[2] == 2 and lb[3]["rec_diff_cells"] == 2
    assert_tree_equal(jax_tree(la[-1].state), state_to_numpy(lb[-1].state))


def test_unsubscribed_records_emit_no_diff():
    def run(k, log):
        k.create_object("Player", {"Name": "p"})
        out = k.tick()
        log += [out.rec_diff, out.rec_diff_count, k.last_counters]

    la, lb = _both(run)
    assert lb[:-1] == la[:-1] and lb[0] == {} and lb[1] == {}


def test_host_add_not_double_reported_by_device_diff():
    def run(k, log):
        g = k.create_object("Player", {"Name": "p"})
        seen = []
        k.register_record_diff("Player", "BagItems",
                               lambda c, r, codes: seen.append(codes.copy()))
        k.state, _ = k.store.record_add_row(k.state, g, "BagItems",
                                            {"ItemConfig": "potion", "Count": 1})
        k.tick()
        log += [_codes(seen)]
        assert seen and not (seen[0] == REC_ADDED).any()

    la, lb = _both(run)
    assert lb[:-1] == la[:-1]


def test_register_record_diff_invalidates_once_and_rejects_unknown():
    def run(k, log):
        gen = k.costbook.generation
        k.register_record_diff("Player", "BagItems", lambda *a: None)
        k.register_record_diff("Player", "BagItems", lambda *a: None)
        with pytest.raises(KeyError):
            k.register_record_diff("Player", "NoSuchRecord", lambda *a: None)
        log.append(k.costbook.generation - gen)

    la, lb = _both(run)
    assert lb[0] == la[0] == 1


def _player_world(k, n=3):
    guids = []
    for i in range(n):
        g = k.create_object("Player", {"Name": f"p{i}"})
        for item in ("potion", "scroll", "bow")[: i + 1]:
            k.state, _ = k.store.record_add_row(k.state, g, "BagItems",
                                                {"ItemConfig": item, "Count": i})
        guids.append(g)
    return guids


def test_train_stacks_the_codes_of_four_ticks():
    """train(K=4) delivers, lane by lane, the codes, counts and counters
    that single ticks deliver (two trains and a tick after a destroy), in
    both packages; the stacked lanes are [4, C, R] int8."""
    def run(k, log, train):
        guids = _player_world(k)
        seen = []
        k.register_record_diff("Player", "BagItems",
                               lambda c, r, codes: seen.append(codes.copy()))
        k.enable_digest()
        if train:
            k.configure_train(4)
            outs = k.train(8)
        else:
            outs = [k.tick() for _ in range(8)]
        k.destroy_object(guids[0])
        outs += [k.tick()]
        log += [_codes(seen), [o.counters for o in outs],
                [{c: int(n) for c, n in o.rec_diff_count.items()} for o in outs],
                [np.asarray(o.rec_diff["Player"]["BagItems"]).tolist() for o in outs]]

    ticks_a, ticks_b, train_a, train_b = [], [], [], []
    run(_kernels()[0], ticks_a, False)
    run(_kernels()[1], ticks_b, False)
    run(_kernels()[0], train_a, True)
    b2 = _kernels()[1]
    run(b2, train_b, True)
    assert ticks_b == ticks_a
    assert train_b == ticks_b and train_a == ticks_a
    lanes = b2.train_begin()
    assert lanes["rec_diff"]["Player"]["BagItems"].shape == (4, 16, 16)
    assert lanes["rec_diff"]["Player"]["BagItems"].dtype == torch.int8
    assert sum(c["rec_diff_cells"] for c in ticks_b[1]) > 0


def test_forced_diff_column_reaches_subscribers():
    """A column outside diff_flags (NPC HPREGEN is unflagged) that a phase
    writes reaches a property subscriber from the tick path only once
    forced; forcing invalidates once, and the diff counts equal JAX's."""
    def run(k, log):
        g = k.create_object("NPC", {"HP": 5})
        seen = []
        k.register_property_event("NPC", "HPREGEN",
                                  lambda c, p, rows: seen.append(rows.tolist()))
        col = k.store.spec("NPC").slot("HPREGEN").col
        k.set_phases(list(k._composed) + [type(k._composed[0])(
            "bump", _bump_phase("NPC", col), 55)])
        out = k.tick()
        log += [{c: int(n) for c, n in out.diff_count.items()}, list(seen)]
        gen = k.costbook.generation
        k.force_diff_property("NPC", "HPREGEN")
        k.force_diff_property("NPC", "HPREGEN")
        log.append(k.costbook.generation - gen)
        for _ in range(2):
            out = k.tick()
            log.append({c: int(n) for c, n in out.diff_count.items()})
        log += [seen, str(g), k.last_counters]

    la, lb = _both(run)
    assert lb[:-1] == la[:-1]
    assert lb[1] == [] and lb[2] == 1 and lb[5] == [[0], [0]]


def _bump_phase(cname, col):
    """A device phase adding 1 to one i32 column of every row."""
    def phase(state, ctx):
        cs = state.classes[cname]
        if isinstance(cs.i32, torch.Tensor):
            i32 = cs.i32.clone()
            i32[:, col] += 1
            return with_class(state, cname, cs.replace(i32=i32))
        return jwith_class(state, cname, cs.replace(i32=cs.i32.at[:, col].add(1)))
    return phase
