"""Model-based randomized test of the port's SoA entity store
(noahgameframe_tpu_torch.core.store) after tests/test_store_model.py: a
few hundred random operations (create/destroy with recycling, typed
property set/get, record add/set/remove/swap) against a plain Python
dict model, with full agreement after every op batch.  The store runs
on the CPU over the port's copy of the fixtures' registry."""

import random

import numpy as np
import pytest

from noahgameframe_tpu_torch.core import StoreConfig
from noahgameframe_tpu_torch.core.store import EntityStore

from fixtures import base_registry
from test_torch_scene import port_registry
from test_torch_parity import one_intra_op_thread  # noqa: F401

PROPS = {
    "Level": ("int", lambda r: r.randint(-5, 99)),
    "EXP": ("int", lambda r: r.randint(0, 10_000)),
    "Name": ("string", lambda r: f"n{r.randint(0, 30)}"),
    "MoveSpeed": ("float", lambda r: float(np.float32(r.uniform(-5, 5)))),
    "Position": (
        "vector3",
        lambda r: tuple(float(np.float32(r.uniform(0, 64))) for _ in range(3)),
    ),
}
REC = "PlayerHero"
REC_COLS = {
    "ConfigID": lambda r: f"cfg{r.randint(0, 9)}",
    "Level": lambda r: r.randint(0, 60),
    "Exp": lambda r: r.randint(0, 999),
}


@pytest.mark.parametrize("seed", [5, 17])
def test_store_agrees_with_model(seed):
    rng = random.Random(seed)
    store = EntityStore(port_registry(base_registry()), StoreConfig(default_capacity=32),
                        device="cpu")
    state = store.init_state(0)
    live = {}  # guid -> {"props": {...}, "rec": {rec_row: {...} or None}}

    def check():
        assert store.live_count("Player") == len(live)
        for g, m in live.items():
            for pname, want in m["props"].items():
                got = store.get_property(state, g, pname)
                assert got == want, (g, pname, got, want)
            for rr, cells in m["rec"].items():
                for tag, want in cells.items():
                    got = store.record_get(state, g, REC, rr, tag)
                    assert got == want, (g, rr, tag, got, want)

    for step in range(300):
        op = rng.random()
        if op < 0.25 or not live:
            if len(live) >= 30:
                continue
            vals = {p: gen(rng) for p, (_t, gen) in PROPS.items()
                    if rng.random() < 0.7}
            state, guids, _rows = store.create_many(
                state, "Player", 1, values={p: [v] for p, v in vals.items()}
            )
            g = guids[0]
            defaults = {"Level": 0, "EXP": 0, "Name": "", "MoveSpeed": 0.0,
                        "Position": (0.0, 0.0, 0.0)}
            live[g] = {"props": {**defaults, **vals}, "rec": {}}
        elif op < 0.35:
            g = rng.choice(list(live))
            state = store.destroy_object(state, g)
            del live[g]
        elif op < 0.65:
            g = rng.choice(list(live))
            pname = rng.choice(list(PROPS))
            v = PROPS[pname][1](rng)
            state = store.set_property(state, g, pname, v)
            live[g]["props"][pname] = v
        elif op < 0.8:
            g = rng.choice(list(live))
            m = live[g]["rec"]
            if len(m) >= 8:
                continue
            cells = {t: gen(rng) for t, gen in REC_COLS.items()
                     if rng.random() < 0.8}
            state, rr = store.record_add_row(state, g, REC, cells)
            full = {"GUID": None, "ConfigID": "", "Level": 0, "Exp": 0}
            full.update(cells)
            full.pop("GUID")  # object cells compare via handles; skip
            m[rr] = full
        elif op < 0.9:
            g = rng.choice(list(live))
            m = live[g]["rec"]
            if not m:
                continue
            rr = rng.choice(list(m))
            if rng.random() < 0.5:
                state = store.record_remove_row(state, g, REC, rr)
                del m[rr]
            else:
                tag = rng.choice(list(REC_COLS))
                v = REC_COLS[tag](rng)
                state = store.record_set(state, g, REC, rr, tag, v)
                m[rr][tag] = v
        else:
            g = rng.choice(list(live))
            m = live[g]["rec"]
            a, b = rng.randrange(8), rng.randrange(8)
            state = store.record_swap_rows(state, g, REC, a, b)
            ra, rb = m.pop(a, None), m.pop(b, None)
            if rb is not None:
                m[a] = rb
            if ra is not None:
                m[b] = ra
        if step % 25 == 0:
            check()
    check()
