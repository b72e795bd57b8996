"""The system under test, as the benchmark drives it.

Everything the benchmark takes from ``noahgameframe_tpu_torch`` goes
through this module: the deployment a configuration describes, the entry
a traffic mix names, copies of the state that the correctness check
judges, the column layout that the reference reads those copies by, and
the cost book's launch count.  The program is imported inside the
builders, after the harness has found a card.

A configuration's ``kind`` picks its builder; ``world`` is one world of
``entities`` NPCs, ``game.world.build_benchmark_world(entities,
seed=seed)``.  A traffic mix's ``entry`` picks what one frame calls;
``kernel.run_device`` is one replay of the captured tick
(``reconcile=False``), ended by a device sync.

The reference steps a batch of rooms; one world is a batch of one, so
the state copies gain a leading axis of one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .reference.tick import STAT_RECORD, Layout

_AUX = ".aux"


def _leaves(state) -> List[Tuple[str, torch.Tensor]]:
    from noahgameframe_tpu_torch.core.tree import flatten

    leaves, _spec, paths = flatten(state)
    return [(p.lstrip("."), x) for p, x in zip(paths, leaves)
            if not p.startswith(_AUX) and isinstance(x, torch.Tensor)]


def _layout(kernel) -> Layout:
    store = kernel.store
    i32, vec, stat_cols = {}, {}, {}
    for cname in store.class_order:
        spec = store.spec(cname)
        i32[cname] = {n: s.col for n, s in spec.slots.items() if s.bank.value == "i32"}
        vec[cname] = {n: s.col for n, s in spec.slots.items() if s.bank.value == "vec"}
        rec = spec.records.get(STAT_RECORD)
        if rec is not None and all(n in i32[cname] for n in rec.cols):
            stat_cols[cname] = {n: c.col for n, c in rec.cols.items()}
    timers = {c: dict(t) for c, t in kernel.schedule._slots.items()}
    return Layout(i32=i32, vec=vec, timers=timers, stat_cols=stat_cols,
                  class_index=dict(store.class_index))


class Snapshot:
    """Copies of every leaf of the state but its caches, in buffers
    allocated once; ``take`` copies without allocating."""

    def __init__(self, leaves: List[Tuple[str, torch.Tensor]]):
        self.bufs = {p: torch.empty_like(x) for p, x in leaves}

    def take(self, leaves: List[Tuple[str, torch.Tensor]]) -> None:
        for p, x in leaves:
            self.bufs[p].copy_(x)

    def as_rooms(self) -> Dict[str, torch.Tensor]:
        """The copies as a batch of one room, as the reference reads them."""
        return {p: x.unsqueeze(0) for p, x in self.bufs.items()}


class WorldDeployment:
    """One world of ``entities`` NPCs, built by the program's recipe."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from noahgameframe_tpu_torch.game.world import build_benchmark_world

        self.device = device
        self.world = build_benchmark_world(int(cfg["entities"]), seed=seed, device=device)
        self.kernel = self.world.kernel
        self.entities = int(cfg["entities"])

    def leaves(self):
        return _leaves(self.kernel.state)

    def layout(self) -> Layout:
        return _layout(self.kernel)

    def frame(self, entry: str):
        if entry != "kernel.run_device":
            raise ValueError(f"a world has no entry {entry!r}")
        self.kernel.run_device(1, reconcile=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return None

    def after_window(self) -> None:
        """Deaths found on the device are reconciled once, after the window."""
        self.kernel.run_device(0, reconcile=True)

    def launches_per_replay(self) -> Optional[int]:
        """Device launches of one replay of ``run_device``'s captured tick."""
        return self.kernel.costbook.launches_per_replay("kernel.run")

    def close(self) -> None:
        self.world = self.kernel = None


KINDS = {"world": WorldDeployment}


def deploy(cfg: dict, seed: int, device: torch.device):
    kind = cfg["kind"]
    if kind not in KINDS:
        raise ValueError(f"unknown deployment kind {kind!r}")
    return KINDS[kind](cfg, seed, device)
