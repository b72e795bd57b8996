"""The system under test, as the benchmark drives it.

Everything the benchmark takes from ``noahgameframe_tpu_torch`` goes
through this module and the modules it finds by name.  The program is
imported inside the builders, after the harness has found a card.

A configuration's ``kind`` names ``nfbench/deployments/<kind>.py``.  It
exposes ``deploy(cfg, seed, device)``, which builds the deployment, and
``tiny(found)``, which cuts a found cell to a size the CPU runs in the
harness's tests.  Anything more that ``deploy`` takes later (a span
tracer, say) comes as an optional keyword, so that a kind without it is
built as before.  A deployment has:

- ``entities``: the work of one frame, as the rate counts it;
- ``leaves()``: ``(path, tensor)`` of every state leaf the check judges;
- ``layout()``: what the check's reference reads those leaves by;
- ``after_window()``: the work a deployment does once after the window;
- ``launches_per_replay(book)``: device launches of one replay of the
  cost book's entry ``book`` (None without a captured graph);
- ``close()``: drops the program's state.

The kind's module also names what the harness's fault tests break:
``batch(dep)``, the paths of the leaves that hold the batch (one row a
leading index), and ``answer(dep)``, a leaf path and an index of one cell
that the step produces and the check judges.

The same ``kind`` names the check, ``nfbench/checks/<kind>.py``, which
imports the plain reference and nothing of the program: ``LIMITS`` (each
number compared and its limit), ``CONTROL`` (the control's precision),
``reference_inputs(cfg, seed, device)``, ``run_check(cfg, lay, inputs,
start, early, late, stats=, max_ticks=)``, ``passed(numbers)``,
``describe(stats)`` and ``readings(stats)`` (the run's log line and what
the metric readers take from the check), and ``control(found, seed, lay,
inputs, start, target, **kw)``, the reference in ``CONTROL`` precision in
the program's place up to ``target``, the tick of the early checked frame
(``python -m nfbench.control``).

A traffic mix's ``entry`` names ``nfbench/entries/<entry>.py``, with each
``.`` written ``_``.  It exposes ``KINDS``, the deployment kinds it
drives; ``BOOK``, the cost-book entry that one frame replays;
``prepare(dep)``, run once before the warm-up; and ``frame(dep)``, one
frame, ended by a device sync.

The shared helpers below copy a world's state for the check.  The
reference steps a batch of rooms; one world is a batch of one, so the
state copies gain a leading axis of one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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

