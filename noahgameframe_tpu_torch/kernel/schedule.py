"""Schedule module: vectorised heartbeats.

Counterpart of ``noahgameframe_tpu/kernel/schedule.py``.  Every class has a
fixed set of *timer slots* (registered before the world is built);
per-entity timer state is four [C, T] tensors in ClassState.timers, and
firing is one fused compare on the device:

    fired = active & alive & (tick >= next_fire)

Handlers are device phases that read ``ctx.fired(class_name, timer_name)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.datatypes import Guid
from ..core.store import ClassState, TimerState, WorldState, with_class
from .module import Module


class ScheduleModule(Module):
    name = "ScheduleModule"

    def __init__(self, dt: float = 1.0 / 30.0) -> None:
        super().__init__()
        self.dt = float(dt)
        # (class_name -> timer_name -> slot index); frozen at build time
        self._slots: Dict[str, Dict[str, int]] = {}
        self._frozen = False

    # -- registration (before kernel.build) ---------------------------------

    def register_timer(self, class_name: str, timer_name: str) -> int:
        """Declare a timer slot on a class.  Must happen before the world is
        built — slot count fixes the [C, T] timer array shapes."""
        if self._frozen:
            raise RuntimeError("timer registration is closed once the world is built")
        slots = self._slots.setdefault(class_name, {})
        if timer_name not in slots:
            slots[timer_name] = len(slots)
        return slots[timer_name]

    def freeze(self) -> Dict[str, int]:
        """Close registration; returns class -> slot count for StoreConfig."""
        self._frozen = True
        return {c: len(s) for c, s in self._slots.items()}

    def slot(self, class_name: str, timer_name: str) -> int:
        return self._slots[class_name][timer_name]

    def timer_names(self, class_name: str) -> List[str]:
        return list(self._slots.get(class_name, ()))

    def ticks_of(self, seconds: float) -> int:
        return max(1, int(round(float(seconds) / self.dt)))

    # -- per-entity timer control (host, functional) ---------------------------

    def set_timer(self, state: WorldState, store, guid: Guid, timer_name: str,
                  interval_s: float, count: int = -1,
                  start_delay_s: Optional[float] = None) -> WorldState:
        """Arm a timer on one entity: fire every ``interval_s``, ``count``
        times (-1 = forever), first firing after ``start_delay_s``
        (default one interval): AddHeartBeat semantics."""
        class_name, row = store.row_of(guid)
        return self.set_timer_rows(state, class_name, np.asarray([row]), timer_name,
                                   interval_s, count, start_delay_s)

    def set_timer_rows(
        self,
        state: WorldState,
        class_name: str,
        rows: np.ndarray,
        timer_name: str,
        interval_s: float,
        count: int = -1,
        start_delay_s: Optional[float] = None,
        start_delay_ticks: Optional[np.ndarray] = None,
    ) -> WorldState:
        """Batch-arm one timer slot: fire every ``interval_s``, ``count``
        times (-1 = forever).  ``start_delay_ticks`` (per row) staggers the
        first firings, ``start_delay_s`` delays them all; by default the
        first firing is one interval out."""
        slot = self.slot(class_name, timer_name)
        interval = self.ticks_of(interval_s)
        cs = state.classes[class_name]
        dev = cs.alive.device
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
        if start_delay_ticks is not None:
            delay = torch.from_numpy(
                np.maximum(np.asarray(start_delay_ticks, np.int32), 1)
            ).to(dev)
        elif start_delay_s is not None:
            delay = self.ticks_of(start_delay_s)
        else:
            delay = interval
        t = cs.timers

        def put(bank, value):
            out = bank.clone()
            out[idx, slot] = value
            return out

        t = TimerState(
            next_fire=put(t.next_fire, (state.tick + delay).to(torch.int32)),
            interval=put(t.interval, interval),
            remain=put(t.remain, count),
            active=put(t.active, True),
        )
        return with_class(state, class_name, cs.replace(timers=t))

    def cancel_timer(self, state: WorldState, store, guid: Guid,
                     timer_name: str) -> WorldState:
        class_name, row = store.row_of(guid)
        slot = self.slot(class_name, timer_name)
        cs = state.classes[class_name]
        active = cs.timers.active.clone()
        active[row, slot] = False
        return with_class(state, class_name,
                          cs.replace(timers=cs.timers.replace(active=active)))

    # -- device step (run by the kernel before the phases) -------------------

    def advance_class(
        self, cs: ClassState, tick: torch.Tensor
    ) -> Tuple[ClassState, torch.Tensor]:
        """One schedule step for one class: returns (new_cs, fired[C, T]).

        Fired timers advance next_fire by interval; finite timers count
        down and deactivate at zero.  Dead rows never fire."""
        t = cs.timers
        if t.active.shape[1] == 0:
            return cs, t.active
        due = t.active & (tick >= t.next_fire) & cs.alive[:, None]
        next_fire = torch.where(due, t.next_fire + t.interval, t.next_fire)
        remain = torch.where(due & (t.remain > 0), t.remain - 1, t.remain)
        active = t.active & ~(due & (remain == 0))
        return (
            cs.replace(
                timers=TimerState(
                    next_fire=next_fire, interval=t.interval, remain=remain, active=active
                )
            ),
            due,
        )
