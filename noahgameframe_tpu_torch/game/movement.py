"""Movement module: batched random-walk / seek steering on the device.

Counterpart of ``noahgameframe_tpu/game/movement.py``: seek the TargetPos
at MOVE_SPEED, and when within one step pick a fresh uniform target inside
the scene extent from the per-tick threefry stream (core/prng.py, so the
targets equal the JAX package's).  MOVE_SPEED follows the reference's
convention of 10000 = 1 world unit/s; MOVE_GATE (stun/root) zeroes
movement.  The phase is ``ops/stencil_cuda.py``'s :func:`wander`: one
hand kernel on a card, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..core.rounding import recip32
from ..core.store import WorldState, with_class
from ..kernel.module import Module
from ..ops.stencil_cuda import wander

SPEED_UNIT = 10000.0  # reference convention: MOVE_SPEED 10000 == 1 world unit/s


class MovementModule(Module):
    name = "MovementModule"

    def __init__(self, class_name: str = "NPC", extent: float = 512.0,
                 order: int = 20, respect_gates: bool = True):
        super().__init__()
        self.class_name = class_name
        self.extent = float(extent)
        self.respect_gates = respect_gates
        self.add_phase("wander", self._move_phase, order=order)

    def _move_phase(self, state: WorldState, ctx) -> WorldState:
        cname = self.class_name
        store = ctx.store
        if cname not in store.class_index:
            return state
        spec = store.spec(cname)
        if not (spec.has_property("Position") and spec.has_property("TargetPos")):
            return state
        cs = state.classes[cname]
        gated = self.respect_gates and spec.has_property("MOVE_GATE")
        # MOVE_SPEED / SPEED_UNIT, as the reference computes it; a shard
        # draws its own rows' slice of the tick's draw
        vec = wander(cs.alive, cs.i32, cs.vec, ctx.rng(),
                     pos_col=spec.slot("Position").col, tgt_col=spec.slot("TargetPos").col,
                     speed_col=spec.slot("MOVE_SPEED").col,
                     gate_col=spec.slot("MOVE_GATE").col if gated else -1,
                     hp_col=spec.slot("HP").col if spec.has_property("HP") else -1,
                     speed_scale=recip32(SPEED_UNIT), dt=float(np.float32(ctx.dt)),
                     extent=self.extent, offset=ctx.row_offset(cname) * 2)
        return with_class(state, cname, cs.replace(vec=vec))
