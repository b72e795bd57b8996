"""Movement module: batched random-walk / seek steering on the device.

Counterpart of ``noahgameframe_tpu/game/movement.py``: seek the TargetPos
at MOVE_SPEED, and when within one step pick a fresh uniform target inside
the scene extent from the per-tick threefry stream (core/prng.py, so the
targets equal the JAX package's).  MOVE_SPEED follows the reference's
convention of 10000 = 1 world unit/s; MOVE_GATE (stun/root) zeroes
movement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.prng import uniform
from ..core.rounding import fma32, recip32, sqrt32
from ..core.store import WorldState, with_class
from ..kernel.module import Module

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
        pos_col = spec.slot("Position").col
        tgt_col = spec.slot("TargetPos").col
        pos = cs.vec[:, pos_col, :2]  # [C, 2]
        tgt = cs.vec[:, tgt_col, :2]

        # MOVE_SPEED / SPEED_UNIT, as the reference computes it
        speed = cs.i32[:, spec.slot("MOVE_SPEED").col].to(torch.float32) * recip32(SPEED_UNIT)
        if self.respect_gates and spec.has_property("MOVE_GATE"):
            speed = torch.where(cs.i32[:, spec.slot("MOVE_GATE").col] > 0, 0.0, speed)
        if spec.has_property("HP"):
            speed = torch.where(cs.i32[:, spec.slot("HP").col] > 0, speed, 0.0)
        step = speed * float(np.float32(ctx.dt))  # [C]

        delta = tgt - pos
        # the reference sums the two squares as fma(d1, d1, d0*d0)
        sq = fma32(delta[:, 1], delta[:, 1], delta[:, 0] * delta[:, 0])
        dist = sqrt32(sq + float(np.float32(1e-12)))
        arrived = dist <= torch.clamp(step, min=float(np.float32(1e-6)))
        # fresh uniform target for arrived walkers (dead/rooted ones have
        # step 0 and never "arrive" once a target is outstanding)
        # a shard draws its own rows' slice of the whole draw
        new_tgt = uniform(ctx.rng(), (pos.shape[0], 2), 0.0, self.extent,
                          offset=ctx.row_offset(cname) * 2)
        tgt = torch.where((arrived & cs.alive)[:, None], new_tgt, tgt)
        # pos + where(arrived, delta, delta/dist*step): the reference fuses
        # the walking arm into fma(delta/dist, step, pos)
        walk = fma32(delta / dist[:, None], step[:, None].expand_as(delta), pos)
        moved = torch.where(arrived[:, None], pos + delta, walk)
        new_pos = torch.where(cs.alive[:, None], moved, pos)
        new_pos = torch.clamp(new_pos, 0.0, float(np.float32(self.extent)))

        vec = cs.vec.clone()
        vec[:, pos_col, :2] = new_pos
        vec[:, tgt_col, :2] = tgt
        return with_class(state, cname, cs.replace(vec=vec))
