"""One world of ``entities`` NPCs under the game role's own module stack,
every NPC carrying timed buffs: ``game.world.build_benchmark_world(
entities, seed=seed, middleware=True, buffs=cfg["buffs"])``.  The
world's recipe, faults and tiny size are the ``world`` kind's."""

from __future__ import annotations

import dataclasses

import torch

from nfbench.deployments.world import WorldDeployment, answer, batch, tiny
from nfbench.program import _layout
from nfbench.reference.buffs import BUFF_RECORD, BuffLayout
from nfbench.reference.tick import STAT_RECORD

__all__ = ["MiddlewareWorld", "deploy", "tiny", "batch", "answer"]


class MiddlewareWorld(WorldDeployment):
    """The game role's world (``WorldConfig.middleware``) with the
    configuration's buff recipe seeded on every NPC."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from noahgameframe_tpu_torch.game.world import build_benchmark_world

        self.device = device
        self.world = build_benchmark_world(int(cfg["entities"]), seed=seed, device=device,
                                           middleware=True, buffs=cfg["buffs"])
        self.kernel = self.world.kernel
        self.entities = int(cfg["entities"])

    def layout(self) -> BuffLayout:
        """The world's layout plus each buff list's ConfigIdx and
        ExpireTick columns."""
        store = self.kernel.store
        cols = {}
        for cname in store.class_order:
            records = store.spec(cname).records
            if (cname in self.world.buffs.classes and BUFF_RECORD in records
                    and STAT_RECORD in records):
                rec = records[BUFF_RECORD]
                cols[cname] = (rec.cols["ConfigIdx"].col, rec.cols["ExpireTick"].col)
        lay = _layout(self.kernel)
        return BuffLayout(**{f.name: getattr(lay, f.name) for f in dataclasses.fields(lay)},
                          buff_cols=cols)


def deploy(cfg: dict, seed: int, device: torch.device) -> MiddlewareWorld:
    return MiddlewareWorld(cfg, seed, device)
