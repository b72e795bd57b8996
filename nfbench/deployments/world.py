"""One world of ``entities`` NPCs, built by the program's recipe:
``game.world.build_benchmark_world(entities, seed=seed)``."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from nfbench.program import _layout, _leaves
from nfbench.reference.tick import Layout


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

    def after_window(self) -> None:
        """Deaths found on the device are reconciled once, after the window."""
        self.kernel.run_device(0, reconcile=True)

    def launches_per_replay(self, book: str) -> Optional[int]:
        """Device launches of one replay of the cost book's entry ``book``."""
        return self.kernel.costbook.launches_per_replay(book)

    def close(self) -> None:
        self.world = self.kernel = None


def deploy(cfg: dict, seed: int, device: torch.device) -> WorldDeployment:
    return WorldDeployment(cfg, seed, device)


def batch(dep: WorldDeployment) -> List[str]:
    """The leaves that hold the batch a step works on, one row a leading
    index: the NPC rows (the harness's fault "half of the batch left
    out" keeps their second half)."""
    return [p for p, _ in dep.leaves() if p.startswith("classes.NPC.")]


def answer(dep: WorldDeployment) -> Tuple[str, Tuple[int, ...]]:
    """One cell that the step produces and the check judges, as a leaf
    path and an index: the first NPC row's HP (the fault "an answer
    altered where it is produced")."""
    return "classes.NPC.i32", (0, dep.layout().i32["NPC"]["HP"])


def tiny(found: dict, late=(12, 14)) -> dict:
    """The cell cut to a size the CPU steps in seconds: a 4,096-NPC world
    at the program's own geometry for that size, and check frames early
    in the window."""
    cfg = found["config"]
    n = 4096
    cfg["entities"] = n
    cfg["recipe"]["seeded"] = n
    ext = max(64.0, float(math.sqrt(n / 0.4)))
    cfg["geometry"].update(extent=ext, width=int(ext / 4.0), kv=16, ka=6)
    cfg["rows"] = {"NPC": n, "Player": 64}
    cfg["occupied_rows"] = {"NPC": n, "Player": 0}
    found["traffic"].update(early_frames=4, late_frames=list(late), trace_from=5,
                            trace_frames=3)
    return found
