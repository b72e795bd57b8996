"""Task system: accept/progress/award over the TaskList record.

Reference: NFCTaskModule (`NFServer/NFGameLogicPlugin/NFCTaskModule.cpp`)
— tasks live in the TaskList record (TaskID, TaskStatus, Process); kill
counts advance matching tasks' Process, completion flips TASK_DONE, and
drawing the award pays exp/gold then flips TASK_FINISH (ETaskState,
`NFDefine.proto:432-438`).

Device integration: kill counting subscribes to the device tick's batched
ON_OBJECT_BE_KILLED event (killer handles arrive as a param column), so
a 10k-kill frame is one callback, not 10k.

A copy of ``noahgameframe_tpu/game/task.py``, which imports no jax: the
port keeps its own.  ``_on_kills`` keeps its one fetch of the ``ConfigID``
column per tick with a kill, and its host walk over the dead rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.datatypes import Guid
from ..kernel.module import Module
from .defines import GameEvent, TaskState

TASK_RECORD = "TaskList"


@dataclasses.dataclass
class TaskDef:
    """A task definition: kill `count` of `target_config` (the reference's
    TASK_KILL_SOME_MONSTER type), rewarded with exp/gold."""

    task_id: str
    target_config: str = ""  # empty = any kill counts
    count: int = 1
    award_exp: int = 0
    award_gold: int = 0


class TaskModule(Module):
    name = "TaskModule"

    def __init__(self, level_module=None) -> None:
        super().__init__()
        self.level = level_module  # game.level.LevelModule (exp awards)
        self.defs: Dict[str, TaskDef] = {}

    def define_task(self, td: TaskDef) -> TaskDef:
        self.defs[td.task_id] = td
        return td

    def after_init(self) -> None:
        # batched kill counting off the device combat event
        self.kernel.events.subscribe_batch(
            int(GameEvent.ON_OBJECT_BE_KILLED), self._on_kills
        )

    # ------------------------------------------------------- record API
    def _task_row(self, guid: Guid, task_id: str) -> Optional[int]:
        rows = self.kernel.store.record_find_rows(
            self.kernel.state, guid, TASK_RECORD, "TaskID", task_id
        )
        return rows[0] if rows else None

    def accept(self, guid: Guid, task_id: str) -> bool:
        if task_id not in self.defs or self._task_row(guid, task_id) is not None:
            return False
        k = self.kernel
        try:
            k.state, _ = k.store.record_add_row(
                k.state, guid, TASK_RECORD,
                {"TaskID": task_id,
                 "TaskStatus": int(TaskState.IN_PROCESS), "Process": 0},
            )
        except RuntimeError:
            return False
        return True

    def status(self, guid: Guid, task_id: str) -> Optional[TaskState]:
        row = self._task_row(guid, task_id)
        if row is None:
            return None
        return TaskState(int(self.kernel.store.record_get(
            self.kernel.state, guid, TASK_RECORD, row, "TaskStatus")))

    def process(self, guid: Guid, task_id: str) -> int:
        row = self._task_row(guid, task_id)
        if row is None:
            return 0
        return int(self.kernel.store.record_get(
            self.kernel.state, guid, TASK_RECORD, row, "Process"))

    def add_process(self, guid: Guid, task_id: str, n: int = 1) -> None:
        """Advance an in-process task; flips DONE at the target count."""
        row = self._task_row(guid, task_id)
        td = self.defs.get(task_id)
        if row is None or td is None:
            return
        k = self.kernel
        status = int(k.store.record_get(k.state, guid, TASK_RECORD, row,
                                        "TaskStatus"))
        if status != int(TaskState.IN_PROCESS):
            return
        cur = int(k.store.record_get(k.state, guid, TASK_RECORD, row,
                                     "Process")) + n
        k.state = k.store.record_set(k.state, guid, TASK_RECORD, row,
                                     "Process", min(cur, td.count))
        if cur >= td.count:
            k.state = k.store.record_set(k.state, guid, TASK_RECORD, row,
                                         "TaskStatus", int(TaskState.DONE))

    def draw_award(self, guid: Guid, task_id: str) -> bool:
        """Pay the award and finish (TASK_DONE → TASK_FINISH)."""
        row = self._task_row(guid, task_id)
        td = self.defs.get(task_id)
        if row is None or td is None:
            return False
        k = self.kernel
        status = int(k.store.record_get(k.state, guid, TASK_RECORD, row,
                                        "TaskStatus"))
        if status != int(TaskState.DONE):
            return False
        if td.award_gold:
            k.set_property(guid, "Gold",
                           int(k.get_property(guid, "Gold")) + td.award_gold)
        if td.award_exp and self.level is not None:
            self.level.add_exp(guid, td.award_exp)
        k.state = k.store.record_set(k.state, guid, TASK_RECORD, row,
                                     "TaskStatus", int(TaskState.FINISH))
        return True

    # ------------------------------------------------------- kill counting
    def _on_kills(self, class_name: str, mask: np.ndarray,
                  params: Dict[str, np.ndarray]) -> None:
        """Batched device kills → per-killer task progress.  `killer` is
        the packed entity handle column written by the combat phase."""
        killers = params.get("killer")
        if killers is None:
            return
        store = self.kernel.store
        spec = store.spec(class_name)
        dead_rows = np.flatnonzero(mask)
        # ONE device fetch for the whole ConfigID column, then host-side
        # decode per dead row — no per-row transfers
        cfg_handles = None
        if spec.has_property("ConfigID"):
            slot = spec.slot("ConfigID")
            cfg_handles = self.kernel.state.classes[class_name].i32[:, slot.col].cpu().numpy()
        per_killer: Dict[Guid, Dict[str, int]] = {}
        for row in dead_rows:
            killer = store.guid_of_handle(int(killers[int(row)]))
            if killer is None:
                continue
            victim_cfg = ""
            if cfg_handles is not None:
                victim_cfg = store.strings.lookup(int(cfg_handles[int(row)]))
            counts = per_killer.setdefault(killer, {})
            counts[victim_cfg] = counts.get(victim_cfg, 0) + 1
        for killer, by_cfg in per_killer.items():
            if killer not in store.guid_map:
                continue
            kc, _ = store.row_of(killer)
            if TASK_RECORD not in store.spec(kc).records:
                continue
            for task_id, td in self.defs.items():
                n = (sum(by_cfg.values()) if not td.target_config
                     else by_cfg.get(td.target_config, 0))
                if n:
                    self.add_process(killer, task_id, n)
