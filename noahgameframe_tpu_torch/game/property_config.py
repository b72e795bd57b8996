"""Per-(job, level) base-stat tables as dense device tensors.

Counterpart of ``noahgameframe_tpu/game/property_config.py`` (reference
NFCPropertyConfigModule, NFCPropertyConfigModule.cpp:37-88): the whole
table lives in ``table[n_jobs, n_levels, n_stats]`` int32, so a base-stat
refresh for every row is one gather, and level-from-exp is a row-wise
searchsorted over cumulative MAXEXP thresholds.  The host stages the
table (``set_level_config``, ``load_elements``, ``fill_linear``) and
answers ``calculate_base_value``/``legal_level`` from the staging.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.element import ElementStore
from ..kernel.module import Module
from .defines import STAT_NAMES


class PropertyConfigModule(Module):
    name = "PropertyConfigModule"

    def __init__(self, n_jobs: int = 4, max_level: int = 100):
        super().__init__()
        self.n_jobs = int(n_jobs)
        self.max_level = int(max_level)
        # host-side staging; frozen to device tensors on ready_execute
        self._base = np.zeros((n_jobs, max_level + 1, len(STAT_NAMES)), np.int32)
        self._max_exp = np.zeros((n_jobs, max_level + 1), np.int32)
        self.table: Optional[torch.Tensor] = None  # [J, L+1, S] int32
        self.max_exp: Optional[torch.Tensor] = None  # [J, L+1] int32
        self.cum_exp: Optional[torch.Tensor] = None  # [J, L+1] int32

    # -- table construction --------------------------------------------------

    def set_level_config(self, job: int, level: int, stats: Dict[str, int],
                         max_exp: int = 0) -> None:
        for k, v in stats.items():
            self._base[job, level, STAT_NAMES.index(k)] = int(v)
        self._max_exp[job, level] = int(max_exp)
        # nf-lint: disable=recapture-hazard -- marks the host staging
        # dirty; the device tables change only in freeze(), which
        # invalidates the captured tick
        self.table = None

    def load_elements(self, elements: ElementStore) -> int:
        """Ingest InitProperty elements: each names a (Job, Level) cell and
        an EffectData element holding the stat values (reference
        NFCPropertyConfigModule::Load)."""
        n = 0
        for eid in elements.ids_of_class("InitProperty"):
            e = elements.element(eid)
            job = int(e.values.get("Job", 0))
            level = int(e.values.get("Level", 0))
            if not (0 <= job < self.n_jobs and 0 <= level <= self.max_level):
                continue
            stats: Dict[str, int] = {}
            ref = str(e.values.get("EffectData", "") or "")
            if ref and elements.exists(ref):
                ev = elements.element(ref).values
                stats = {k: int(v) for k, v in ev.items() if k in STAT_NAMES}
            self.set_level_config(job, level, stats, max_exp=int(e.values.get("MAXEXP", 0)))
            n += 1
        return n

    def fill_linear(self, job: int, base: Dict[str, int], per_level: Dict[str, int],
                    max_exp_base: int = 100, max_exp_per_level: int = 50) -> None:
        """Procedural table for tests and benchmarks: stat = base + lvl*slope."""
        lv = np.arange(self.max_level + 1)
        for k in STAT_NAMES:
            b, s = int(base.get(k, 0)), int(per_level.get(k, 0))
            self._base[job, :, STAT_NAMES.index(k)] = b + lv * s
        self._max_exp[job] = max_exp_base + lv * max_exp_per_level
        # nf-lint: disable=recapture-hazard -- marks the host staging
        # dirty; the device tables change only in freeze(), which
        # invalidates the captured tick
        self.table = None

    def freeze(self) -> None:
        """Push the tables to the kernel's device.  cum_exp[j, L] = total
        exp needed to REACH level L from level 0, kept in int32 as the JAX
        package keeps it (jax without x64 narrows the int64 staging).  The
        captured tick holds the old tensors, so this invalidates it."""
        dev = self.kernel.device
        # nf-lint: disable=recapture-hazard -- new table tensors, and the
        # kernel.invalidate() below in the same call re-captures the tick
        self.table = torch.from_numpy(self._base).to(dev)
        self.max_exp = torch.from_numpy(self._max_exp).to(dev)
        cum = np.zeros((self.n_jobs, self.max_level + 1), np.int64)
        cum[:, 1:] = np.cumsum(self._max_exp[:, :-1].astype(np.int64), axis=1)
        # nf-lint: disable=recapture-hazard -- as the table above: the
        # invalidate() below re-captures the tick
        self.cum_exp = torch.from_numpy(cum.astype(np.int32)).to(dev)
        self.kernel.invalidate()

    def ready_execute(self) -> None:
        if self.table is None:
            self.freeze()

    # -- host-side queries ----------------------------------------------------

    def calculate_base_value(self, job: int, level: int, stat: str) -> int:
        if stat == "MAXEXP":
            return int(self._max_exp[job, level])
        return int(self._base[job, level, STAT_NAMES.index(stat)])

    def legal_level(self, job: int, level: int) -> bool:
        return 0 <= job < self.n_jobs and 0 <= level <= self.max_level

    # -- device-side queries ----------------------------------------------------

    def base_stats_for(self, job: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        """[C] job, [C] level -> [C, S] base stats (one gather)."""
        j = job.clamp(0, self.n_jobs - 1).long()
        lv = level.clamp(0, self.max_level).long()
        return self.table[j, lv]

    def level_from_total_exp(self, job: torch.Tensor, total_exp: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Total accumulated exp -> (level, exp-within-level)."""
        thresholds = self.cum_exp[job.clamp(0, self.n_jobs - 1).long()]  # [C, L+1]
        level = torch.sum(thresholds <= total_exp[:, None], dim=1, dtype=torch.int32) - 1
        level = level.clamp(0, self.max_level)
        base = torch.gather(thresholds, 1, level.long()[:, None])[:, 0]
        return level, (total_exp - base).to(torch.int32)
