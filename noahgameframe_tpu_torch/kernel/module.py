"""Module protocol: the unit of framework extension.

The reference's NFIModule declares a 9-phase lifecycle driven by the plugin
manager (Awake → Init → AfterInit → CheckConfig → ReadyExecute → Execute…
→ BeforeShut → Shut → Finalize; NFIPluginManager.h:21-80, NFIPlugin.h).  We
keep that lifecycle for the host control plane and add the device seam: a
module may register *device phases* — `f(state, ctx) -> state` functions
over whole tensors that the kernel runs, in declared order, as the world
tick.  The reference's per-object virtual `Execute()` loop
(NFCKernelModule.cpp:88-96) becomes this phase chain over whole columns.

Intra-tick ordering contract (replaces synchronous per-write callbacks):
phases run in ascending `order`; each phase sees all writes of earlier
phases (functional read-after-write).  Cross-entity reduction therefore has
one-phase granularity, which is also the determinism guarantee the golden
tests rely on.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, List, Optional

if TYPE_CHECKING:
    from ..core.store import WorldState
    from .kernel import Kernel, TickCtx

PhaseFn = Callable[["WorldState", "TickCtx"], "WorldState"]


# the same phase over a sharded world: the list of every local shard's
# block state and its TickCtx (``ctx.shard`` set), returning the new
# blocks (parallel/shard.py runs it; it may call parallel/collectives)
MeshPhaseFn = Callable[[List["WorldState"], List["TickCtx"]], List["WorldState"]]


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    fn: PhaseFn
    order: int = 100
    # None: the phase is row-local, and a sharded tick runs ``fn`` once
    # per shard on that shard's blocks
    mesh_fn: Optional[MeshPhaseFn] = None


class Module:
    """Base class for framework modules (host lifecycle + device phases)."""

    name: str = ""

    def __init__(self) -> None:
        if not self.name:
            self.name = type(self).__name__
        self.kernel: Optional["Kernel"] = None
        self._phases: List[Phase] = []

    # -- lifecycle (host), called by GameWorld.start in this order ----------

    def awake(self) -> None: ...

    def init(self) -> None: ...

    def after_init(self) -> None: ...

    def check_config(self) -> None: ...

    def ready_execute(self) -> None: ...

    def execute(self) -> None:
        """Per-frame host-side work (network pump, async drains).  Device
        work belongs in phases, not here."""

    def before_shut(self) -> None: ...

    def shut(self) -> None: ...

    def finalize(self) -> None: ...

    def capture_key(self) -> dict:
        """Host-side values this module's phases close over (a bucket, an
        engine, an environment knob).  The kernel keys its captured CUDA
        graphs on them: a change captures the tick again."""
        return {}

    # -- checkpoint hooks (host state) ---------------------------------------

    def checkpoint_state(self) -> Optional[dict]:
        """JSON-serializable host state to include in a world checkpoint
        (persist/checkpoint.py).  Device state checkpoints automatically;
        modules holding host-side maps override this so a resume really
        resumes.  None = nothing to save."""
        return None

    def restore_state(self, data: dict) -> None:
        """Inverse of checkpoint_state, called after the device state and
        identity maps are restored (guids resolve again)."""

    # -- device phase registration ------------------------------------------

    def add_phase(self, name: str, fn: PhaseFn, order: int = 100,
                  mesh_fn: Optional[MeshPhaseFn] = None) -> None:
        self._phases.append(Phase(f"{self.name}.{name}", fn, order, mesh_fn))

    @property
    def phases(self) -> List[Phase]:
        return list(self._phases)

    def clear_phases(self) -> None:
        self._phases.clear()


LIFECYCLE = (
    "awake",
    "init",
    "after_init",
    "check_config",
    "ready_execute",
)
SHUTDOWN = ("before_shut", "shut", "finalize")
