"""Scene/group module: world partitioning and broadcast sets.

Counterpart of ``noahgameframe_tpu/kernel/scene.py`` (reference
NFCSceneAOIModule): scenes hold numbered groups; "AOI" here is
group-granular broadcast, not spatial: a Public change fans out to every
Player in the same (scene, group), GroupID 0 meaning scene-wide.  The
enter/leave choreography runs on GroupID/SceneID writes between before
and after hook lists, and creating a group seeds its NPCs
(NFCSceneAOIModule.cpp:82-160, 292-430, 531-593).

(SceneID, GroupID) are int32 columns of each class's i32 bank, so the
membership queries are one compare on the device and one fetch of the
matching row indices; :meth:`SceneModule.cell_key` (scene *
MAX_GROUPS_PER_SCENE + group) is the partition key the spatial ops use.
Enter and leave stay on the host, in the reference's hook order; spatial
neighbour queries live in ops/aoi.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.datatypes import Guid, Value
from ..core.store import WorldState
from .module import Module

MAX_GROUPS_PER_SCENE = 1024  # fixes the cell_key encoding

# hook signature: (guid, scene_id, group_id)
SceneHookFn = Callable[[Guid, int, int], None]


class GroupIdsExhausted(RuntimeError):
    """A scene's group-id space (MAX_GROUPS_PER_SCENE) is fully minted and
    nothing sits on its free list.  Released ids recycle through
    ``SceneInfo.free_groups``, so create/destroy churn never raises this;
    only more than 1023 groups live at once in one scene does."""

    def __init__(self, scene_id: int, limit: int = MAX_GROUPS_PER_SCENE):
        self.scene_id = int(scene_id)
        self.limit = int(limit)
        super().__init__(
            f"scene {scene_id} group ids exhausted "
            f"({limit} live groups, none released)"
        )


@dataclasses.dataclass
class SeedSpec:
    """An NPC seed planted in a scene: spawned into every new group."""

    elem_id: str
    class_name: str
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    values: Optional[Dict[str, Value]] = None


@dataclasses.dataclass
class GroupInfo:
    group_id: int
    seeded: List[Guid] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SceneInfo:
    scene_id: int
    seeds: List[SeedSpec] = dataclasses.field(default_factory=list)
    groups: Dict[int, GroupInfo] = dataclasses.field(default_factory=dict)
    next_group: int = 1
    width: float = 512.0  # world extent, used by spatial grids
    # released group ids, recycled by request_group before fresh ones
    free_groups: List[int] = dataclasses.field(default_factory=list)


class SceneModule(Module):
    name = "SceneModule"

    def __init__(self) -> None:
        super().__init__()
        self.scenes: Dict[int, SceneInfo] = {}
        # the reference's 10 callback vectors (NFCSceneAOIModule.h:95-105)
        # as 6 hook lists with the same ordering guarantees
        self.before_enter_scene: List[SceneHookFn] = []
        self.after_enter_scene: List[SceneHookFn] = []
        self.before_leave_scene: List[SceneHookFn] = []
        self.after_leave_scene: List[SceneHookFn] = []
        self.on_swap_group: List[SceneHookFn] = []
        self.on_group_created: List[Callable[[int, int], None]] = []

    # -- scene / group management ------------------------------------------

    def create_scene(self, scene_id: int, seeds: Sequence[SeedSpec] = (),
                     width: float = 512.0) -> SceneInfo:
        if scene_id in self.scenes:
            raise ValueError(f"scene {scene_id} already exists")
        info = SceneInfo(scene_id=scene_id, seeds=list(seeds), width=width)
        self.scenes[scene_id] = info
        # group 0 always exists: the scene's lobby (GroupID 0 is scene-wide)
        info.groups[0] = GroupInfo(0)
        return info

    def request_group(self, scene_id: int, seed_npcs: bool = True,
                      group_id: Optional[int] = None) -> int:
        """Allocate a group in a scene and seed its NPCs (reference
        RequestGroupScene).  With ``group_id`` the caller picks the id (it
        must be free); otherwise released ids are recycled before fresh
        ones are minted."""
        info = self.scenes[scene_id]
        if group_id is not None:
            gid = int(group_id)
            if gid <= 0 or gid >= MAX_GROUPS_PER_SCENE:
                raise ValueError(f"group id {gid} out of range")
            if gid in info.groups:
                raise ValueError(f"group {gid} already exists in scene {scene_id}")
            if gid in info.free_groups:
                info.free_groups.remove(gid)
            info.next_group = max(info.next_group, gid + 1)
        elif info.free_groups:
            gid = info.free_groups.pop()
        else:
            gid = info.next_group
            info.next_group += 1
            if gid >= MAX_GROUPS_PER_SCENE:
                raise GroupIdsExhausted(scene_id)
        group = GroupInfo(gid)
        info.groups[gid] = group
        if seed_npcs:
            for seed in info.seeds:
                g = self.kernel.create_from_element(
                    seed.class_name,
                    seed.elem_id,
                    overrides={**(seed.values or {}), "Position": seed.position},
                    scene=scene_id,
                    group=gid,
                )
                group.seeded.append(g)
        for fn in self.on_group_created:
            fn(scene_id, gid)
        return gid

    def release_group(self, scene_id: int, group_id: int) -> int:
        """Destroy a group and everything in it; returns the destroyed
        count (reference ReleaseGroupScene)."""
        info = self.scenes[scene_id]
        existed = info.groups.pop(group_id, None) is not None
        n = 0
        for class_name in self.kernel.store.class_order:
            for guid in self.objects_in_group(scene_id, group_id, class_name):
                self.kernel.destroy_object(guid)
                n += 1
        if existed and group_id not in info.free_groups:
            info.free_groups.append(group_id)
        return n

    # -- enter / leave choreography ----------------------------------------

    def enter_scene(self, guid: Guid, scene_id: int, group_id: int) -> None:
        """Full enter pipeline with before/after hooks on both sides
        (reference RequestEnterScene + OnGroupEvent/OnSceneEvent)."""
        if scene_id not in self.scenes:
            raise KeyError(f"scene {scene_id} does not exist")
        if group_id not in self.scenes[scene_id].groups:
            raise KeyError(f"group {group_id} does not exist in scene {scene_id}")
        k = self.kernel
        old_scene = int(k.get_property(guid, "SceneID"))
        old_group = int(k.get_property(guid, "GroupID"))
        if old_scene == scene_id and old_group == group_id:
            return
        for fn in self.before_leave_scene:
            fn(guid, old_scene, old_group)
        for fn in self.before_enter_scene:
            fn(guid, scene_id, group_id)
        k.set_property(guid, "GroupID", 0)  # leave the old group first
        k.set_property(guid, "SceneID", scene_id)
        k.set_property(guid, "GroupID", group_id)
        for fn in self.after_leave_scene:
            fn(guid, old_scene, old_group)
        for fn in self.after_enter_scene:
            fn(guid, scene_id, group_id)
        if old_scene == scene_id:
            for fn in self.on_swap_group:
                fn(guid, scene_id, group_id)

    # -- membership queries -------------------------------------------------

    def _member_rows(self, scene_id: int, group_id: Optional[int],
                     class_name: str) -> np.ndarray:
        """Alive rows of a class in (scene, group), ascending: the compare
        runs on the device and only the row indices come back."""
        k = self.kernel
        spec = k.store.spec(class_name)
        if not (spec.has_property("SceneID") and spec.has_property("GroupID")):
            return np.asarray([], np.int64)
        cs = k.state.classes[class_name]
        m = cs.alive & (cs.i32[:, spec.slots["SceneID"].col] == scene_id)
        if group_id is not None:
            m = m & (cs.i32[:, spec.slots["GroupID"].col] == group_id)
        return torch.nonzero(m).flatten().cpu().numpy()

    def _guids(self, rows: np.ndarray, class_name: str) -> List[Guid]:
        host = self.kernel.store._hosts[class_name]
        return [host.row_guid[int(r)] for r in rows if host.row_guid[int(r)] is not None]

    def objects_in_group(self, scene_id: int, group_id: int,
                         class_name: str) -> List[Guid]:
        """GetGroupObjectList equivalent."""
        return self._guids(self._member_rows(scene_id, group_id, class_name), class_name)

    def objects_in_scene(self, scene_id: int, class_name: str) -> List[Guid]:
        return self._guids(self._member_rows(scene_id, None, class_name), class_name)

    def broadcast_targets(self, guid: Guid, public: bool,
                          player_class: str = "Player") -> List[Guid]:
        """GetBroadCastObject: a Public change goes to every player in the
        same (scene, group), GroupID 0 meaning scene-wide; a Private one
        goes to self only, if self is a player
        (NFCSceneAOIModule.cpp:531-593)."""
        k = self.kernel
        class_name, _ = k.store.row_of(guid)
        if not public:
            return [guid] if class_name == player_class else []
        scene = int(k.get_property(guid, "SceneID"))
        group = int(k.get_property(guid, "GroupID"))
        if group == 0:
            return self.objects_in_scene(scene, player_class)
        return self.objects_in_group(scene, group, player_class)

    # -- device views --------------------------------------------------------

    def cell_key(self, state: WorldState, class_name: str) -> torch.Tensor:
        """[C] int32 partition key = scene * MAX_GROUPS_PER_SCENE + group:
        the unit of broadcast and of AOI locality."""
        spec = self.kernel.store.spec(class_name)
        cs = state.classes[class_name]
        scene = cs.i32[:, spec.slots["SceneID"].col]
        group = cs.i32[:, spec.slots["GroupID"].col]
        return scene * MAX_GROUPS_PER_SCENE + group
