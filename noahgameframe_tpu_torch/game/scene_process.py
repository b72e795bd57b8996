"""Scene-process module: normal vs clone scene instances.

Counterpart of ``noahgameframe_tpu/game/scene_process.py``.  Reference
parity: NFCSceneProcessModule (NFServer/NFGameServerPlugin/
NFCSceneProcessModule.cpp:74-134, NFISceneProcessModule.h:15-20).  A scene's TYPE comes from its config
element (the reference reads Scene::CanClone from the element whose id
is the scene id; here the Scene class's SceneType property):

- NORMAL: every enterer shares one world group (created on demand).
- CLONE:  each enter request allocates a PRIVATE group — a per-player
  (or per-team) instance of the scene — and the group is released when
  its owner is destroyed (NFCSceneProcessModule::OnObjectClassEvent,
  COE_DESTROY -> ReleaseGroupScene).
"""

from __future__ import annotations

from typing import Dict

from ..core.datatypes import Guid
from ..kernel.module import Module
from ..kernel.scene import SceneModule

SCENE_TYPE_NORMAL = 0
SCENE_TYPE_CLONE = 1


class SceneProcessModule(Module):
    name = "SceneProcessModule"

    def __init__(self, scene: SceneModule,
                 player_class: str = "Player") -> None:
        super().__init__()
        self._scene = scene
        self.player_class = player_class
        # clone-group ownership: guid -> (scene_id, group_id)
        self._clone_groups: Dict[Guid, tuple] = {}

    # -- lifecycle -----------------------------------------------------------

    def after_init(self) -> None:
        # release a player's clone instance when the player goes away
        self.kernel.register_class_event(self._on_player_event, self.player_class)

    # -- API (NFISceneProcessModule surface) ---------------------------------

    def scene_type(self, scene_id: int) -> int:
        """GetCloneSceneType: the scene element's SceneType.  ElementStore
        defaults missing elements/properties to 0 == NORMAL."""
        return int(self.kernel.elements.get_int(str(scene_id), "SceneType"))

    def enter(self, guid: Guid, scene_id: int, group_id: int = 0) -> int:
        """Route an enter-scene request by scene type; returns the group
        actually entered.  CLONE scenes ignore the requested group and
        mint a private instance (seeded from the scene's seed specs)."""
        scene = self._scene
        if scene_id not in scene.scenes:
            scene.create_scene(scene_id)
        if self.scene_type(scene_id) == SCENE_TYPE_CLONE:
            group = scene.request_group(scene_id, seed_npcs=True)
            old = self._clone_groups.pop(guid, None)
            scene.enter_scene(guid, scene_id, group)
            # release the previous instance only AFTER the owner moved
            # out of it — releasing a group destroys its members
            if old is not None:
                sc, gr = old
                if sc in scene.scenes and gr in scene.scenes[sc].groups:
                    scene.release_group(sc, gr)
            self._clone_groups[guid] = (scene_id, group)
        else:
            group = group_id if group_id > 0 else 1
            if group not in scene.scenes[scene_id].groups:
                scene.request_group(scene_id, seed_npcs=True, group_id=group)
            scene.enter_scene(guid, scene_id, group)
            # the owner walked out of any clone instance it held
            self._release_owned(guid)
        return group

    # -- internals -----------------------------------------------------------

    def _release_owned(self, guid: Guid) -> None:
        owned = self._clone_groups.pop(guid, None)
        if owned is not None:
            sc, gr = owned
            if sc in self._scene.scenes and gr in self._scene.scenes[sc].groups:
                self._scene.release_group(sc, gr)

    def _on_player_event(self, guid: Guid, class_name: str, ev) -> None:
        from ..kernel.kernel import ObjectEvent

        if ev == ObjectEvent.DESTROY:
            self._release_owned(guid)
