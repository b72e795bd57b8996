"""Gameplay layer: the reference's NFGameServerPlugin/NFGameLogicPlugin
capabilities rebuilt as batched device phases + host control-plane APIs.

The JAX package's ``noahgameframe_tpu.game`` exports, under the same names."""

from .buff import BuffModule
from .combat import ATTACK_TIMER, CombatModule, SkillModule
from .defines import (
    COMM_PROPERTY_RECORD,
    EShopType,
    GameEvent,
    ItemSubType,
    ItemType,
    NpcType,
    PropertyGroup,
    SLGBuildingState,
    STAT_NAMES,
    TaskState,
)
from .hero import HeroModule
from .items import EquipModule, ItemModule, PackModule
from .level import LevelModule
from .task import TaskDef, TaskModule
from .trail import PropertyTrailModule
from .movement import MovementModule
from .scene_process import SCENE_TYPE_CLONE, SCENE_TYPE_NORMAL, SceneProcessModule
from .property_config import PropertyConfigModule
from .regen import REGEN_TIMER, RegenModule
from .schema import standard_registry
from .slg import SLGBuildingModule, SLGShopModule
from .social import (
    FriendModule,
    GmModule,
    GuildModule,
    MailModule,
    PvpMatchModule,
    RankModule,
    ShopModule,
    TeamModule,
)
from .stats import PropertyModule
from .world import GameWorld, WorldConfig, build_benchmark_world

__all__ = [
    "ATTACK_TIMER",
    "BuffModule",
    "EquipModule",
    "HeroModule",
    "ItemModule",
    "ItemSubType",
    "ItemType",
    "PackModule",
    "TaskDef",
    "TaskModule",
    "TaskState",
    "FriendModule",
    "GmModule",
    "GuildModule",
    "MailModule",
    "PvpMatchModule",
    "RankModule",
    "ShopModule",
    "TeamModule",
    "COMM_PROPERTY_RECORD",
    "CombatModule",
    "GameEvent",
    "GameWorld",
    "LevelModule",
    "MovementModule",
    "SceneProcessModule",
    "SCENE_TYPE_CLONE",
    "SCENE_TYPE_NORMAL",
    "NpcType",
    "PropertyConfigModule",
    "PropertyGroup",
    "PropertyModule",
    "PropertyTrailModule",
    "REGEN_TIMER",
    "RegenModule",
    "EShopType",
    "SLGBuildingModule",
    "SLGBuildingState",
    "SLGShopModule",
    "STAT_NAMES",
    "SkillModule",
    "WorldConfig",
    "build_benchmark_world",
    "standard_registry",
]
