"""GameWorld: one-call assembly of the standard game stack.

Counterpart of ``noahgameframe_tpu/game/world.py``: kernel, scene, scene
process, components, property config, stats, level, skills, the sixteen
middleware modules (items, heroes, tasks, buffs, the social modules and
SLG; ``WorldConfig.middleware``, on by default as there), movement, combat,
regen and telemetry, in three plugins of one :class:`PluginManager`
(``GameWorld.pm``), in the JAX package's order (which fixes the timer
slots and the order of phases of equal ``order``).  :meth:`GameWorld.start`
is ``pm.start()`` and :meth:`GameWorld.run` its frame loop.
:meth:`GameWorld.save` and :meth:`GameWorld.load` checkpoint the world in
the JAX package's format (persist/checkpoint.py).

``build_benchmark_world`` is BASELINE config 4 (AoE damage plus stat
recompute) at ~0.4 NPCs per world unit², the world ``bench.py`` times.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.schema import ClassRegistry
from ..core.store import StoreConfig
from ..kernel.component import ComponentModule
from ..kernel.kernel import Kernel, TickOutputs
from ..kernel.module import Module
from ..kernel.plugin import Plugin, PluginManager
from ..kernel.scene import SceneModule
from ..persist.checkpoint import load_world, save_world
from ..telemetry.module import TelemetryModule
from ..telemetry.tracing import SpanTracer
from .buff import BuffModule
from .combat import CombatModule, SkillModule
from .defines import COMM_PROPERTY_RECORD, PropertyGroup
from .hero import HeroModule
from .items import EquipModule, ItemModule, PackModule
from .level import LevelModule
from .movement import MovementModule
from .property_config import PropertyConfigModule
from .regen import RegenModule
from .scene_process import SceneProcessModule
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
from .task import TaskModule


@dataclasses.dataclass
class WorldConfig:
    npc_capacity: int = 1024
    player_capacity: int = 64
    extent: float = 512.0
    dt: float = 1.0 / 30.0
    seed: int = 0
    aoe_radius: float = 4.0
    aoi_bucket: Optional[int] = None  # None = auto-size from density
    respawn_s: float = 5.0
    attack_period_s: float = 1.0
    regen_period_s: float = 1.0
    combat: bool = True
    movement: bool = True
    regen: bool = True
    # Verlet skin of the combat grid (ops/verlet.py); None defers to the
    # NF_VERLET_SKIN knob, <= 0 disables (rebuild every tick)
    verlet_skin: Optional[float] = None
    middleware: bool = True  # items/hero/task/buff/social/SLG stack
    # full-row cross-shard migration (parallel/rowmigrate.py
    # SpatialPlacement); None keeps rows where they are
    placement: Optional[object] = None
    # the mesh the placement's migrate phase runs over; None means
    # make_mesh(placement.n_shards), one card a shard
    mesh: Optional[object] = None
    # private is included so owner-only state reaches its own client
    diff_flags: tuple = ("public", "private", "upload")


class GameWorld:
    """The assembled stack on one device (``None`` = ``"cuda"``); ``.pm`` is
    its plugin manager."""

    def __init__(self, config: Optional[WorldConfig] = None,
                 registry: Optional[ClassRegistry] = None, device=None):
        self.config = cfg = config or WorldConfig()
        self.kernel = Kernel(
            registry or standard_registry(),
            StoreConfig(
                default_capacity=64,
                capacities={
                    "NPC": cfg.npc_capacity,
                    "Player": cfg.player_capacity,
                    "IObject": 8,
                    "InitProperty": 8,
                    "Scene": 8,
                },
            ),
            dt=cfg.dt,
            seed=cfg.seed,
            diff_flags=cfg.diff_flags,
            device=device,
        )
        self.device = self.kernel.device
        self.scene = SceneModule()
        self.scene_process = SceneProcessModule(self.scene)
        self.components = ComponentModule()
        self.property_config = PropertyConfigModule()
        self.properties = PropertyModule()
        self.level = LevelModule(self.property_config, self.properties)
        self.skills = SkillModule()
        # the middleware modules a game role looks up; None on a world
        # without the middleware stack, where its handlers are no-ops
        self.pack = self.items = self.equip = self.heroes = self.tasks = None
        self.buffs = self.team = self.mail = self.rank = self.shop = None
        self.friends = self.guilds = self.gm = self.pvp = None
        self.slg_building = self.slg_shop = None
        middleware: List[Module] = []
        if cfg.middleware:
            self.pack = PackModule()
            self.items = ItemModule(self.pack)
            self.equip = EquipModule(self.pack, self.properties)
            self.heroes = HeroModule(self.properties)
            self.heroes.scene_process = self.scene_process
            self.items.heroes = self.heroes
            self.items.level = self.level
            self.items.equip = self.equip
            self.equip.items = self.items
            self.tasks = TaskModule(self.level)
            self.buffs = BuffModule()
            self.team = TeamModule()
            self.mail = MailModule(self.pack)
            self.rank = RankModule()
            self.shop = ShopModule(self.pack)
            self.friends = FriendModule()
            self.guilds = GuildModule()
            self.gm = GmModule(self.level, self.pack)
            self.pvp = PvpMatchModule()
            self.slg_building = SLGBuildingModule(self.pack)
            self.slg_shop = SLGShopModule(self.pack, self.slg_building)
            middleware = [self.pack, self.items, self.equip, self.heroes,
                          self.tasks, self.buffs, self.team, self.mail,
                          self.rank, self.shop, self.friends, self.guilds,
                          self.gm, self.pvp, self.slg_building, self.slg_shop]
        self.movement = MovementModule(extent=cfg.extent) if cfg.movement else None
        self.combat = None
        if cfg.combat:
            self.combat = CombatModule(
                extent=cfg.extent,
                radius=cfg.aoe_radius,
                bucket=cfg.aoi_bucket,
                respawn_s=cfg.respawn_s,
                attack_period_s=cfg.attack_period_s,
                verlet_skin=cfg.verlet_skin,
            )
        self.regen = RegenModule(period_s=cfg.regen_period_s) if cfg.regen else None
        self.migration = None
        if cfg.placement is not None:
            from ..parallel.rowmigrate import RowMigrationModule

            self.migration = RowMigrationModule(cfg.placement, mesh=cfg.mesh)
        # the elastic mesh surface (parallel/elastic.py), set by shard()
        self.sharded = None
        self.elastic = None
        # registry, tracer, census and the kernel's cost book; attached to
        # the kernel in after_init
        self.telemetry = TelemetryModule()
        server = [m for m in (self.scene, self.scene_process, self.components,
                              self.properties, self.level, self.skills, *middleware,
                              self.movement, self.combat, self.regen, self.migration,
                              self.telemetry)
                  if m is not None]
        self._rng = np.random.default_rng(cfg.seed)
        self.pm = PluginManager(app_name="game")
        self.pm.register_plugin(Plugin("KernelPlugin", [self.kernel]))
        self.pm.register_plugin(Plugin("ConfigPlugin", [self.property_config]))
        self.pm.register_plugin(Plugin("GameServerPlugin", server))

    def start(self) -> "GameWorld":
        """``pm.start()``: awake -> init -> (kernel.build) -> after_init ->
        check_config -> ready_execute; modules declare timers in init, and
        the world is built before after_init."""
        self.pm.start()
        return self

    @property
    def all_modules(self) -> List[Module]:
        """Every registered module: the ``modules`` argument of
        persist.checkpoint's save_world/load_world, so module host state
        (teams, guilds, mail, ranks, buff defs) survives a resume."""
        return list(self.pm.modules.values())

    def shard(self, n_devices: Optional[int] = None, mesh=None,
              ident_cols: Optional[Dict[str, int]] = None,
              exodus_tick_bound: int = 256, autoscaler=None):
        """Place the built world onto a device mesh and attach the elastic
        grow/drain controller; returns the
        :class:`~..parallel.elastic.ElasticMesh`.  With a placement, the
        mesh defaults to the migration module's (the migrate phase runs
        over the mesh the rows live on); another width retargets it."""
        from ..parallel.elastic import ElasticMesh
        from ..parallel.mesh import make_mesh
        from ..parallel.shard import ShardedKernel

        if mesh is None:
            if n_devices is None and self.migration is not None:
                mesh = self.migration.mesh
            elif self.migration is not None and n_devices == self.migration.mesh.size:
                mesh = self.migration.mesh
            else:
                mesh = make_mesh(n_devices)
        if self.migration is not None and mesh != self.migration.mesh:
            self.migration.retarget(
                placement=dataclasses.replace(self.migration.placement, n_shards=mesh.size),
                mesh=mesh)
        self.sharded = ShardedKernel(self.kernel, mesh=mesh)
        self.sharded.place()
        self.elastic = ElasticMesh(
            self.sharded, migration=self.migration, registry=self.telemetry.registry,
            ident_cols=ident_cols, exodus_tick_bound=exodus_tick_bound,
            autoscaler=autoscaler)
        return self.elastic

    def save(self, path) -> dict:
        """Checkpoint the world into the directory ``path`` (see
        persist.checkpoint.save_world, whose timing split it returns)."""
        return save_world(self.kernel, path, modules=self.all_modules)

    def load(self, path) -> dict:
        """Restore a checkpoint saved by either package into this world
        (see persist.checkpoint.load_world, whose timing split it returns)."""
        out = load_world(self.kernel, path, modules=self.all_modules)
        if self.sharded is not None:
            # a snapshot from a mesh of any width: re-place the restored
            # state on the CURRENT mesh, every cache dropped
            self.sharded.reshard(cause="snapshot_load")
        return out

    # -- seeding --------------------------------------------------------------

    def seed_npcs(self, n: int, scene: int = 1, group: int = 0, hp: int = 100,
                  atk: int = 12, deff: int = 3, regen: int = 2,
                  move_speed: int = 30000, camps: int = 2,
                  rng: Optional[np.random.Generator] = None) -> None:
        """Bulk-spawn n NPCs with randomized positions/camps.  Draws the
        same numbers in the same order as the JAX package's seed_npcs, so
        a seed gives the same world in both."""
        r = rng or self._rng
        ext = self.config.extent
        pos = r.uniform(0.0, ext, (n, 3)).astype(np.float32)
        pos[:, 2] = 0.0
        k = self.kernel
        values = {
            "SceneID": np.full(n, scene, np.int64),
            "GroupID": np.full(n, group, np.int64),
            "Position": pos,
            "TargetPos": r.uniform(0.0, ext, (n, 2)).astype(np.float32),
            "HP": np.full(n, hp, np.int64),
            "Camp": r.integers(0, camps, n),
        }
        k.state, _guids, rows = k.store.create_many(k.state, "NPC", n, values=values)
        # combat stats go through the EFFECTVALUE group of the stat record;
        # the recompute phase is the single source of final stats
        k.state = k.store.record_write_rows(
            k.state, "NPC", rows, COMM_PROPERTY_RECORD, int(PropertyGroup.EFFECTVALUE),
            {
                "MAXHP": np.full(n, hp, np.int64),
                "HPREGEN": np.full(n, regen, np.int64),
                "ATK_VALUE": np.full(n, atk, np.int64),
                "DEF_VALUE": np.full(n, deff, np.int64),
                "MOVE_SPEED": np.full(n, move_speed, np.int64),
            },
        )
        if self.combat is not None:
            self.combat.arm_all()
        if self.regen is not None:
            self.regen.arm_all("NPC")

    def tick(self) -> TickOutputs:
        """One frame (``pm.run_once``): host execute() on every module,
        then the observed device tick, whose outputs it returns."""
        return self.pm.run_once()

    def run(self, frames: int) -> None:
        """``frames`` observed frames, each one :meth:`tick`."""
        self.pm.run(int(frames))


def build_benchmark_world(n_npcs: int, extent: Optional[float] = None,
                          combat: bool = True, seed: int = 0,
                          attack_period_s: float = 1.0, player_capacity: int = 64,
                          device=None, tracer: Optional[SpanTracer] = None) -> GameWorld:
    """The staged BASELINE world: density held at ~0.4 NPCs per world
    unit² so AOI cost scales with N, not with density.

    With ``tracer``, the world's telemetry adopts it, and the build is
    its span ``world.build`` with ``world.start`` and ``world.seed_npcs``
    inside."""
    tr = tracer if tracer is not None else SpanTracer()  # off: its spans cost nothing
    with tr.span("world.build", npcs=int(n_npcs)):
        if extent is None:
            extent = max(64.0, float(np.sqrt(n_npcs / 0.4)))
        cap = 1 << int(np.ceil(np.log2(max(n_npcs, 64))))
        w = GameWorld(
            WorldConfig(
                npc_capacity=cap,
                extent=extent,
                combat=combat,
                seed=seed,
                attack_period_s=attack_period_s,
                middleware=False,
                player_capacity=player_capacity,
            ),
            device=device,
        )
        if tracer is not None:
            w.telemetry.tracer = tracer
        with tr.span("world.start"):
            w.start()
        w.scene.create_scene(1, width=extent)
        with tr.span("world.seed_npcs"):
            w.seed_npcs(n_npcs)
    return w
