"""LocalCluster: the five-role topology assembled in one process.

The reference's de-facto integration test is "start all five servers on
localhost and watch the master dashboard go green"
(`_Out/Tester/rund_*.sh`, SURVEY §4).  LocalCluster is that bring-up as a
library call: every role on 127.0.0.1 ephemeral ports, all pumped from one
loop — which also makes it the single-process simulation mode for tests
and bots.  For a real multi-process deployment run one role per process
via ``scripts/run_role.py`` with a shared Server.xml.

Counterpart of ``noahgameframe_tpu/net/roles/cluster.py``, with one
argument of the port's own: ``device`` is the device of every default
world a game role builds (the games given no world through
``game_world`` or ``game_kwargs_by_name[...]["world"]``, and a revive
given none).  ``None`` means ``"cuda"`` and raises without a card before
any socket is opened; a given world keeps its own device.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional

from ...core.device import DeviceLike, resolve_device
from ...game.world import GameWorld
from ..chaos import ChaosDirector, FaultPlan
from ..defines import ServerType
from ..retry import RetryPolicy
from .base import RoleConfig
from .game import GameRole
from .login import LoginRole
from .master import MasterRole
from .proxy import ProxyRole
from .world import WorldRole


def pace_role(role, keepalive_seconds: float) -> None:
    """Scale every outbound pool's cadence of ``role`` to one keepalive:
    reports at ``keepalive_seconds``, re-dials backing off from it (the
    library defaults are sized for real deployments — a test cluster on a
    10 s reconnect timer would make every fault take minutes)."""
    ka = keepalive_seconds
    for pool in role.clients.values():
        pool.keepalive_seconds = ka
        pool.retry = RetryPolicy(base=ka, cap=max(1.0, 5 * ka))
        pool.reconnect_seconds = max(1.0, 5 * ka)  # CONNECTING timeout


class LocalCluster:
    """Master + Login + World + Proxy + Game on localhost, one pump."""

    def __init__(
        self,
        backend: str = "auto",
        http_port: Optional[int] = None,
        game_world: Optional[GameWorld] = None,
        n_games: int = 1,
        keepalive_seconds: float = 0.2,
        lease_suspect_seconds: Optional[float] = None,
        lease_down_seconds: Optional[float] = None,
        game_kwargs: Optional[dict] = None,
        game_kwargs_by_name: Optional[Dict[str, dict]] = None,
        world_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
    ) -> None:
        host = "127.0.0.1"
        self._backend = backend
        self._host = host
        self.keepalive_seconds = keepalive_seconds
        # extra GameRole kwargs (checkpoint_dir, checkpoint_seconds, …)
        # remembered so revive_role() rebuilds an identical role
        self._game_kwargs = dict(game_kwargs or {})
        # per-role overrides keyed by config name ("Game1", "Game2"):
        # failover drills need each game on its OWN wal/checkpoint dirs —
        # a shared dict would have every game scribbling over one WAL
        self._game_kwargs_by_name = {
            k: dict(v) for k, v in (game_kwargs_by_name or {}).items()
        }
        # the device of the default worlds, resolved before any socket
        # opens (without a card, device=None raises here); kept lazy when
        # every game brings its own world
        self._device = device
        if any(self._merged_game_kwargs(f"Game{i + 1}").get("world") is None
               and not (i == 0 and game_world is not None)
               for i in range(n_games)):
            self._device = resolve_device(device)
        # killed-role configs by config name, revivable later
        self._killed: Dict[str, RoleConfig] = {}
        self.chaos: Optional[ChaosDirector] = None
        master_kw = {}
        world_kw = {}
        if lease_suspect_seconds is not None:
            master_kw["lease_suspect_seconds"] = lease_suspect_seconds
        if lease_down_seconds is not None:
            master_kw["lease_down_seconds"] = lease_down_seconds
            world_kw["lease_down_seconds"] = lease_down_seconds
        # caller-supplied WorldRole kwargs (recover_store for the
        # failover driver's store fallback, failover=False to opt out…)
        world_kw.update(world_kwargs or {})
        self.master = MasterRole(
            RoleConfig(1, int(ServerType.MASTER), "Master1", host, 0),
            backend=backend,
            http_port=http_port,
            **master_kw,
        )
        master_t = [self.master.config]
        self.world = WorldRole(
            RoleConfig(7, int(ServerType.WORLD), "World1", host, 0,
                       targets=master_t),
            backend=backend,
            **world_kw,
        )
        world_t = [self.world.config]
        self._world_t = world_t
        self.login = LoginRole(
            RoleConfig(4, int(ServerType.LOGIN), "Login1", host, 0,
                       targets=master_t),
            backend=backend,
        )
        self.proxy = ProxyRole(
            RoleConfig(5, int(ServerType.PROXY), "Proxy1", host, 0,
                       targets=world_t),
            backend=backend,
        )
        self.games: List[GameRole] = []
        for i in range(n_games):
            name = f"Game{i + 1}"
            kw = self._merged_game_kwargs(name)
            # per-game worlds: game_kwargs_by_name may carry a "world"
            # for ANY game (a game-day survivor needs capacity for the
            # whole surge); the legacy game_world argument still wins
            # for Game1
            world = kw.pop("world", None)
            if i == 0 and game_world is not None:
                world = game_world
            self.games.append(
                GameRole(
                    RoleConfig(6 + i * 10, int(ServerType.GAME),
                               name, host, 0, targets=world_t),
                    backend=backend,
                    world=world,
                    device=self._device,
                    **kw,
                )
            )
        self.game = self.games[0]
        self.roles = [self.master, self.world, self.login, self.proxy, *self.games]
        # speed up the registration/report cadence for in-process runs
        for role in self.roles:
            self._speed_role(role)

    def _merged_game_kwargs(self, name: str) -> dict:
        kw = dict(self._game_kwargs)
        kw.update(self._game_kwargs_by_name.get(name, {}))
        return kw

    def _speed_role(self, role) -> None:
        pace_role(role, self.keepalive_seconds)

    # ------------------------------------------------------------- pump
    def execute(self) -> None:
        for role in self.roles:
            role.execute()

    def pump(self, extra: Callable[[], None] = None, rounds: int = 50,
             sleep: float = 0.002) -> None:
        """Drive everything for `rounds` iterations (plus an optional
        client-side pump)."""
        for _ in range(rounds):
            self.execute()
            if extra is not None:
                extra()
            _time.sleep(sleep)

    def pump_until(self, cond: Callable[[], bool],
                   extra: Callable[[], None] = None,
                   timeout: float = 10.0, sleep: float = 0.002) -> bool:
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            self.execute()
            if extra is not None:
                extra()
            if cond():
                return True
            _time.sleep(sleep)
        return False

    def role_by_name(self, name: str):
        """Live role by config name ("Game1", "Proxy1", …); raises
        StopIteration-free KeyError semantics via ValueError."""
        for r in self.roles:
            if r.config.name == name:
                return r
        raise ValueError(f"no live role named {name!r}")

    def wired(self) -> bool:
        """True when the full topology is registered: world+login at
        master, proxy+game at world, proxy has a live game link."""
        reg = self.master.registry
        return (
            bool(reg.get(int(ServerType.WORLD)))
            and bool(reg.get(int(ServerType.LOGIN)))
            and len(self.world.proxies) > 0
            and len(self.world.games) >= len(self.games)
            and len(self.proxy.games.connected_servers()) >= len(self.games)
        )

    def start(self, timeout: float = 15.0) -> "LocalCluster":
        if not self.pump_until(self.wired, timeout=timeout):
            raise RuntimeError("cluster failed to wire up")
        return self

    def shut(self) -> None:
        for role in self.roles:
            role.shut()

    # ----------------------------------------------------------- chaos
    @staticmethod
    def _role_name(role) -> str:
        return (type(role).__name__.replace("Role", "").lower()
                + str(role.config.server_id))

    def apply_chaos(self, plan: FaultPlan) -> ChaosDirector:
        """Interpose a :class:`FaultyTransport` on every outbound link of
        every role (link names like ``proxy5.games->6``; FaultPlan
        patterns substring-match them).  Faults survive re-dials: the
        director owns the per-link counters and each fresh transport the
        pool creates is wrapped again."""
        self.chaos = ChaosDirector(plan)
        # surface the plan: /json shows seed + per-link budgets so any
        # chaos run is re-derivable for offline replay
        self.master.chaos_status = self.chaos.status
        for role in self.roles:
            self._chaos_role(role)
        return self.chaos

    def _chaos_role(self, role) -> None:
        if self.chaos is None:
            return
        rname = self._role_name(role)
        director = self.chaos

        def make_wrapper(key: str):
            def wrap(client, sd):
                return director.wrap(
                    client, f"{rname}.{key}->{sd.server_id}"
                )
            return wrap

        for key, pool in role.clients.items():
            pool.transport_wrapper = make_wrapper(key)
            # wrap links that are already live (apply_chaos after start)
            for sd in pool.servers.values():
                if sd.client is not None:
                    sd.client = director.wrap(
                        sd.client, f"{rname}.{key}->{sd.server_id}"
                    )
        # store links: the write-behind flusher's backend gets the same
        # treatment as a transport — the director owns the op counts and
        # rng, so a revived role's rebuilt pipeline CONTINUES the fault
        # schedule instead of restarting it
        pipeline = getattr(role, "persist", None)
        if pipeline is not None:
            pipeline.backend = director.wrap_store(
                pipeline.backend, f"{rname}.store"
            )
        role.telemetry.add_chaos_source(director, prefix=f"{rname}.")
        # flight recorder: a recording game role journals the fault-plan
        # seed + link budgets as an epoch note (RNG seeds of everything
        # that can reorder its inputs belong in the journal)
        note = getattr(role, "journal_note", None)
        if note is not None:
            plan = director.plan
            note(
                kind="chaos",
                seed=int(plan.seed),
                links={p: dataclasses.asdict(f)
                       for p, f in plan.links.items()},
                stores={p: dataclasses.asdict(f)
                        for p, f in plan.stores.items()},
            )

    # ----------------------------------------------------------- drills
    def attach_drill(self, runner) -> None:
        """Surface a DrillRunner on the master's /json (``drill`` block:
        campaign clock, fired/remaining steps, invariant breaches) —
        the drill-side twin of what apply_chaos does for the fault
        plan.  Called by :class:`drill.runner.DrillRunner` itself."""
        self.master.drill_status = runner.status
        # a recording game role journals the campaign identity, so a
        # drilled run's journal pins the schedule that shaped it
        for role in self.roles:
            note = getattr(role, "journal_note", None)
            if note is not None:
                note(kind="drill", campaign=runner.campaign.name,
                     seed=int(runner.campaign.seed),
                     steps=len(runner.campaign.steps))

    # ----------------------------------------------------- kill / revive
    def kill_role(self, role, hard: bool = False) -> RoleConfig:
        """Kill one role: sockets dropped, removed from the pump.
        Accepts the role object or its config name.  Returns the config
        (revive_role uses the remembered name).

        ``hard=True`` uses the role's crash path (:meth:`GameRole.kill`)
        — no session saves, no persist drain, the WAL keeps whatever
        reached it.  That is the failover-drill semantics: the world
        must recover from durable state alone.  Default stays the
        graceful :meth:`shut`."""
        if isinstance(role, str):
            role = next(r for r in self.roles if r.config.name == role)
        if hard and hasattr(role, "kill"):
            role.kill()
        else:
            role.shut()
        self.roles.remove(role)
        if role in self.games:
            self.games.remove(role)
        if self.game is role:
            self.game = self.games[0] if self.games else None
        self._killed[role.config.name] = role.config
        return role.config

    def revive_role(self, name: str, world: Optional[GameWorld] = None,
                    resume: bool = True) -> GameRole:
        """Bring a killed game role back on a fresh ephemeral port,
        resuming from its checkpoint by default.  Re-registration with
        World (and Master, via the relay) rides the normal on-connect
        path; the proxy learns the new endpoint from World's next game
        list push."""
        cfg = self._killed.pop(name)
        if cfg.server_type != int(ServerType.GAME):
            raise NotImplementedError(
                f"revive_role supports game roles only, not {name}"
            )
        kwargs = self._merged_game_kwargs(cfg.name)
        kwargs["resume"] = resume
        # an explicit world (fresh substrate for the checkpoint load)
        # wins over a per-game world remembered in the kwargs map
        kw_world = kwargs.pop("world", None)
        if world is None:
            world = kw_world
        role = GameRole(
            RoleConfig(cfg.server_id, cfg.server_type, cfg.name,
                       self._host, 0, targets=self._world_t),
            backend=self._backend,
            world=world,
            device=self._device,
            **kwargs,
        )
        self._speed_role(role)
        self._chaos_role(role)
        self.games.append(role)
        if self.game is None:
            self.game = role
        self.roles.append(role)
        return role
