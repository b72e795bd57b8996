"""Offline re-execution of a journaled GameRole.

The recorded role's device state evolved from exactly two inputs: the
net events its dispatchers delivered between ticks, and the tick
itself (whose RNG is folded from state, not wall clock).  So replay is:
load the checkpoint, then for each journaled tick window feed the
recorded events through the role's REAL dispatch tables (same handlers,
same fault isolation) and run the REAL tick — no network, no timers, no
proxy.  After every tick the on-device digest (kernel counter
bank, "state_digest") must equal the journaled one bit for bit; any
mismatch is a divergence, counted on ``nf_replay_divergences_total``.

Counterpart of ``noahgameframe_tpu/replay/replayer.py``, over the port's
GameRole (``make_offline_role`` takes a ``device``).  The journal format
is the JAX package's, so a journal recorded by either package replays
through either package's role.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..game.world import GameWorld
from ..net.defines import ServerType
from ..net.roles.base import RoleConfig
from ..net.roles.game import GameRole
from ..net.transport import NetEvent
from .journal import (
    JournalReader,
    JournalError,
    REC_CKPT,
    REC_EVENT,
    REC_META,
    REC_NOTE,
    REC_TICK,
    SRC_SERVER,
    decode_event,
    decode_tick,
)


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one replay pass."""

    start_tick: int
    ticks_replayed: int = 0
    events_fed: int = 0
    # tick -> uint32 digest: what replay computed vs what was journaled
    digests: Dict[int, int] = dataclasses.field(default_factory=dict)
    expected: Dict[int, int] = dataclasses.field(default_factory=dict)
    divergences: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )  # (tick, expected, got)
    notes: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.ticks_replayed > 0 and not self.divergences

    @property
    def first_divergence(self) -> Optional[int]:
        return self.divergences[0][0] if self.divergences else None

    def summary(self) -> str:
        if self.ok:
            return (f"REPLAY OK: {self.ticks_replayed} ticks from "
                    f"{self.start_tick}, {self.events_fed} events, "
                    f"all digests bit-identical")
        if not self.ticks_replayed:
            return f"REPLAY EMPTY: no journaled ticks past {self.start_tick}"
        t, want, got = self.divergences[0]
        return (f"REPLAY DIVERGED at tick {t}: journal {want:#010x} vs "
                f"replay {got:#010x} ({len(self.divergences)} of "
                f"{self.ticks_replayed} ticks differ)")


def make_offline_role(world: Optional[GameWorld] = None, server_id: int = 6,
                      name: str = "Replay", backend: str = "auto",
                      device=None) -> GameRole:
    """A GameRole with no upstreams and swallowed sends — the handler
    tables and tick loop are real, the network is inert.  Build it with
    the SAME world recipe (and kwargs that shape handlers) as the
    recorded role, or the handlers won't compute the same mutations."""
    role = GameRole(
        RoleConfig(server_id, int(ServerType.GAME), name, "127.0.0.1", 0,
                   targets=[]),
        backend=backend,
        world=world,
        device=device,
    )
    # replies/broadcasts target connections that only existed in the
    # recorded run; swallow them (the recorded role's sends are outputs,
    # not inputs — they cannot affect device state)
    role.server.send_raw = lambda _conn, _msg, _body: True
    return role


def _drive_tick(role: GameRole) -> None:
    """GameRole.execute()'s exact tick block, minus the wall-clock gate
    (chaos_smoke drives its control world identically)."""
    pm = role.game_world.pm
    for m in pm.modules.values():
        if m is not role.kernel:
            m.execute()
    role.kernel.execute()
    role.kernel.tick()
    pm.frame += 1
    # no clients: drop the sync accumulators a live role would flush
    role._changed.clear()
    role._rec_changed.clear()
    role._interest_dirty.clear()


def replay_journal(
    journal_dir,
    world_factory: Optional[Callable[[], GameWorld]] = None,
    checkpoint=None,
    role: Optional[GameRole] = None,
    upto: Optional[int] = None,
    perturb: Optional[Callable[[GameRole, int], None]] = None,
) -> ReplayReport:
    """Replay `journal_dir` and verify every per-tick digest.

    - `role` or `world_factory` provides the substrate (same recipe as
      the recorded role); with neither, the stock GameRole world is
      built — right only for roles started with the stock world.
    - `checkpoint` (a persist.checkpoint directory) positions the world;
      journaled ticks at or before its tick are skipped, the rest must
      be contiguous from it.
    - `upto` stops after that tick (bisect replays a prefix).
    - `perturb(role, tick)` runs before each tick — divergence-injection
      hook for tests and for what-if debugging.

    Returns a :class:`ReplayReport`; divergences also increment the
    role's ``nf_replay_divergences_total``.
    """
    reader = JournalReader(journal_dir)
    if role is None:
        role = make_offline_role(
            world_factory() if world_factory is not None else None
        )
    k = role.kernel
    # the recorded role pinned its guid allocator at journal setup (the
    # seed is in the meta); pin ours to the same point so every replayed
    # create mints the exact recorded guid — handlers keyed by
    # wire-carried guids (the switch ack's destroy) depend on it
    guid_seed = reader.meta.get("guid_seed")
    if guid_seed is not None:
        k.store.guids.pin(int(guid_seed))
    k.enable_digest()
    if checkpoint is not None and (Path(checkpoint) / "meta.json").exists():
        role.game_world.load(checkpoint)
    report = ReplayReport(start_tick=k.tick_count)
    div_counter = role.telemetry.registry.counter(
        "nf_replay_divergences_total",
        "replayed ticks whose state digest differed from the journal",
    )
    pending: List[Tuple[int, int, int, int, bytes]] = []
    for rec_type, body in reader:
        if rec_type == REC_EVENT:
            pending.append(decode_event(body))
        elif rec_type == REC_TICK:
            tick, want = decode_tick(body)
            if tick <= report.start_tick:
                # this window's effects are already inside the checkpoint
                pending.clear()
                continue
            if upto is not None and tick > upto:
                break
            if tick != k.tick_count + 1:
                raise JournalError(
                    f"journal tick {tick} is not contiguous with world "
                    f"tick {k.tick_count} — wrong checkpoint for this "
                    f"journal suffix?"
                )
            for source, conn_id, kind, msg_id, payload in pending:
                dispatch = (role.server.dispatch if source == SRC_SERVER
                            else role.world_link.dispatch)
                dispatch.feed([NetEvent(kind, conn_id, msg_id, payload)])
                report.events_fed += 1
            pending.clear()
            if perturb is not None:
                perturb(role, tick)
            _drive_tick(role)
            got = k.last_counters.get("state_digest", 0) & 0xFFFFFFFF
            report.digests[tick] = got
            report.expected[tick] = want
            report.ticks_replayed += 1
            if got != want:
                report.divergences.append((tick, want, got))
                div_counter.inc()
        elif rec_type == REC_NOTE:
            from .journal import decode_json

            report.notes.append(decode_json(body))
        elif rec_type in (REC_META, REC_CKPT):
            continue
    return report
