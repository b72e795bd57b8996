"""Cluster invariants sampled every drill pump.

Each checker is a small stateful object: :meth:`Invariant.check` gets a
:class:`DrillContext` (cluster + drill tick + pump timestamp) and
returns a list of human-readable violation details — empty when the
invariant holds.  Checkers keep their own baselines (previous lease map,
previous watermarks, unbound-session streaks) so a single runner
instance observes *transitions*, not just states.

The library:

- :class:`NoSilentDrop` — every session that loses its game binding
  hears about it (a REHOMING/BUSY/DROPPED notice); dropped parked
  frames are never silent.
- :class:`LegalLeaseTransitions` — master lease strings only move along
  UP→SUSPECT→DOWN (plus recovery back to UP); no teleporting.
- :class:`MonotoneWatermarks` — WAL flush watermarks never move
  backwards per store key, across kills, revives, and outages.
- :class:`BoundedFailoverLag` — the oldest pending re-home never
  outlives ``NF_FAILOVER_DEADLINE_S`` (+ slack for the pump quantum).
- :class:`OrderedReplay` — parked-frame replay preserves per-session
  arrival order (fed by :class:`net.failover.ParkingBuffer`'s seq
  audit).
- :class:`ConsistentCounters` — the failover/parking telemetry bank is
  conserved: ``initiated == completed + deadline_exceeded + pending``
  and ``parked == replayed + dropped + still-parked``.
  (``nf_failover_busy_total`` counts placement *rounds*, not
  sessions, so the conserved session-count identity uses the pending
  gauge; busy is separately required to be monotone.)

Two checkers cover the mesh and the rooms:

- :class:`StableUnderReshard` — the elastic mesh never drops a row and
  stays digest-identical to a static-mesh control.
- :class:`RoomIsolation` — in the many-worlds room engine, a room's
  digest moves only in lockstep with its own isolated control world;
  faults in room j never perturb room i.

Checkers read cluster state defensively (``getattr`` with fallbacks) so
violation tests can feed them minimal forged stand-ins.

This module is tick-indexed like the schedules: it must not reference
the ``time`` module.

A copy of ``noahgameframe_tpu/drill/invariants.py``, which imports no jax: the
port keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..net.defines import SwitchNoticeCode


@dataclasses.dataclass(frozen=True)
class DrillContext:
    """What a checker sees each sample: the cluster under drill, the
    drill tick, and the pump pass's monotonic timestamp (taken once by
    the runner so every checker in a sample shares one clock read)."""

    cluster: object
    tick: int
    now: float


class Invariant:
    """Base checker; subclasses set ``name`` and implement ``check``."""

    name = "invariant"

    def check(self, ctx: DrillContext) -> List[str]:
        raise NotImplementedError


class NoSilentDrop(Invariant):
    """No session is ever silently dropped.

    Two clauses, both over the proxy edge:

    1. If any parked frames were dropped for a *live* client (overflow
       or deadline — disconnect drops have no receiver to notify), at
       least one DROPPED notice must have been pushed.
    2. A client whose bound game has vanished from the proxy's routed
       set for ``grace_samples`` consecutive samples must have received
       at least one switch notice (REHOMING/BUSY/DROPPED).  The grace
       covers the push-ordering window between the world's game-list
       update and the notice fan-out.
    """

    name = "no_silent_drop"

    def __init__(self, grace_samples: int = 25) -> None:
        self.grace_samples = max(1, int(grace_samples))
        self._streak: Dict[object, int] = {}

    def check(self, ctx: DrillContext) -> List[str]:
        proxy = ctx.cluster.proxy
        out: List[str] = []
        parking = proxy.parking
        loud_drops = (int(parking.dropped_overflow)
                      + int(parking.dropped_deadline))
        notices = getattr(proxy, "notice_counts", {})
        if loud_drops and not notices.get(int(SwitchNoticeCode.DROPPED), 0):
            out.append(f"{loud_drops} parked frames dropped with zero "
                       "DROPPED notices sent")
        live = set(getattr(proxy.games, "servers", {}))
        per_conn = getattr(proxy, "conn_notices", {})
        for conn_id, info in dict(proxy._conn_info).items():
            gid = info.get("game_id")
            if gid is None or int(gid) in live:
                self._streak.pop(conn_id, None)
                continue
            streak = self._streak.get(conn_id, 0) + 1
            self._streak[conn_id] = streak
            if streak >= self.grace_samples and not per_conn.get(conn_id):
                out.append(
                    f"conn {conn_id} unbound from dead game {gid} for "
                    f"{streak} samples with no switch notice"
                )
        return out


class LegalLeaseTransitions(Invariant):
    """Master lease strings move only along the legal machine:
    UP→SUSPECT, SUSPECT→DOWN, and recovery SUSPECT→UP / DOWN→UP.

    UP→DOWN is tolerated only when a recent inter-sample gap exceeds
    the SUSPECT window itself (the pump, not the state machine, stalled
    through the intermediate state).  The *two* most recent gaps are
    considered: the master sweeps at the top of a pump pass and we
    sample at the bottom, so a stall late in pass N (inside our
    N-1→N gap) surfaces as a lease jump at sweep N+1 — one sample
    after the gap that explains it."""

    name = "legal_lease_transitions"
    LEGAL = {("UP", "SUSPECT"), ("SUSPECT", "DOWN"),
             ("SUSPECT", "UP"), ("DOWN", "UP")}

    def __init__(self) -> None:
        self._prev: Dict[Tuple[int, int], str] = {}
        self._prev_now: Optional[float] = None
        self._prev_gap = 0.0

    def check(self, ctx: DrillContext) -> List[str]:
        master = ctx.cluster.master
        out: List[str] = []
        suspect_window = max(
            0.0,
            float(getattr(master, "lease_down_seconds", 0.0))
            - float(getattr(master, "lease_suspect_seconds", 0.0)),
        )
        gap = (ctx.now - self._prev_now
               if self._prev_now is not None else 0.0)
        coarse = suspect_window > 0.0 and max(gap, self._prev_gap) > suspect_window
        for stype, by_id in master.registry.items():
            for sid, reg in by_id.items():
                key = (int(stype), int(sid))
                cur = str(reg.lease)
                prev = self._prev.get(key)
                self._prev[key] = cur
                if prev is None or prev == cur:
                    continue
                if (prev, cur) in self.LEGAL:
                    continue
                if (prev, cur) == ("UP", "DOWN") and coarse:
                    continue  # sampler skipped SUSPECT, machine did not
                out.append(f"server type={stype} id={sid} lease jumped "
                           f"{prev}->{cur}")
        self._prev_gap = gap
        self._prev_now = ctx.now
        return out


class MonotoneWatermarks(Invariant):
    """WAL flush watermarks never move backwards per store key.

    Default probe: every live game role's write-behind pipeline
    (``wal:<name>`` → its WAL's ``(flushed_seq, flushed_tick)``).  An
    optional ``store_probe`` adds store-side keys (e.g. the
    ``__wb__:<name>`` watermark blobs in the shared KV) so the check
    spans the full staging→flush path.

    Keys are allowed to *disappear* (a killed role) — the baseline is
    kept, so a revived pipeline that restarts below its old watermark
    is caught the moment it reports again."""

    name = "monotone_watermarks"

    def __init__(self, store_probe: Optional[
            Callable[[], Dict[str, Tuple[int, int]]]] = None) -> None:
        self.store_probe = store_probe
        self._prev: Dict[str, Tuple[int, int]] = {}

    def _marks(self, ctx: DrillContext) -> Dict[str, Tuple[int, int]]:
        marks: Dict[str, Tuple[int, int]] = {}
        for game in list(getattr(ctx.cluster, "games", ())):
            pipeline = getattr(game, "persist", None)
            if pipeline is None:
                continue
            marks[f"wal:{pipeline.name}"] = (
                int(pipeline.wal.flushed_seq),
                int(pipeline.wal.flushed_tick),
            )
        if self.store_probe is not None:
            for key, mark in self.store_probe().items():
                marks[str(key)] = (int(mark[0]), int(mark[1]))
        return marks

    def check(self, ctx: DrillContext) -> List[str]:
        out: List[str] = []
        for key, (seq, tick) in self._marks(ctx).items():
            pseq, ptick = self._prev.get(key, (-1, -1))
            if seq < pseq or (seq == pseq and tick < ptick):
                out.append(f"watermark {key} moved backwards: "
                           f"{pseq}:{ptick} -> {seq}:{tick}")
            else:
                self._prev[key] = (seq, tick)
        return out


class BoundedFailoverLag(Invariant):
    """The oldest pending re-home never outlives the failover deadline
    (+ slack for the pump quantum: the driver expires at deadline on its
    next pump, so lag can legitimately overshoot by one pass)."""

    name = "bounded_failover_lag"

    def __init__(self, slack_s: float = 1.0) -> None:
        self.slack_s = float(slack_s)

    def check(self, ctx: DrillContext) -> List[str]:
        driver = getattr(ctx.cluster.world, "failover", None)
        if driver is None:
            return []
        lag = float(driver.lag(ctx.now))
        bound = float(driver.deadline_s) + self.slack_s
        if lag > bound:
            return [f"failover lag {lag:.3f}s exceeds deadline "
                    f"{driver.deadline_s:.3f}s + {self.slack_s:.3f}s slack"]
        return []


class OrderedReplay(Invariant):
    """Parked-frame replay preserves per-session arrival order.

    The :class:`net.failover.ParkingBuffer` stamps every parked frame
    with a global sequence number and audits replay order itself
    (``order_violations``); this checker surfaces any *new* breach at
    the tick it happened."""

    name = "ordered_replay"

    def __init__(self) -> None:
        self._reported = 0

    def check(self, ctx: DrillContext) -> List[str]:
        total = int(ctx.cluster.proxy.parking.order_violations)
        if total > self._reported:
            fresh = total - self._reported
            self._reported = total
            return [f"{fresh} parked frame(s) replayed out of per-session "
                    "arrival order"]
        return []


class ConsistentCounters(Invariant):
    """The failover/parking telemetry bank stays conserved:

    - sessions: ``nf_failover_initiated_total == completed +
      deadline_exceeded + pending`` (every initiated re-home is exactly
      one of finished, abandoned, or still in flight);
    - frames: ``parked_total == replayed_total + dropped_total +
      depth()`` on the parking buffer;
    - ``nf_failover_busy_total`` (placement rounds) is monotone."""

    name = "consistent_counters"

    def __init__(self) -> None:
        self._prev_busy = 0.0

    def check(self, ctx: DrillContext) -> List[str]:
        out: List[str] = []
        world = ctx.cluster.world
        driver = getattr(world, "failover", None)
        if driver is not None:
            reg = world.telemetry.registry
            initiated = reg.value("nf_failover_initiated_total")
            completed = reg.value("nf_failover_completed_total")
            deadline = reg.value("nf_failover_deadline_exceeded_total")
            pending = float(driver.pending_count())
            if initiated != completed + deadline + pending:
                out.append(
                    "failover bank not conserved: initiated="
                    f"{initiated:g} != completed={completed:g} + "
                    f"deadline={deadline:g} + pending={pending:g}"
                )
            busy = reg.value("nf_failover_busy_total")
            if busy < self._prev_busy:
                out.append(f"nf_failover_busy_total went backwards: "
                           f"{self._prev_busy:g} -> {busy:g}")
            else:
                self._prev_busy = busy
        parking = ctx.cluster.proxy.parking
        still = int(parking.depth())
        if int(parking.parked_total) != (int(parking.replayed_total)
                                         + int(parking.dropped_total)
                                         + still):
            out.append(
                "parking bank not conserved: parked="
                f"{parking.parked_total} != replayed="
                f"{parking.replayed_total} + dropped="
                f"{parking.dropped_total} + still_parked={still}"
            )
        return out


class StableUnderReshard(Invariant):
    """The world is bit-stable through mesh topology changes.

    Four clauses, sampled over every game role exposing an ``elastic``
    driver (read defensively — non-elastic games are skipped):

    1. **zero dropped rows** — the migrate protocol's drop counter and
       the reshard ledger must both stay at 0, ever;
    2. **population conserved** — after every completed grow/drain the
       migrating class's live count equals the op's baseline (budget
       overflow strands rows, it never destroys them);
    3. **bounded exodus lag** — a drain's pre-copy empties the evicted
       device's row range within ``exodus_tick_bound`` ticks;
    4. **digest parity** — when a :class:`~..parallel.elastic.
       DigestControl` is given, the live world's placement-invariant
       ``canonical_digest`` equals the single-shard fault-free control
       advanced to the same tick — the mesh may have grown, drained and
       rebalanced in between, the bytes may not differ.
    """

    name = "stable_under_reshard"

    def __init__(self, control=None, digest_every: int = 1) -> None:
        self.control = control
        self.digest_every = max(1, int(digest_every))
        self._digest_checks = 0
        self._last_digest_tick = -1

    def check(self, ctx: DrillContext) -> List[str]:
        out: List[str] = []
        for game in list(getattr(ctx.cluster, "games", ())):
            el = getattr(game, "elastic", None)
            if el is None:
                continue
            st = el.status()
            name = getattr(getattr(game, "config", None), "name", "game")
            if int(st.get("dropped_rows", 0)):
                out.append(f"{name}: reshard dropped "
                           f"{st['dropped_rows']} row(s)")
            inflight = st.get("inflight")
            if inflight is None and int(st.get("resharded_total", 0)):
                pop, base = int(st.get("pop", 0)), int(
                    st.get("pop_baseline", 0))
                if pop != base:
                    out.append(f"{name}: population not conserved across "
                               f"reshard: {base} -> {pop}")
            bound = int(st.get("exodus_tick_bound", 0))
            lag = int(st.get("exodus_ticks", 0))
            if inflight == "drain" and bound and lag > bound:
                out.append(f"{name}: exodus lag {lag} ticks exceeds "
                           f"bound {bound}")
            if self.control is not None:
                tick = int(getattr(getattr(game, "kernel", None),
                                   "tick_count", 0))
                if (tick > self._last_digest_tick
                        and tick >= self.control.tick_count
                        and tick % self.digest_every == 0):
                    self._last_digest_tick = tick
                    self._digest_checks += 1
                    live = el.digest()
                    want = self.control.advance_to(tick)
                    if live is not None and live != want:
                        out.append(
                            f"{name}: canonical digest diverged from "
                            f"static-mesh control at tick {tick}: "
                            f"{live:#x} != {want:#x}")
        return out


class RoomIsolation(Invariant):
    """No cross-room reads in the many-worlds engine.

    For every game role hosting a :class:`~..parallel.rooms.
    RoomDirectory` (read defensively — room-less games are skipped),
    every room with an attached lockstep CONTROL world must digest
    bit-identically to it.  Faults injected into room j — kills, store
    outages, churn, even hostile writes — may change room j, but a
    watched room i's digest can only move in lockstep with its own
    isolated control; any divergence is a cross-room read/write.

    Digesting is a host-side fold over an extracted room, so
    ``sample_every`` bounds the cost: rooms are checked on drill ticks
    where ``tick % sample_every == 0`` and only when the batch actually
    advanced since the last check."""

    name = "room_isolation"

    def __init__(self, sample_every: int = 1) -> None:
        self.sample_every = max(1, int(sample_every))
        self._last_batch_tick: Dict[str, int] = {}

    def check(self, ctx: DrillContext) -> List[str]:
        out: List[str] = []
        if ctx.tick % self.sample_every:
            return out
        for game in list(getattr(ctx.cluster, "games", ())):
            rooms = getattr(game, "rooms", None)
            if rooms is None or not getattr(rooms, "controls", None):
                continue
            name = getattr(getattr(game, "config", None), "name", "game")
            batch_tick = int(getattr(getattr(rooms, "batch", None),
                                     "tick_count", 0))
            if self._last_batch_tick.get(name) == batch_tick:
                continue  # no frames since last sample; digests can't move
            self._last_batch_tick[name] = batch_tick
            for room_id in sorted(rooms.controls):
                if room_id not in getattr(rooms, "rooms", {}):
                    continue  # control outlived the room (destroy raced)
                live = int(rooms.digest(room_id))
                want = int(rooms.control_digest(room_id))
                if live != want:
                    out.append(
                        f"{name}: room {room_id} diverged from its "
                        f"isolated control at batch tick {batch_tick}: "
                        f"{live:#x} != {want:#x} — cross-room leak")
        return out


def default_invariants(
    store_probe: Optional[Callable[[], Dict[str, Tuple[int, int]]]] = None,
    lag_slack_s: float = 1.0,
    grace_samples: int = 25,
) -> List[Invariant]:
    """The full shipped library, fresh state, ready for one runner."""
    return [
        NoSilentDrop(grace_samples=grace_samples),
        LegalLeaseTransitions(),
        MonotoneWatermarks(store_probe=store_probe),
        BoundedFailoverLag(slack_s=lag_slack_s),
        OrderedReplay(),
        ConsistentCounters(),
    ]
