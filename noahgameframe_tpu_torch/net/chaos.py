"""Deterministic fault injection at the transport seam.

`FaultyTransport` wraps any transport from :mod:`net.transport` (client
or server side — it proxies both `send_msg` and `send(conn_id, ...)`)
and injects message-level faults on the way out and on the way in:
drops, duplicates, delays (measured in poll ticks), payload truncation/
corruption, connection refusal, and directional partitions.  All
decisions come from one per-link `random.Random` seeded from
``(plan.seed, link name)``, so the same plan over the same message
sequence yields a byte-identical fault sequence — chaos tests are
reproducible, not merely "usually pass".

Design notes:

- Faults apply to *message bodies*, never to frame headers: the wrapper
  sits above the framing layer, so a corrupted body exercises handler
  fault isolation (`_Dispatch._safe`) while the stream stays parseable.
  Frame-level garbage is a different failure class, covered directly by
  the `FrameDecoder` fuzz in ``tests/test_wire_fuzz.py``.
- The wrapper's clock is its poll count (one tick per ``poll()`` call),
  not wall time: partition windows and delay durations are scheduleable
  in tests without sleeping.
- Partitions drop established-link messages only; EV_CONNECTED /
  EV_DISCONNECTED pass through (a real partition stalls traffic, it
  does not synthesize socket closes).  Use ``refuse`` to fault the
  connect path itself.
- Per-link counts, the fault log, AND the rng live *outside* the
  wrapper (see :class:`ChaosDirector`): every re-dial builds a fresh
  transport + wrapper, and both the failure budget and the random
  sequence must survive that — a restarted rng would re-roll the same
  outcome on every connect attempt (``refuse`` would be all-or-nothing
  per link instead of a probability).

A copy of ``noahgameframe_tpu/net/chaos.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import random
import time as _time
import zlib
from typing import Dict, List, Optional, Tuple

from .transport import EV_CONNECTED, EV_DISCONNECTED, EV_MSG, NetEvent


class StoreFaultError(ConnectionError):
    """Injected store failure (the write-behind flusher retries these
    exactly like a real connection error)."""


@dataclasses.dataclass
class LinkFaults:
    """Per-link fault probabilities (each applied per message per
    direction) + scheduled partitions."""

    drop: float = 0.0       # message silently discarded
    dup: float = 0.0        # message delivered twice
    delay: float = 0.0      # message held for `delay_polls` ticks
    delay_polls: int = 3
    truncate: float = 0.0   # body cut at a random offset
    corrupt: float = 0.0    # one body byte flipped
    refuse: float = 0.0     # EV_CONNECTED turned into a disconnect
    # refuse connects until the link's refuse count reaches this floor —
    # a *deterministic* retry exercise (the budget lives in the shared
    # counts, so it survives re-dials and then the link heals for good)
    refuse_first: int = 0
    # (start_tick, end_tick, direction) windows; direction is one of
    # "in", "out", "both".  Ticks are poll counts on this link.
    partitions: Tuple[Tuple[int, int, str], ...] = ()

    def any(self) -> bool:
        return bool(self.drop or self.dup or self.delay or self.truncate
                    or self.corrupt or self.refuse or self.refuse_first
                    or self.partitions)


@dataclasses.dataclass
class StoreFaults:
    """Per-store-link fault schedule for the persistence flush path.

    The clock here is the link's *operation count* (one tick per store
    call), mirroring how transport faults use poll counts: schedules
    stay deterministic without wall time.  Probabilistic faults draw
    from the same shared per-link rng the director owns, so budgets and
    sequences survive pipeline rebuilds on revive exactly like
    transport wrappers survive re-dials."""

    fail: float = 0.0        # store call raises StoreFaultError
    # refuse the first N calls outright — the deterministic retry
    # exercise (budget lives in the shared counts, then heals for good)
    fail_first: int = 0
    latency: float = 0.0     # store call sleeps `latency_s` first
    latency_s: float = 0.05  # flusher-thread sleep; never the tick path
    # [start_op, end_op) windows where the store is down hard
    down: Tuple[Tuple[int, int], ...] = ()

    def any(self) -> bool:
        return bool(self.fail or self.fail_first or self.latency
                    or self.down)


@dataclasses.dataclass
class FaultPlan:
    """A seeded schedule of per-link faults.

    ``links`` maps a *pattern* to its faults; a pattern matches any link
    whose name contains it (link names look like ``game6.world->7``), so
    one entry can target a pool ("proxy5.games") or a single peer.
    First matching pattern (insertion order) wins; unmatched links get
    ``default``."""

    seed: int = 0
    links: Dict[str, LinkFaults] = dataclasses.field(default_factory=dict)
    default: LinkFaults = dataclasses.field(default_factory=LinkFaults)
    # store links (names look like "game6.store") follow the same
    # pattern-match discipline as message links
    stores: Dict[str, StoreFaults] = dataclasses.field(default_factory=dict)
    store_default: StoreFaults = dataclasses.field(
        default_factory=StoreFaults)

    def for_link(self, link: str) -> LinkFaults:
        for pattern, faults in self.links.items():
            if pattern in link:
                return faults
        return self.default

    def for_store(self, link: str) -> StoreFaults:
        for pattern, faults in self.stores.items():
            if pattern in link:
                return faults
        return self.store_default


class FaultyTransport:
    """Transport wrapper applying a `FaultPlan` to one link.

    Everything not intercepted (connect/close/connected/port/…)
    delegates to the wrapped transport, so the wrapper drops into
    `NetClientModule`/`NetServerModule` unchanged.
    """

    def __init__(self, inner, link: str, plan: FaultPlan,
                 counts: Optional[Dict[str, int]] = None,
                 log: Optional[list] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.inner = inner
        self.link = str(link)
        self.faults = plan.for_link(self.link)
        # the rng may be shared across re-dials (ChaosDirector passes a
        # per-link one): a fresh wrapper restarting the sequence would
        # re-roll the SAME outcome on every connect attempt — refuse=0.25
        # becomes either never or a permanent livelock
        self.rng = rng if rng is not None else random.Random(
            (int(plan.seed) * 1000003) ^ zlib.crc32(self.link.encode())
        )
        self.counts = counts if counts is not None else {}
        self.log = log
        self.tick = 0
        self._delayed_out: List[Tuple[int, object]] = []  # (due, thunk)
        self._delayed_in: List[Tuple[int, NetEvent]] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ------------------------------------------------------- bookkeeping
    def _count(self, kind: str, msg_id: int = 0) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.log is not None:
            self.log.append((self.tick, self.link, kind, int(msg_id)))

    def _partitioned(self, direction: str) -> bool:
        for start, end, d in self.faults.partitions:
            if start <= self.tick < end and d in (direction, "both"):
                return True
        return False

    def _mangle(self, body: bytes, msg_id: int) -> bytes:
        f, r = self.faults, self.rng
        if body and f.truncate and r.random() < f.truncate:
            self._count("truncate", msg_id)
            body = body[: r.randrange(len(body))]
        if body and f.corrupt and r.random() < f.corrupt:
            self._count("corrupt", msg_id)
            i = r.randrange(len(body))
            body = body[:i] + bytes([body[i] ^ (1 + r.randrange(255))]) + body[i + 1:]
        return body

    # ------------------------------------------------------- send path
    def send_msg(self, msg_id: int, body: bytes) -> bool:
        return self._send_out(
            lambda b: self.inner.send_msg(msg_id, b), msg_id, body
        )

    def send(self, conn_id: int, msg_id: int, body: bytes) -> bool:
        return self._send_out(
            lambda b: self.inner.send(conn_id, msg_id, b), msg_id, body
        )

    def _send_out(self, deliver, msg_id: int, body: bytes) -> bool:
        f, r = self.faults, self.rng
        if self._partitioned("out"):
            self._count("partition_out", msg_id)
            return True  # swallowed; the sender sees a healthy link
        if f.drop and r.random() < f.drop:
            self._count("drop_out", msg_id)
            return True
        body = self._mangle(body, msg_id)
        copies = 1
        if f.dup and r.random() < f.dup:
            self._count("dup_out", msg_id)
            copies = 2
        if f.delay and r.random() < f.delay:
            self._count("delay_out", msg_id)
            due = self.tick + max(1, int(f.delay_polls))
            for _ in range(copies):
                self._delayed_out.append((due, lambda b=body: deliver(b)))
            return True
        ok = True
        for _ in range(copies):
            ok = deliver(body) and ok
        return ok

    # ------------------------------------------------------- poll path
    def poll(self) -> List[NetEvent]:
        self.tick += 1
        # release due delayed traffic first: a delayed message must not
        # overtake one delayed earlier (list order is arrival order)
        still = []
        for due, thunk in self._delayed_out:
            if due <= self.tick:
                thunk()
            else:
                still.append((due, thunk))
        self._delayed_out = still
        ready = [ev for due, ev in self._delayed_in if due <= self.tick]
        self._delayed_in = [
            (due, ev) for due, ev in self._delayed_in if due > self.tick
        ]
        out: List[NetEvent] = list(ready)
        f, r = self.faults, self.rng
        for ev in self.inner.poll():
            if ev.kind == EV_CONNECTED and (
                (f.refuse_first
                 and self.counts.get("refuse", 0) < int(f.refuse_first))
                or (f.refuse and r.random() < f.refuse)
            ):
                # connection refused: tear the link down instead of
                # admitting it — exercises the RetryPolicy path
                self._count("refuse")
                self.inner.disconnect()
                out.append(NetEvent(EV_DISCONNECTED, ev.conn_id))
                continue
            if ev.kind != EV_MSG:
                out.append(ev)
                continue
            if self._partitioned("in"):
                self._count("partition_in", ev.msg_id)
                continue
            if f.drop and r.random() < f.drop:
                self._count("drop_in", ev.msg_id)
                continue
            body = self._mangle(ev.body, ev.msg_id)
            ev = NetEvent(EV_MSG, ev.conn_id, ev.msg_id, body)
            copies = 1
            if f.dup and r.random() < f.dup:
                self._count("dup_in", ev.msg_id)
                copies = 2
            if f.delay and r.random() < f.delay:
                self._count("delay_in", ev.msg_id)
                due = self.tick + max(1, int(f.delay_polls))
                for _ in range(copies):
                    self._delayed_in.append((due, ev))
                continue
            for _ in range(copies):
                out.append(ev)
        return out


class FaultyStore:
    """Write-behind store backend wrapper applying :class:`StoreFaults`
    to one store link.

    Sits where the flusher thread talks to the store (the
    ``StoreBackend`` seam in :mod:`persist.writebehind`): ``write`` /
    ``delete`` pass through the fault schedule; everything else
    delegates.  Injected latency sleeps on the *flusher* thread — the
    whole point of write-behind is that this never reaches the tick,
    and the persist smoke asserts exactly that.
    """

    def __init__(self, inner, link: str, plan: FaultPlan,
                 counts: Optional[Dict[str, int]] = None,
                 log: Optional[list] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.inner = inner
        self.link = str(link)
        self.faults = plan.for_store(self.link)
        self.rng = rng if rng is not None else random.Random(
            (int(plan.seed) * 1000003) ^ zlib.crc32(self.link.encode())
        )
        self.counts = counts if counts is not None else {}
        self.log = log

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.log is not None:
            self.log.append((self.counts.get("store_op", 0), self.link,
                             kind, 0))

    def _down(self, op: int) -> bool:
        return any(a <= op < b for a, b in self.faults.down)

    def _guard(self) -> None:
        f, r = self.faults, self.rng
        op = self.counts.get("store_op", 0)
        self.counts["store_op"] = op + 1
        if self._down(op):
            self._count("store_down")
            raise StoreFaultError(f"{self.link}: store down (op {op})")
        if f.fail_first and self.counts.get("store_fail", 0) < int(
                f.fail_first):
            self._count("store_fail")
            raise StoreFaultError(f"{self.link}: refused (first-N budget)")
        if f.fail and r.random() < f.fail:
            self._count("store_fail")
            raise StoreFaultError(f"{self.link}: injected write failure")
        if f.latency and r.random() < f.latency:
            self._count("store_latency")
            _time.sleep(max(0.0, float(f.latency_s)))

    def write(self, key: str, blob: bytes) -> None:
        self._guard()
        return self.inner.write(key, blob)

    def delete(self, key: str) -> None:
        self._guard()
        return self.inner.delete(key)

    def ping(self) -> bool:
        if self._down(self.counts.get("store_op", 0)):
            return False
        return self.inner.ping()


class ChaosDirector:
    """One per cluster: wraps transports and owns the per-link fault
    counts + logs so they survive transport rebuilds (every reconnect
    dial creates a fresh client)."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.counts: Dict[str, Dict[str, int]] = {}
        self.logs: Dict[str, list] = {}
        self.rngs: Dict[str, random.Random] = {}
        # every live wrapper, so heal() can flip faults off mid-run
        # (a re-dial's fresh wrapper re-reads the — by then healed — plan)
        self._live: List[Tuple[str, object]] = []

    def wrap(self, transport, link: str) -> FaultyTransport:
        link = str(link)
        w = FaultyTransport(
            transport, link, self.plan,
            counts=self.counts.setdefault(link, {}),
            log=self.logs.setdefault(link, []),
            rng=self.rngs.setdefault(link, random.Random(
                (int(self.plan.seed) * 1000003) ^ zlib.crc32(link.encode())
            )),
        )
        self._live.append((link, w))
        return w

    def wrap_store(self, backend, link: str) -> FaultyStore:
        """Wrap a write-behind store backend the same way `wrap` wraps
        a transport: counts/log/rng live here, so a revived game role's
        rebuilt pipeline continues the SAME fault schedule (op counts
        and first-N budgets do not reset)."""
        link = str(link)
        # re-wrap guard: revive_role re-runs the chaos hookup, and a
        # drill may apply_chaos more than once — if the backend is
        # already this link's wrapper, wrap its INNER store instead of
        # nesting (a nested pair would double-advance the shared op
        # clock per call and replay consumed down-windows against the
        # second count)
        while isinstance(backend, FaultyStore) and backend.link == link:
            backend = backend.inner
        w = FaultyStore(
            backend, link, self.plan,
            counts=self.counts.setdefault(link, {}),
            log=self.logs.setdefault(link, []),
            rng=self.rngs.setdefault(link, random.Random(
                (int(self.plan.seed) * 1000003) ^ zlib.crc32(link.encode())
            )),
        )
        self._live.append((link, w))
        return w

    def heal(self, pattern: Optional[str] = None) -> int:
        """Turn faults OFF for every link whose name contains `pattern`
        (all links when None), effective immediately on live wrappers
        and on any future re-dial/re-wrap.  Returns how many distinct
        links went from faulted to clean — so the call is idempotent:
        a second identical heal returns 0 and changes nothing.

        This is the failover-drill shape: inject faults
        through the kill window, then heal and assert the cluster
        actually converges — a plan that stays hostile forever can mask
        a recovery path that never finishes.  Counts/logs/rngs are
        kept; only the schedules reset.  That makes heal safe
        mid-campaign: a `revive_role` re-wrap that races the
        heal reads the already-healed plan, and because the op clocks
        and first-N budgets live in the shared counts, re-arming faults
        later (:meth:`set_store_faults`) cannot resurrect a consumed
        fault window."""
        if pattern is None:
            self.plan.links.clear()
            self.plan.default = LinkFaults()
            self.plan.stores.clear()
            self.plan.store_default = StoreFaults()
        else:
            self.plan.links = {p: f for p, f in self.plan.links.items()
                               if p not in pattern and pattern not in p}
            self.plan.stores = {p: f for p, f in self.plan.stores.items()
                                if p not in pattern and pattern not in p}
        healed = set()
        for link, w in self._live:
            if pattern is not None and pattern not in link:
                continue
            if w.faults.any():
                healed.add(link)
            w.faults = (StoreFaults() if isinstance(w, FaultyStore)
                        else LinkFaults())
        return len(healed)

    # -------------------------------------------------- live re-arming
    def set_link_faults(self, pattern: str, faults: LinkFaults) -> int:
        """Arm (or re-arm) transport faults mid-campaign: the plan entry
        is upserted (future re-dials see it) AND every live transport
        wrapper whose link contains `pattern` switches to `faults`
        immediately.  Returns how many live links were re-armed.

        Budgets stay consumed: refuse_first counts etc. live in the
        shared per-link counts, so re-arming an already-exhausted
        schedule does not restart it."""
        pattern = str(pattern)
        self.plan.links[pattern] = faults
        touched = set()
        for link, w in self._live:
            if isinstance(w, FaultyTransport) and pattern in link:
                w.faults = faults
                touched.add(link)
        return len(touched)

    def set_store_faults(self, pattern: str, faults: StoreFaults) -> int:
        """Store-side twin of :meth:`set_link_faults` — the campaign
        primitive behind scheduled store outages.  Op clocks and
        first-N budgets live in the shared counts, so a re-armed
        schedule continues from the link's current op count; a consumed
        ``fail_first`` budget or passed ``down`` window stays consumed."""
        pattern = str(pattern)
        self.plan.stores[pattern] = faults
        touched = set()
        for link, w in self._live:
            if isinstance(w, FaultyStore) and pattern in link:
                w.faults = faults
                touched.add(link)
        return len(touched)

    def total(self, kind: Optional[str] = None) -> int:
        return sum(
            v
            for per_link in self.counts.values()
            for k, v in per_link.items()
            if kind is None or k == kind
        )

    def store_phase(self) -> Dict[str, dict]:
        """Per-store-link fault *phase*: where each
        store link's op clock sits relative to its schedule — ops seen,
        remaining first-N fail budget, the active/upcoming down windows
        — so drills and operators can assert the current fault phase
        from master `/json` instead of inferring it from side effects.

        The effective schedule is read from the newest live wrapper
        (live re-arming via :meth:`set_store_faults` lands there first)
        and falls back to the plan for links awaiting a re-wrap."""
        current: Dict[str, StoreFaults] = {}
        for link, w in self._live:
            if isinstance(w, FaultyStore):
                current[link] = w.faults  # latest wrapper wins
        links = set(current) | {
            link for link, c in self.counts.items() if "store_op" in c
        }
        phases: Dict[str, dict] = {}
        for link in sorted(links):
            c = self.counts.get(link, {})
            op = int(c.get("store_op", 0))
            f = current.get(link)
            if f is None:
                f = self.plan.for_store(link)
            active = None
            remaining = 0
            for a, b in f.down:
                if a <= op < b:
                    active = [int(a), int(b)]
                    remaining = int(b) - op
                    break
            phases[link] = {
                "ops_seen": op,
                "fails_injected": int(c.get("store_fail", 0)),
                "downs_hit": int(c.get("store_down", 0)),
                "latencies_injected": int(c.get("store_latency", 0)),
                "fail_first_remaining": (
                    max(0, int(f.fail_first) - int(c.get("store_fail", 0)))
                    if f.fail_first else 0
                ),
                "fail_p": float(f.fail),
                "latency_p": float(f.latency),
                "latency_s": float(f.latency_s),
                "down_active": active,
                "down_remaining_ops": remaining,
                "down_upcoming": [[int(a), int(b)] for a, b in f.down
                                  if op < a],
            }
        return phases

    def status(self) -> dict:
        """The plan spelled out for operators: seed + per-link fault
        budgets (the FaultPlan patterns) + live injected counts + the
        store links' op-clock phase.  The master mounts this on /json
        and game roles journal it, so any chaos run can be re-derived
        exactly for replay."""
        return {
            "seed": int(self.plan.seed),
            "links": {
                pattern: dataclasses.asdict(faults)
                for pattern, faults in self.plan.links.items()
            },
            "default": dataclasses.asdict(self.plan.default),
            "stores": {
                pattern: dataclasses.asdict(faults)
                for pattern, faults in self.plan.stores.items()
            },
            "store_default": dataclasses.asdict(self.plan.store_default),
            "store_phase": self.store_phase(),
            "counts": {link: dict(c) for link, c in self.counts.items()},
        }
