"""Supervised session failover: a game-role CRASH becomes a
bounded latency blip instead of a session loss.

The reference treats re-homing a live player between game servers as a
first-class supervised flow (`NFCWorldNet_ServerModule.cpp:600-830`) but
only when a game ASKS; a crashed game orphans its sessions.  Here the
world drives the same `SWITCH_SERVER_DATA` / `REQ_SWITCH_SERVER` /
`ACK_SWITCH_SERVER` protocol on the dead game's behalf:

1. Every game reports each session's bind metadata to the world
   (SESSION_BIND_NOTIFY sidecar to ACK_ONLINE_NOTIFY): account/name,
   proxy-side client ident, scene/group, and the persist key the
   player's durable blob lives under.
2. When the lease sweep (or socket loss) marks a game CRASH, the
   :class:`FailoverDriver` reconstructs each bound player's blob from
   the newest durable (checkpoint, WAL suffix) pair — the recovery
   path, read-side and read-only via
   :func:`persist.writebehind.read_peer_wal` — falling back to the
   store itself, and stages it to the least-loaded survivor exactly as
   the dead game would have (DATA then REQ on the same conn, so they
   cannot reorder).
3. The target admits the blob through the existing switch-in path and
   acks; the driver intercepts the ack (the origin it names is dead)
   and marks the session re-homed.  A target without capacity answers
   ACK_SWITCH_REFUSED and the driver retries elsewhere with backoff,
   giving up only at ``NF_FAILOVER_DEADLINE_S``.
4. Meanwhile the proxy **parks** (bounded, deadline-capped —
   :class:`ParkingBuffer`) client frames headed for the dead binding
   and replays them in order once the target's re-point lands, so
   in-flight sessions see a stall, not a drop.

Thread contract: everything here runs on the owning role's pump thread.
No sleeps, no blocking I/O on the parking path (the JAX package's
nf-lint ``pump-surface`` rule enforces it there, docs/LINT.md).

A copy of ``noahgameframe_tpu/net/failover.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time as _time
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from .defines import MsgID, ServerState
from .wire import (
    AckSwitchServer,
    Ident,
    ReqSwitchServer,
    SwitchRefused,
    SwitchServerData,
    ident_key as _ident_key,
    wrap,
)

#: SwitchRefused.result codes (TPU-native; 0 is never sent)
REFUSE_BUSY = 1      # target at Player capacity — try another survivor
REFUSE_BAD_BLOB = 2  # staged blob failed to apply (torn in transit)

#: knob defaults (env-overridable; constructor args win over env)
DEADLINE_S_DEFAULT = 10.0
PARK_MAX_FRAMES_DEFAULT = 256


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def ext_map(report) -> Dict[str, str]:
    """A ServerInfoReport's ext key/value list as a str→str map (the
    wire carries bytes); tolerant of missing/empty ext."""
    ext = getattr(report, "server_info_list_ext", None)
    if ext is None or not ext.key:
        return {}

    def s(v):
        return (v.decode("utf-8", "replace")
                if isinstance(v, (bytes, bytearray)) else str(v))

    return {s(k): s(v) for k, v in zip(ext.key, ext.value)}


@dataclasses.dataclass
class SessionInfo:
    """One live session's re-home metadata, as reported by the owning
    game via SESSION_BIND_NOTIFY.  ``selfid``/``client_id`` are
    (svrid, index) ident keys."""

    selfid: Tuple[int, int]
    account: str
    name: str
    client_id: Tuple[int, int]
    scene_id: int
    group_id: int
    save_key: str
    game_id: int


class ParkingBuffer:
    """Bounded, deadline-capped hold queue for client frames whose bound
    game died mid-flight (proxy-owned; keyed by client conn id).

    Two drop disciplines, both counted under
    ``nf_failover_dropped_total``:

    - **overflow** (oldest-drop): a session may park at most
      ``NF_PARK_MAX_FRAMES`` frames; beyond that the oldest go first —
      the newest input is the one the player still cares about.
    - **deadline**: frames parked longer than ``NF_FAILOVER_DEADLINE_S``
      are dropped wholesale — at that point the failover itself has
      given up and replaying stale input would be worse than losing it.

    Replay preserves arrival order per session and stops (leaving the
    remainder parked) the moment a send fails, so a flapping new binding
    cannot reorder or lose the tail.
    """

    def __init__(self, max_frames: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 registry=None) -> None:
        self.max_frames = (max_frames if max_frames is not None
                           else _env_int("NF_PARK_MAX_FRAMES",
                                         PARK_MAX_FRAMES_DEFAULT))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("NF_FAILOVER_DEADLINE_S",
                                           DEADLINE_S_DEFAULT))
        self._q: Dict[object, Deque[Tuple[float, int, bytes, int]]] = {}
        self.parked_total = 0
        self.replayed_total = 0
        self.dropped_overflow = 0
        self.dropped_deadline = 0
        self.dropped_disconnect = 0
        # per-frame arrival stamp + per-key replay audit: the
        # drill's ordered-replay invariant reads `order_violations` every
        # pump, so an ordering bug is caught the tick it happens instead
        # of (maybe) surfacing as a scrambled chat log much later
        self._seq = 0
        self._last_replayed: Dict[object, int] = {}
        self.order_violations = 0
        self._c_parked = self._c_replayed = self._c_dropped = None
        if registry is not None:
            self._c_parked = registry.counter(
                "nf_failover_parked_frames_total",
                "client frames parked while their session re-homed",
            )
            self._c_replayed = registry.counter(
                "nf_failover_replayed_total",
                "parked frames replayed in order to the new binding",
            )
            self._c_dropped = registry.counter(
                "nf_failover_dropped_total",
                "parked frames dropped instead of replayed", ("reason",),
            )

    @property
    def dropped_total(self) -> int:
        return (self.dropped_overflow + self.dropped_deadline
                + self.dropped_disconnect)

    def depth(self, key=None) -> int:
        if key is not None:
            return len(self._q.get(key, ()))
        return sum(len(q) for q in self._q.values())

    def keys(self) -> List[object]:
        return list(self._q)

    def _drop(self, n: int, reason: str) -> None:
        if not n:
            return
        setattr(self, f"dropped_{reason}",
                getattr(self, f"dropped_{reason}") + n)
        if self._c_dropped is not None:
            self._c_dropped.inc(n, reason=reason)

    def park(self, key, msg_id: int, body: bytes, now: float) -> int:
        """Hold one frame for `key`; returns how many OLDEST frames were
        dropped to stay under ``max_frames``."""
        q = self._q.setdefault(key, collections.deque())
        self._seq += 1
        q.append((float(now), int(msg_id), bytes(body), self._seq))
        self.parked_total += 1
        if self._c_parked is not None:
            self._c_parked.inc()
        dropped = 0
        while len(q) > self.max_frames:
            q.popleft()
            dropped += 1
        self._drop(dropped, "overflow")
        return dropped

    def expire(self, now: float) -> int:
        """Drop every frame parked past the deadline; returns the count."""
        dropped = 0
        for key in list(self._q):
            q = self._q[key]
            while q and now - q[0][0] >= self.deadline_s:
                q.popleft()
                dropped += 1
            if not q:
                del self._q[key]
        self._drop(dropped, "deadline")
        return dropped

    def replay(self, key,
               send: Callable[[int, bytes], bool]) -> Tuple[int, bool]:
        """Replay `key`'s parked frames in arrival order through `send`;
        stops at the first failed send (remainder stays parked).
        Returns ``(replayed, drained)``."""
        q = self._q.get(key)
        if not q:
            self._q.pop(key, None)
            return 0, True
        n = 0
        while q:
            _t, msg_id, body, seq = q[0]
            if not send(msg_id, body):
                break
            q.popleft()
            n += 1
            # arrival-order audit: every replayed frame must carry a
            # strictly increasing stamp per session
            if seq <= self._last_replayed.get(key, -1):
                self.order_violations += 1
            else:
                self._last_replayed[key] = seq
        self.replayed_total += n
        if n and self._c_replayed is not None:
            self._c_replayed.inc(n)
        if q:
            return n, False
        self._q.pop(key, None)
        return n, True

    def discard(self, key) -> int:
        """The session itself is gone (client disconnected): drop its
        parked frames; returns the count."""
        q = self._q.pop(key, None)
        self._last_replayed.pop(key, None)
        n = len(q) if q else 0
        self._drop(n, "disconnect")
        return n


@dataclasses.dataclass
class _Pending:
    info: SessionInfo
    blob: bytes
    basis: str              # "wal" | "store" | "none"
    started: float
    next_try: float
    target: int = 0
    attempts: int = 0
    tried: Set[int] = dataclasses.field(default_factory=set)


class FailoverDriver:
    """World-owned re-home driver: turns `_mark_dead` orphans into
    staged switches on surviving games (module docstring has the full
    protocol walk)."""

    def __init__(self, world, recover_store=None,
                 deadline_s: Optional[float] = None,
                 retry_s: float = 0.5) -> None:
        self.world = world
        self.recover_store = recover_store
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("NF_FAILOVER_DEADLINE_S",
                                           DEADLINE_S_DEFAULT))
        self.retry_s = float(retry_s)
        self._pending: Dict[Tuple[int, int], _Pending] = {}
        self.completed: List[dict] = []  # bounded audit of finished re-homes
        self.last_basis: Dict[str, object] = {}
        reg = world.telemetry.registry
        self._c_initiated = reg.counter(
            "nf_failover_initiated_total",
            "sessions whose re-home the world started after a game CRASH",
        )
        self._c_completed = reg.counter(
            "nf_failover_completed_total",
            "re-homed sessions acked by the adopting game",
        )
        self._c_deadline = reg.counter(
            "nf_failover_deadline_exceeded_total",
            "re-homes abandoned at NF_FAILOVER_DEADLINE_S",
        )
        self._c_busy = reg.counter(
            "nf_failover_busy_total",
            "placement rounds where no survivor had capacity",
        )
        reg.gauge(
            "nf_failover_pending", "sessions currently awaiting re-home",
        ).set_function(lambda: float(len(self._pending)))
        reg.gauge(
            "nf_failover_lag_seconds",
            "age of the oldest pending re-home",
        ).set_function(lambda: self.lag(_time.monotonic()))

    # ------------------------------------------------------------ state
    def pending_count(self) -> int:
        return len(self._pending)

    def lag(self, now: float) -> float:
        if not self._pending:
            return 0.0
        return max(now - p.started for p in self._pending.values())

    # ------------------------------------------------------- death entry
    def game_died(self, dead_sid: int, sessions: List[SessionInfo],
                  wal_dir: Optional[str], ckpt_dir: Optional[str],
                  now: float) -> None:
        """Begin re-homing every session bound to `dead_sid`.  Blob
        basis, newest-durable first: the dead game's WAL suffix (writes
        staged but not yet flushed), then the store itself (the flushed
        watermark), then empty (the adopting game's data agent loads
        from the store on create — covers sessions that never saved)."""
        wal_pending: Dict[str, Optional[bytes]] = {}
        wal_meta: Dict[str, object] = {}
        if wal_dir:
            from ..persist.writebehind import WALError, read_peer_wal
            try:
                view = read_peer_wal(wal_dir)
                wal_pending = view.pending
                wal_meta = {
                    "wal_pending_keys": len(view.pending),
                    "wal_flushed_seq": view.flushed_seq,
                    "wal_max_tick": view.max_tick,
                    "wal_torn_tail_skipped": view.torn_tail_skipped,
                }
            except WALError as e:
                wal_meta = {"wal_error": str(e)}
        ckpt_meta = None
        if ckpt_dir:
            from ..persist.checkpoint import peek_checkpoint
            ckpt_meta = peek_checkpoint(ckpt_dir)
        self.last_basis = {
            "game_id": int(dead_sid),
            "sessions": len(sessions),
            "ckpt": ckpt_meta,
            **wal_meta,
        }
        for info in sessions:
            blob: Optional[bytes] = None
            basis = "none"
            if info.save_key and info.save_key in wal_pending:
                staged = wal_pending[info.save_key]
                if staged is not None:  # a tombstone means deleted: no blob
                    blob, basis = staged, "wal"
            if blob is None and info.save_key and self.recover_store is not None:
                stored = self.recover_store.get(info.save_key)
                if stored is not None:
                    blob, basis = stored, "store"
            p = _Pending(info=info, blob=blob or b"", basis=basis,
                         started=now, next_try=now)
            p.tried.add(int(dead_sid))
            self._pending[info.selfid] = p
            self._c_initiated.inc()
            self._stage(p, now)

    # -------------------------------------------------------- placement
    def _pick_target(self, tried: Set[int]) -> Optional[int]:
        """Least-loaded live game with free Player capacity (the same
        discipline as the world's proxy pick)."""
        best = None
        for sid, d in self.world.games.items():
            r = d.report
            if sid in tried or int(r.server_state) == int(ServerState.CRASH):
                continue
            cur = int(r.server_cur_count)
            cap = int(r.server_max_online)
            if cap > 0 and cur >= cap:
                continue
            if best is None or cur < int(self.world.games[best].report.server_cur_count):
                best = sid
        return best

    def _stage(self, p: _Pending, now: float) -> None:
        target = self._pick_target(p.tried)
        if target is None:
            # no survivor can take this session right now: clear the
            # per-attempt exclusions (capacity frees up as players leave)
            # and come back next round — the proxy's BUSY notice keeps
            # the client informed meanwhile
            p.tried = {int(p.info.game_id)}
            p.next_try = now + self.retry_s
            self._c_busy.inc()
            return
        d = self.world.games.get(target)
        if d is None:
            return
        info = p.info
        selfid = Ident(svrid=info.selfid[0], index=info.selfid[1])
        client = Ident(svrid=info.client_id[0], index=info.client_id[1])
        # frame the recovered blob with the shared row-blob CRC
        # (persist/rowblob.py) so the target distinguishes "torn in
        # transit" from "was empty"; an empty basis stays empty
        from ..persist.rowblob import frame_blob

        data = SwitchServerData(
            selfid=selfid,
            account=info.account.encode(),
            name=info.name.encode(),
            blob=frame_blob(p.blob) if p.blob else p.blob,
            target_serverid=int(target),
        )
        req = ReqSwitchServer(
            selfid=selfid,
            self_serverid=int(info.game_id),
            target_serverid=int(target),
            gate_serverid=0,
            scene_id=int(info.scene_id),
            client_id=client,
            group_id=int(info.group_id),
        )
        # DATA then REQ on the same conn — same no-reorder guarantee the
        # origin game relies on when it stages a voluntary switch
        self.world.server.send_raw(
            d.conn_id, int(MsgID.SWITCH_SERVER_DATA), wrap(data)
        )
        self.world.server.send_raw(
            d.conn_id, int(MsgID.REQ_SWITCH_SERVER), wrap(req)
        )
        p.target = int(target)
        p.attempts += 1
        p.next_try = now + self.retry_s * p.attempts

    # ------------------------------------------------------- ack intake
    def on_ack(self, ack: AckSwitchServer) -> bool:
        """Consume an ACK_SWITCH_SERVER naming a dead origin we staged
        for; returns False when the ack belongs to a normal voluntary
        switch (the caller relays it to the living origin)."""
        key = _ident_key(ack.selfid)
        p = self._pending.get(key)
        if p is None:
            return False
        del self._pending[key]
        self._c_completed.inc()
        self.completed.append({
            "selfid": key,
            "from": int(p.info.game_id),
            "to": int(ack.target_serverid),
            "basis": p.basis,
            "attempts": p.attempts,
        })
        del self.completed[:-512]
        return True

    def on_refused(self, msg: SwitchRefused) -> bool:
        """A staged target refused (capacity / torn blob): exclude it
        and retry the next survivor immediately."""
        key = _ident_key(msg.selfid)
        p = self._pending.get(key)
        if p is None:
            return False
        p.tried.add(int(msg.target_serverid))
        p.next_try = _time.monotonic()
        return True

    # ------------------------------------------------------------- pump
    def execute(self, now: float) -> None:
        if not self._pending:
            return
        expired = [k for k, p in self._pending.items()
                   if now - p.started >= self.deadline_s]
        for k in expired:
            del self._pending[k]
            self._c_deadline.inc()
        for p in list(self._pending.values()):
            if now >= p.next_try:
                self._stage(p, now)
