"""Elastic mesh: grow/drain the device set under a LIVE serving world.

Counterpart of ``noahgameframe_tpu/parallel/elastic.py`` (text kept, the
mesh calls ported).  The reference framework survives hardware churn by
supervision; the engine's equivalent churn is the *mesh*: the device set
must change under a running, serving world.

- **grow**: re-place immediately onto the wider mesh (block partition of
  the leading capacity axis is content-preserving), then retarget
  :class:`~.rowmigrate.RowMigrationModule` so the budgeted migrate phase
  *rebalances* rows toward their new spatial owners over the following
  ticks.  Done when ``settle_polls`` consecutive ticks report zero
  overflow.  A virtual mesh grows by more shards on its device; a mesh of
  cards by the next cards not yet in it.
- **drain**: evict ONE shard via a budgeted row exodus: the migrate
  phase's owner function is remapped (``set_exodus``) so rows standing on
  the draining shard route to a survivor while every other row holds
  position.  When the draining shard's row range is empty (or
  ``exodus_tick_bound`` ticks elapse; re-placement is content-preserving
  either way) the mesh shrinks around it and ``clear_exodus`` resumes
  normal routing.

Every reshard rides :meth:`ShardedKernel.reshard`: a CostBook generation
bump announced before the dispatchers drop, the Verlet/binning aux caches
dropped, and a fresh split onto the new mesh.  :meth:`ElasticMesh.poll`
returns the rows whose (identity, liveness) changed across a completed
op, so a serving role resets exactly the affected views.
:class:`Autoscaler` decides grow/drain from exported signals with
consecutive-breach hysteresis and a post-op cooldown.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .mesh import Mesh
from .rowmigrate import canonical_digest


class ElasticMesh:
    """Grow/drain controller over one :class:`~.shard.ShardedKernel`.

    ``migration`` (a bound :class:`~.rowmigrate.RowMigrationModule`) is
    optional: without it grow/drain are pure re-places (still
    generation-announced, still zero dropped rows); with it, drains
    pre-copy via the exodus protocol and grows rebalance spatially.

    ``ident_cols`` (``{class_name: i32 column}``, the
    :func:`~.rowmigrate.canonical_digest` contract) powers precise
    moved-row detection and :meth:`digest`; without it, a completed op
    conservatively reports EVERY row of the migrating class as moved.
    """

    def __init__(self, sharded, migration=None, registry=None,
                 ident_cols: Optional[Dict[str, int]] = None,
                 exodus_tick_bound: int = 256, settle_polls: int = 2,
                 autoscaler: Optional["Autoscaler"] = None):
        self.sharded = sharded
        self.migration = migration
        self.ident_cols = dict(ident_cols) if ident_cols else None
        self.exodus_tick_bound = int(exodus_tick_bound)
        self.settle_polls = max(1, int(settle_polls))
        self.autoscaler = autoscaler
        self._op: Optional[Dict[str, object]] = None
        self.ops_done: List[Dict[str, object]] = []
        self.dropped_rows = 0
        self.rows_moved_total = 0
        self.last_exodus_ticks = 0
        self._pop_baseline = self._pop()
        self._pop_last = self._pop_baseline
        self._c_total = self._c_moved = self._c_dropped = None
        self._g_devices = self._g_inflight = self._h_exodus = None
        if registry is not None:
            self._c_total = registry.counter(
                "nf_reshard_total", "mesh reshards completed", ("kind",))
            self._c_moved = registry.counter(
                "nf_reshard_rows_moved_total",
                "rows whose content changed index across a reshard")
            self._c_dropped = registry.counter(
                "nf_reshard_dropped_rows_total",
                "rows lost across a reshard (must stay 0)")
            self._g_devices = registry.gauge(
                "nf_reshard_devices", "devices in the serving mesh")
            self._g_inflight = registry.gauge(
                "nf_reshard_inflight", "1 while a grow/drain is in flight")
            self._h_exodus = registry.histogram(
                "nf_reshard_exodus_ticks",
                "ticks from drain arm to empty device row-range")
            self._g_devices.set(float(self.n_devices))
            self._g_inflight.set(0.0)

    # ----------------------------------------------------------- introspect
    @property
    def kernel(self):
        return self.sharded.kernel

    @property
    def n_devices(self) -> int:
        return int(self.sharded.mesh.size)

    @property
    def inflight(self) -> Optional[str]:
        return None if self._op is None else str(self._op["kind"])

    def _mig_class(self) -> Optional[str]:
        if self.migration is None:
            return None
        return self.migration.placement.class_name

    def _pop(self) -> int:
        """Live rows of the migrating class (the population the exodus
        must conserve; serve-side Player churn is deliberately outside)."""
        cname = self._mig_class()
        if cname is None:
            if not self.ident_cols:
                return 0
            return sum(int(self.kernel.state.classes[c].alive.sum())
                       for c in self.ident_cols)
        return int(self.kernel.state.classes[cname].alive.sum())

    def _snapshot(self) -> Optional[Dict[str, np.ndarray]]:
        """(ident, alive) per row of the migrating class — the moved-row
        baseline.  Identity-based so content churn (regen ticking HP)
        never reads as movement."""
        cname = self._mig_class()
        if cname is None or self.ident_cols is None \
                or cname not in self.ident_cols:
            return None
        cs = self.kernel.state.classes[cname]
        return {
            "ident": cs.i32[:, self.ident_cols[cname]].cpu().numpy().copy(),
            "alive": cs.alive.cpu().numpy().copy(),
        }

    def _moved_since(self, snap) -> Dict[str, np.ndarray]:
        """Row indices whose (identity, liveness) changed since ``snap``
        — exactly the rows whose serve-side seen-state went stale."""
        cname = self._mig_class()
        if cname is None:
            return {}
        cs = self.kernel.state.classes[cname]
        alive = cs.alive.cpu().numpy()
        if snap is None:
            return {cname: np.arange(alive.shape[0], dtype=np.int64)}
        ident = cs.i32[:, self.ident_cols[cname]].cpu().numpy()
        changed = (alive != snap["alive"]) | (
            (alive | snap["alive"]) & (ident != snap["ident"]))
        return {cname: np.flatnonzero(changed)}

    def digest(self) -> Optional[int]:
        """Placement-invariant world digest over the configured identity
        columns (the parity oracle the StableUnderReshard invariant pins
        against a control world)."""
        if not self.ident_cols:
            return None
        return canonical_digest(
            self.kernel.state, sorted(self.ident_cols), self.ident_cols)

    # ------------------------------------------------------------------ ops
    def begin_grow(self, n_devices: int) -> None:
        """Expand the mesh to ``n_devices`` at the next :meth:`poll`: more
        shards on the device of a virtual mesh (or of a one-shard CPU
        mesh), else the next cards not yet in it."""
        self._require_idle()
        n_new = int(n_devices)
        if n_new <= self.n_devices:
            raise ValueError(
                f"grow_mesh({n_new}) on a {self.n_devices}-device mesh")
        cur = self.sharded.mesh
        if cur.virtual or cur.size == 1 and cur.devices[0].type != "cuda":
            devices = [cur.devices[0]] * (n_new - cur.size)
        else:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(have)
                       if torch.device("cuda", i) not in cur.devices]
        if cur.size + len(devices) < n_new:
            raise RuntimeError(
                f"need {n_new} devices, have {cur.size + len(devices)}")
        mesh = Mesh(list(cur.devices) + devices[: n_new - cur.size], cur.axis)
        self._op = {
            "kind": "grow", "stage": "reshard", "mesh": mesh,
            "snap": self._snapshot(), "start_tick": self._tick_count(),
            "settled": 0, "last_seen_tick": -1,
        }
        self._pop_baseline = self._pop()
        if self._g_inflight is not None:
            self._g_inflight.set(1.0)

    def begin_drain(self, device_index: int) -> None:
        """Arm the exodus that evicts mesh position ``device_index``."""
        self._require_idle()
        n = self.n_devices
        d = int(device_index)
        if n <= 1:
            raise ValueError("cannot drain the last device")
        if not 0 <= d < n:
            raise ValueError(f"device_index {d} out of range for {n}")
        self._op = {
            "kind": "drain", "stage": "exodus", "device": d,
            "snap": self._snapshot(), "start_tick": self._tick_count(),
        }
        self._pop_baseline = self._pop()
        if self.migration is not None:
            # spatial owner o re-homes to the adjacent survivor when o
            # is the draining shard; every other owner keeps its rows
            remap = np.arange(n, dtype=np.int32)
            remap[d] = d - 1 if d > 0 else d + 1
            self.migration.set_exodus(remap)
        if self._g_inflight is not None:
            self._g_inflight.set(1.0)

    def _require_idle(self) -> None:
        if self._op is not None:
            raise RuntimeError(
                f"reshard already in flight: {self._op['kind']}")

    def _tick_count(self) -> int:
        return int(getattr(self.kernel, "tick_count", 0))

    # ----------------------------------------------------------------- poll
    def poll(self) -> Dict[str, np.ndarray]:
        """Advance the in-flight op one step; call once per served tick
        (GameRole does, under the ``reshard`` stage).  Returns the moved
        row indices per class when an op COMPLETES this poll — empty
        otherwise — so the caller can reset exactly the affected views."""
        self._sample_drops()
        op = self._op
        if op is None:
            return {}
        if op["kind"] == "drain":
            return self._poll_drain(op)
        return self._poll_grow(op)

    def _sample_drops(self) -> None:
        if self.migration is None:
            return
        stats = self.kernel.state.aux.get(self.migration.aux_key)
        if stats is None:
            return
        d = int(stats[:, 2].sum())
        if d:
            self.dropped_rows += d
            if self._c_dropped is not None:
                self._c_dropped.inc(d)

    def _poll_drain(self, op) -> Dict[str, np.ndarray]:
        d = int(op["device"])
        ticks = self._tick_count() - int(op["start_tick"])
        cname = self._mig_class()
        drained = True
        if cname is not None:
            alive = self.kernel.state.classes[cname].alive.cpu().numpy()
            cap = alive.shape[0]
            n = self.n_devices
            lo, hi = d * cap // n, (d + 1) * cap // n
            drained = not alive[lo:hi].any()
        if not drained and ticks <= self.exodus_tick_bound:
            return {}
        # shrink around the evicted device.  Content survives either way
        # (block re-place); a not-yet-drained range just means the
        # eviction copies at shrink time instead of ahead of it — the
        # StableUnderReshard invariant surfaces the blown bound.
        if self.migration is not None:
            self.migration.clear_exodus()
            new_n = self.n_devices - 1
            self.migration.retarget(
                placement=dataclasses.replace(
                    self.migration.placement, n_shards=new_n),
                mesh=self.sharded.mesh.without(d),
            )
            mesh = self.migration.mesh
        else:
            mesh = self.sharded.mesh.without(d)
        self.sharded.reshard(mesh, cause=f"drain:{d}")
        self.last_exodus_ticks = ticks
        if self._h_exodus is not None:
            self._h_exodus.observe(float(ticks))
        return self._complete(op, {"device": d, "exodus_ticks": ticks,
                                   "drained_in_budget": drained})

    def _poll_grow(self, op) -> Dict[str, np.ndarray]:
        if op["stage"] == "reshard":
            mesh = op["mesh"]
            if self.migration is not None:
                self.migration.retarget(
                    placement=dataclasses.replace(
                        self.migration.placement,
                        n_shards=int(mesh.size)),
                    mesh=mesh,
                )
            self.sharded.reshard(mesh, cause=f"grow:{mesh.size}")
            if self.migration is None:
                return self._complete(op, {"rebalance_ticks": 0})
            op["stage"] = "rebalance"
            return {}
        # rebalance: done once the migrate phase reports zero overflow
        # settle_polls ticks in a row — migrated stays nonzero under
        # normal motion churn; overflow is the stranded re-place backlog.
        # Counted only when the kernel actually ticked since last poll.
        tick = self._tick_count()
        if tick == op["last_seen_tick"]:
            return {}
        op["last_seen_tick"] = tick
        ticks = tick - int(op["start_tick"])
        stats = self.kernel.state.aux[self.migration.aux_key]
        if int(stats[:, 1].sum()) == 0:
            op["settled"] = int(op["settled"]) + 1
        else:
            op["settled"] = 0
        if int(op["settled"]) < self.settle_polls \
                and ticks <= self.exodus_tick_bound:
            return {}
        return self._complete(op, {"rebalance_ticks": ticks})

    def _complete(self, op, extra: Dict[str, object]) -> Dict[str, np.ndarray]:
        moved = self._moved_since(op["snap"])
        n_moved = sum(int(v.size) for v in moved.values())
        self.rows_moved_total += n_moved
        self._pop_last = self._pop()
        done = {
            "kind": op["kind"], "devices": self.n_devices,
            "rows_moved": n_moved,
            "pop_before": int(self._pop_baseline),
            "pop_after": int(self._pop_last),
            **extra,
        }
        self.ops_done.append(done)
        self._op = None
        if self._c_total is not None:
            self._c_total.inc(kind=str(op["kind"]))
            self._c_moved.inc(n_moved)
            self._g_devices.set(float(self.n_devices))
            self._g_inflight.set(0.0)
        return moved

    # ------------------------------------------------------------ autoscale
    def maybe_autoscale(self, signals: Dict[str, float]) -> Optional[str]:
        """Feed one signal sample to the attached :class:`Autoscaler`;
        fire the decided op (grow doubles up to the policy max, drain
        evicts the highest mesh position).  Returns the decision."""
        if self.autoscaler is None or self._op is not None:
            return None
        decision = self.autoscaler.observe(signals, self.n_devices)
        if decision == "grow":
            self.begin_grow(min(self.n_devices * 2,
                                self.autoscaler.policy.max_devices))
        elif decision == "drain":
            self.begin_drain(self.n_devices - 1)
        return decision

    # --------------------------------------------------------------- status
    def status(self) -> Dict[str, object]:
        """Defensively-readable snapshot for invariants and ``/json``."""
        op = self._op
        return {
            "devices": self.n_devices,
            "inflight": self.inflight,
            "stage": None if op is None else op.get("stage"),
            "exodus_ticks": (
                self._tick_count() - int(op["start_tick"])
                if op is not None and op["kind"] == "drain"
                else self.last_exodus_ticks),
            "exodus_tick_bound": self.exodus_tick_bound,
            "dropped_rows": int(self.dropped_rows),
            "rows_moved_total": int(self.rows_moved_total),
            "pop": int(self._pop_last),
            "pop_baseline": int(self._pop_baseline),
            "resharded_total": len(self.ops_done),
            "generation": int(self.kernel.costbook.generation),
        }


# ---------------------------------------------------------------- autoscaler


@dataclasses.dataclass
class AutoscalePolicy:
    """Thresholds over already-exported signals.  A signal missing from
    a sample simply doesn't vote — the loop degrades to whatever is
    actually being measured."""

    grow_tick_p95_ms: float = 50.0    # StageClock "tick" stage p95
    grow_hbm_frac: float = 0.85       # nf_hbm live/limit
    grow_persist_lag_s: float = 2.0   # write-behind flush lag
    grow_failover_lag_s: float = 2.0  # oldest pending re-home
    shrink_tick_p95_ms: float = 4.0   # everything calm below this
    min_devices: int = 1
    max_devices: int = 8
    consecutive: int = 3              # breaches in a row before acting
    cooldown_polls: int = 200         # quiet period after any decision


class Autoscaler:
    """Hysteresis loop: ``observe`` one signal sample per poll, get back
    ``"grow"``/``"drain"``/``None``.  A decision requires
    ``policy.consecutive`` breaching samples in a row AND an expired
    cooldown, so one hot frame (or one idle lull) never flaps the mesh.
    """

    GROW_KEYS = (
        ("tick_p95_ms", "grow_tick_p95_ms"),
        ("hbm_frac", "grow_hbm_frac"),
        ("persist_lag_s", "grow_persist_lag_s"),
        ("failover_lag_s", "grow_failover_lag_s"),
    )

    def __init__(self, policy: Optional[AutoscalePolicy] = None):
        self.policy = policy or AutoscalePolicy()
        self._hot_streak = 0
        self._cold_streak = 0
        self._cooldown = 0
        self.decisions: List[str] = []

    def observe(self, signals: Dict[str, float],
                devices: int) -> Optional[str]:
        p = self.policy
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        hot = any(
            signals.get(sig) is not None
            and float(signals[sig]) > getattr(p, thr)
            for sig, thr in self.GROW_KEYS
        )
        tick = signals.get("tick_p95_ms")
        cold = (not hot and tick is not None
                and float(tick) < p.shrink_tick_p95_ms)
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._cold_streak = self._cold_streak + 1 if cold else 0
        if hot and self._hot_streak >= p.consecutive \
                and devices < p.max_devices:
            self._hot_streak = self._cold_streak = 0
            self._cooldown = p.cooldown_polls
            self.decisions.append("grow")
            return "grow"
        if cold and self._cold_streak >= p.consecutive \
                and devices > p.min_devices:
            self._hot_streak = self._cold_streak = 0
            self._cooldown = p.cooldown_polls
            self.decisions.append("drain")
            return "drain"
        return None


# ------------------------------------------------------------ parity oracle


class DigestControl:
    """Lockstep single-shard control twin for digest-pinned parity.

    Wraps a control world (same seed, same config, static mesh, no
    faults) and advances it to a requested tick count on demand; the
    digest it returns is what the elastic world must equal at the same
    tick — :func:`~.rowmigrate.canonical_digest` is placement-invariant,
    so ANY mesh history with intact rows matches."""

    def __init__(self, world, ident_cols: Dict[str, int]):
        self.world = world
        self.ident_cols = dict(ident_cols)

    @property
    def tick_count(self) -> int:
        return int(self.world.kernel.tick_count)

    def advance_to(self, tick_count: int) -> int:
        k = self.world.kernel
        target = int(tick_count)
        while k.tick_count < target:
            self.world.tick()
        if k.tick_count != target:
            raise RuntimeError(
                f"control overshot: at {k.tick_count}, wanted {target}")
        return canonical_digest(
            k.state, sorted(self.ident_cols), self.ident_cols)
