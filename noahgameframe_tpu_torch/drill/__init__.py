"""Game-day drill engine: composed fault campaigns with
continuously-checked cluster invariants.

Every reliability mechanism in the repo is individually proven — chaos
injection, write-behind WAL, supervised session failover, bit-identical
journal replay — but production clusters fail *compositionally*: a game
dies during a store outage during a session surge.  This package turns
that composition into a first-class, repeatable artifact:

- :mod:`drill.schedule` — a seeded, **tick-indexed** campaign: a
  declarative list of ``(at_tick, action)`` steps over a LocalCluster
  (kill/revive roles, arm/heal chaos faults, checkpoints, arbitrary
  callables).  No wall-clock scheduling — the campaign clock is the
  drill pump count, so two runs fire the same actions at the same
  points in the event stream.
- :mod:`drill.invariants` — a library of cluster invariants sampled
  every pump: no session silently dropped, lease transitions legal,
  WAL watermarks monotone per store key, failover lag bounded, parked
  replay in order, telemetry counter bank conserved.
- :mod:`drill.runner` — drives the cluster pump, fires due campaign
  steps, samples every invariant each tick, and exports ``nf_drill_*``
  counters + a ``drill`` block on the master's ``/json``.
- :mod:`drill.report` — the run distilled to a JSON artifact.

The flagship game-day (``scripts/torch_gameday_smoke.py``) kills a game
DURING a hard store outage DURING a session surge, heals, and proves
failover + WAL recovery + journal replay converge bit-identically to a
fault-free control with zero dropped sessions.

A copy of ``noahgameframe_tpu/drill/__init__.py``, which imports no jax: the
port keeps its own, since it imports nothing of the JAX package.
"""

from .invariants import (
    BoundedFailoverLag,
    ConsistentCounters,
    DrillContext,
    Invariant,
    LegalLeaseTransitions,
    MonotoneWatermarks,
    NoSilentDrop,
    OrderedReplay,
    RoomIsolation,
    StableUnderReshard,
    default_invariants,
)
from .report import DrillReport, Violation
from .runner import DrillRunner
from .schedule import Campaign, Step, merged

__all__ = [
    "BoundedFailoverLag",
    "Campaign",
    "ConsistentCounters",
    "DrillContext",
    "DrillReport",
    "DrillRunner",
    "Invariant",
    "LegalLeaseTransitions",
    "MonotoneWatermarks",
    "NoSilentDrop",
    "OrderedReplay",
    "RoomIsolation",
    "StableUnderReshard",
    "Step",
    "Violation",
    "default_invariants",
    "merged",
]
