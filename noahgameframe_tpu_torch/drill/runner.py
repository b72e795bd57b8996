"""DrillRunner: drive a campaign against a LocalCluster, invariants on.

One :meth:`step_once` is one drill tick: fire every campaign step due at
this tick, pump the whole cluster once, run the caller's extra pump
(client sockets, surge traffic), then sample every invariant.  The
runner is the only component that reads the wall clock, and only as
``monotonic()`` pump pacing — campaign *scheduling* is tick-indexed by
construction (the schedule and invariant modules never read the clock).

Telemetry (on the master's registry, so ``/metrics`` and ``/json`` see
it cluster-wide):

- ``nf_drill_ticks_total`` — drill pump passes driven
- ``nf_drill_actions_total{action}`` — campaign steps fired
- ``nf_drill_invariant_checks_total{invariant}`` — samples taken
- ``nf_drill_invariant_violations_total{invariant}`` — breaches found

The master's ``/json`` additionally carries a live ``drill`` block
(campaign name/seed, clock, fired/remaining steps, per-invariant breach
counts) via :meth:`LocalCluster.attach_drill`.

A copy of ``noahgameframe_tpu/drill/runner.py``, which imports no jax: the
port keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Optional

from .invariants import DrillContext, Invariant, default_invariants
from .report import DrillReport, Violation
from .schedule import Campaign, Step


class DrillRunner:
    def __init__(self, cluster, campaign: Campaign,
                 invariants: Optional[List[Invariant]] = None,
                 registry=None, max_violations: int = 256) -> None:
        self.cluster = cluster
        self.campaign = campaign
        self.invariants = (invariants if invariants is not None
                           else default_invariants())
        self.tick = 0
        self._steps: List[Step] = campaign.steps
        self._next_step = 0
        self.actions_fired: List[Dict[str, object]] = []
        self.violations: List[Violation] = []
        #: breaches past this cap are counted but not stored verbatim —
        #: a broken invariant at pump rate would otherwise OOM the run
        self.max_violations = int(max_violations)
        self.checks: Dict[str, int] = {}
        self._violation_tally: Dict[str, int] = {}
        reg = (registry if registry is not None
               else cluster.master.telemetry.registry)
        self._c_ticks = reg.counter(
            "nf_drill_ticks_total", "drill pump passes driven")
        self._c_actions = reg.counter(
            "nf_drill_actions_total", "campaign steps fired", ("action",))
        self._c_checks = reg.counter(
            "nf_drill_invariant_checks_total",
            "invariant samples taken", ("invariant",))
        self._c_violations = reg.counter(
            "nf_drill_invariant_violations_total",
            "invariant breaches observed", ("invariant",))
        attach = getattr(cluster, "attach_drill", None)
        if attach is not None:
            attach(self)

    # ------------------------------------------------------------ steps
    def step_once(self, extra: Optional[Callable[[], None]] = None) -> None:
        """One drill tick: due actions → cluster pump → extra pump →
        invariant sample."""
        while (self._next_step < len(self._steps)
               and self._steps[self._next_step].at_tick <= self.tick):
            self._fire(self._steps[self._next_step])
            self._next_step += 1
        self.cluster.execute()
        if extra is not None:
            extra()
        self._sample(_time.monotonic())
        self.tick += 1
        self._c_ticks.inc()

    def pump(self, rounds: int = 50,
             extra: Optional[Callable[[], None]] = None,
             sleep: float = 0.002) -> None:
        for _ in range(int(rounds)):
            self.step_once(extra)
            _time.sleep(sleep)

    def pump_until(self, cond: Callable[[], bool],
                   extra: Optional[Callable[[], None]] = None,
                   timeout: float = 10.0, sleep: float = 0.002) -> bool:
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            self.step_once(extra)
            if cond():
                return True
            _time.sleep(sleep)
        return False

    @property
    def steps_remaining(self) -> int:
        return len(self._steps) - self._next_step

    def run(self, settle_ticks: int = 50,
            extra: Optional[Callable[[], None]] = None,
            sleep: float = 0.002) -> DrillReport:
        """Drive the whole campaign: pump through the horizon, then
        ``settle_ticks`` more so recovery (and its invariants) are
        observed, then hand back the report."""
        self.pump(self.campaign.horizon + 1 + int(settle_ticks),
                  extra=extra, sleep=sleep)
        return self.report()

    # ---------------------------------------------------------- actions
    def _fire(self, step: Step) -> None:
        kw = step.kwargs
        cluster = self.cluster
        if step.action == "kill_role":
            cluster.kill_role(kw["role"], hard=bool(kw.get("hard", True)))
        elif step.action == "revive_role":
            world = kw.get("world")
            factory = kw.get("world_factory")
            if world is None and factory is not None:
                world = factory()
            cluster.revive_role(kw["name"], world=world,
                                resume=bool(kw.get("resume", True)))
        elif step.action == "heal":
            if cluster.chaos is not None:
                cluster.chaos.heal(kw.get("pattern"))
        elif step.action == "store_faults":
            if cluster.chaos is not None:
                cluster.chaos.set_store_faults(kw["pattern"], kw["faults"])
        elif step.action == "link_faults":
            if cluster.chaos is not None:
                cluster.chaos.set_link_faults(kw["pattern"], kw["faults"])
        elif step.action == "checkpoint":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.checkpoint_now()
        elif step.action == "grow_mesh":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.grow_mesh(int(kw["n"]))
        elif step.action == "drain_device":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.drain_device(int(kw["device"]))
        elif step.action == "create_room":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.create_room(seed=kw.get("seed"),
                             room_id=kw.get("room_id"),
                             control=bool(kw.get("control", False)))
        elif step.action == "destroy_room":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.destroy_room(int(kw["room_id"]))
        elif step.action == "rehome_room":
            role = next(r for r in cluster.roles
                        if r.config.name == kw["role"])
            role.rehome_room(int(kw["room_id"]))
        elif step.action == "call":
            kw["fn"](self)
        # "note" is a pure marker — the fired log below is its effect
        self.actions_fired.append({
            "tick": int(self.tick),
            **step.describe(),
        })
        self._c_actions.inc(action=step.action)

    # ------------------------------------------------------- invariants
    def _sample(self, now: float) -> None:
        ctx = DrillContext(cluster=self.cluster, tick=self.tick, now=now)
        for inv in self.invariants:
            self.checks[inv.name] = self.checks.get(inv.name, 0) + 1
            self._c_checks.inc(invariant=inv.name)
            for detail in inv.check(ctx):
                self._violation_tally[inv.name] = (
                    self._violation_tally.get(inv.name, 0) + 1)
                self._c_violations.inc(invariant=inv.name)
                if len(self.violations) < self.max_violations:
                    self.violations.append(
                        Violation(inv.name, self.tick, detail))

    # ------------------------------------------------------------ status
    def status(self) -> Dict[str, object]:
        """Live drill block for the master's ``/json``."""
        nxt = (self._steps[self._next_step].describe()
               if self._next_step < len(self._steps) else None)
        return {
            "campaign": self.campaign.name,
            "seed": int(self.campaign.seed),
            "tick": int(self.tick),
            "horizon": int(self.campaign.horizon),
            "actions_fired": len(self.actions_fired),
            "steps_remaining": self.steps_remaining,
            "next_step": nxt,
            "invariant_violations": dict(self._violation_tally),
        }

    def report(self) -> DrillReport:
        return DrillReport(
            campaign=self.campaign.describe(),
            ticks=int(self.tick),
            actions_fired=list(self.actions_fired),
            violations=list(self.violations),
            checks=dict(self.checks),
        )
