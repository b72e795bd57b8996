"""The port's game-day drill engine (noahgameframe_tpu_torch.drill) against
the JAX package's, case by case after tests/test_drill.py.

Every tier-1 case of tests/test_drill.py has a case here of the same
name.  A case is written once against a package namespace (``P.drill``,
``P.chaos``, ``P.defines``, ``P.failover``, ``P.registry``) and
:func:`both` runs it on the JAX package and on the port: the case's own
asserts hold on each, and what it returns (dispatch logs, the
``DrillReport`` JSON, violation details, registry values) is equal across
the two.  The forged clusters are ``SimpleNamespace`` stand-ins that both
packages' checkers read the same way.

Then the three ``StableUnderReshard`` cases of tests/test_elastic.py, and
the short gameday (6 sessions, 3 chats) of scripts/torch_gameday_smoke.py
on the CPU beside JAX's scripts/gameday_smoke.py.  The reshard campaign
is in tests/test_torch_drill_reshard.py.  The end-to-end campaigns are
paced by wall time (which pump a frame lands in), so only what is fixed
is compared across the packages: the campaign's ``describe()``, the fired
steps (tick, action, label), the violation count (zero) and each check's
name and verdict.  Left out: the drill's tick total and per-invariant
sample counts (the pump loops run until a condition holds), the re-home
time, the client chat logs, and the journal's replay digest (its
per-tick state depends on which tick each session's messages landed in).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import noahgameframe_tpu.drill as jdrill
import noahgameframe_tpu.net.chaos as jchaos
import noahgameframe_tpu.net.defines as jdefines
import noahgameframe_tpu.net.failover as jfailover
import noahgameframe_tpu.telemetry.registry as jregistry
import noahgameframe_tpu_torch.drill as tdrill
import noahgameframe_tpu_torch.net.chaos as tchaos
import noahgameframe_tpu_torch.net.defines as tdefines
import noahgameframe_tpu_torch.net.failover as tfailover
import noahgameframe_tpu_torch.telemetry.registry as tregistry
from test_torch_parity import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": SimpleNamespace(drill=jdrill, chaos=jchaos, defines=jdefines,
                           failover=jfailover, registry=jregistry),
    "torch": SimpleNamespace(drill=tdrill, chaos=tchaos, defines=tdefines,
                             failover=tfailover, registry=tregistry),
}


def _canon(x):
    """Plain data of a case's result: each package's dataclasses (fault
    specs, violations) become dicts, tuples lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"_": type(x).__name__, **_canon(dataclasses.asdict(x))}
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def both(case):
    """Run ``case(P)`` on the JAX package, then on the port; both results
    must be equal.  Returns the port's."""
    got = {name: _canon(case(P)) for name, P in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _report_json(r) -> dict:
    return json.loads(json.dumps(r.report().to_dict()))


# --------------------------------------------------------------- Campaign
class TestCampaign:
    def test_builder_sorts_by_tick_stable_within_tick(self):
        def case(P):
            c = (P.drill.Campaign("t", seed=3)
                 .add(5, "note", label="second-at-5")
                 .add(1, "note", label="early")
                 .add(5, "note", label="third-at-5"))
            assert [s.label for s in c.steps] == [
                "early", "second-at-5", "third-at-5"]
            assert c.horizon == 5 and len(c) == 3 and c.seed == 3
            return c.describe()

        both(case)

    def test_negative_tick_rejected(self):
        def case(P):
            out = []
            for build in (lambda: P.drill.Campaign("t").add(-1, "note"),
                          lambda: P.drill.Campaign(
                              "t", steps=[P.drill.Step(-2, "note")])):
                with pytest.raises(ValueError, match="at_tick") as e:
                    build()
                out.append(str(e.value))
            return out

        both(case)

    def test_unknown_action_rejected(self):
        def case(P):
            out = []
            with pytest.raises(ValueError, match="unknown action") as e:
                P.drill.Campaign("t").add(0, "reboot_datacenter")
            out.append(str(e.value))
            with pytest.raises(ValueError, match="'call'") as e:
                P.drill.Campaign("t", steps=[P.drill.Step(0, "frobnicate")])
            out.append(str(e.value))
            return out

        both(case)

    def test_describe_is_json_safe_with_live_kwargs(self):
        def case(P):
            c = (P.drill.Campaign("t", seed=7)
                 .add(5, "store_faults", pattern="game6.store",
                      faults=P.chaos.StoreFaults(fail_first=3))
                 .add(9, "call", fn=lambda r: None)
                 .add(2, "kill_role", role="Game1", hard=True))
            desc = c.describe()
            json.dumps(desc)  # must not raise
            assert desc["name"] == "t" and desc["seed"] == 7
            assert desc["horizon"] == 9
            by_action = {s["action"]: s for s in desc["steps"]}
            assert by_action["store_faults"]["kwargs"]["faults"][
                "fail_first"] == 3
            assert by_action["call"]["kwargs"]["fn"].startswith("<callable")
            assert by_action["kill_role"]["kwargs"] == {
                "role": "Game1", "hard": True}
            return desc

        both(case)

    def test_merged_shifts_offsets_and_defaults_labels(self):
        def case(P):
            outage = P.drill.Campaign("outage").add(0, "note").add(4, "heal")
            kill = P.drill.Campaign("kill").add(0, "kill_role", role="Game1",
                                                label="boom")
            c = P.drill.merged("gameday", 7, (10, outage), (12, kill))
            assert [(s.at_tick, s.action, s.label) for s in c.steps] == [
                (10, "note", "outage:note"),
                (12, "kill_role", "boom"),
                (14, "heal", "outage:heal"),
            ]
            assert c.seed == 7 and c.horizon == 14
            return c.describe()

        both(case)


# ------------------------------------------------------------ DrillRunner
class _AlwaysViolates:
    name = "always"

    def check(self, ctx):
        return ["forged breach"]


class _NeverViolates:
    name = "never"

    def check(self, ctx):
        return []


def _fake_cluster(log):
    """Minimal dispatch target: records every call the runner makes."""
    role = SimpleNamespace(
        config=SimpleNamespace(name="Game1"),
        checkpoint_now=lambda: log.append(("checkpoint", "Game1")),
    )
    chaos = SimpleNamespace(
        heal=lambda pattern: log.append(("heal", pattern)),
        set_store_faults=lambda p, f: log.append(("store_faults", p, f)),
        set_link_faults=lambda p, f: log.append(("link_faults", p, f)),
    )
    return SimpleNamespace(
        execute=lambda: log.append(("pump",)),
        kill_role=lambda role, hard: log.append(("kill", role, hard)),
        revive_role=lambda name, world, resume: log.append(
            ("revive", name, world, resume)),
        chaos=chaos,
        roles=[role],
    )


class TestRunnerActions:
    def test_steps_fire_at_their_tick_before_the_pump(self):
        def case(P):
            log = []
            c = (P.drill.Campaign("t")
                 .add(0, "note", label="start")
                 .add(2, "kill_role", role="Game1", hard=True)
                 .add(2, "heal", pattern="game6")
                 .add(4, "call", fn=lambda r: log.append(("call", r.tick))))
            r = P.drill.DrillRunner(_fake_cluster(log), c, invariants=[],
                                    registry=P.registry.MetricsRegistry())
            for _ in range(5):
                r.step_once()
            assert log == [
                ("pump",), ("pump",),
                ("kill", "Game1", True), ("heal", "game6"), ("pump",),
                ("pump",),
                ("call", 4), ("pump",),
            ]
            assert r.steps_remaining == 0
            assert [a["label"] or a["action"] for a in r.actions_fired] == [
                "start", "kill_role", "heal", "call"]
            assert [a["tick"] for a in r.actions_fired] == [0, 2, 2, 4]
            return {"log": log, "report": _report_json(r)}

        both(case)

    def test_all_dispatch_arms_and_telemetry(self):
        def case(P):
            log = []
            reg = P.registry.MetricsRegistry()
            factory_built = []

            def factory():
                factory_built.append(1)
                return "fresh-world"

            c = (P.drill.Campaign("t")
                 .add(0, "store_faults", pattern="game6.store",
                      faults=P.chaos.StoreFaults(fail_first=1))
                 .add(0, "link_faults", pattern="proxy5",
                      faults=P.chaos.LinkFaults(dup=0.5))
                 .add(1, "checkpoint", role="Game1")
                 .add(2, "revive_role", name="Game1",
                      world_factory=factory, resume=True))
            r = P.drill.DrillRunner(_fake_cluster(log), c, invariants=[],
                                    registry=reg)
            for _ in range(3):
                r.step_once()
            kinds = [e[0] for e in log]
            assert kinds == ["store_faults", "link_faults", "pump",
                             "checkpoint", "pump", "revive", "pump"]
            assert factory_built == [1]
            assert log[5] == ("revive", "Game1", "fresh-world", True)
            values = (reg.value("nf_drill_ticks_total"),
                      reg.value("nf_drill_actions_total", action="store_faults"),
                      reg.value("nf_drill_actions_total", action="revive_role"))
            assert values == (3.0, 1.0, 1.0)
            return {"log": log, "values": values, "report": _report_json(r),
                    "exposition": reg.exposition()}

        both(case)

    def test_violation_cap_keeps_counting_past_the_cap(self):
        def case(P):
            reg = P.registry.MetricsRegistry()
            r = P.drill.DrillRunner(
                _fake_cluster([]), P.drill.Campaign("t"),
                invariants=[_AlwaysViolates(), _NeverViolates()],
                registry=reg, max_violations=5)
            for _ in range(9):
                r.step_once()
            assert len(r.violations) == 5
            rep = r.report()
            assert not rep.clean
            assert rep.checks == {"always": 9, "never": 9}
            assert reg.value("nf_drill_invariant_violations_total",
                             invariant="always") == 9.0
            assert reg.value("nf_drill_invariant_checks_total",
                             invariant="never") == 9.0
            assert r.status()["invariant_violations"] == {"always": 9}
            return {"report": _report_json(r), "violations": r.violations,
                    "status": r.status()}

        both(case)

    def test_status_block_is_json_safe(self):
        def case(P):
            c = (P.drill.Campaign("gameday", seed=7)
                 .add(3, "kill_role", role="Game1", hard=True)
                 .add(8, "call", fn=lambda r: None))
            r = P.drill.DrillRunner(_fake_cluster([]), c, invariants=[],
                                    registry=P.registry.MetricsRegistry())
            r.step_once()
            st = r.status()
            json.dumps(st)
            assert st["campaign"] == "gameday" and st["seed"] == 7
            assert st["tick"] == 1 and st["horizon"] == 8
            assert st["actions_fired"] == 0 and st["steps_remaining"] == 2
            assert st["next_step"]["at_tick"] == 3
            return st

        both(case)

    def test_report_round_trips_through_json(self):
        def case(P):
            c = P.drill.Campaign("t").add(0, "call", fn=lambda r: None)
            r = P.drill.DrillRunner(_fake_cluster([]), c,
                                    invariants=[_AlwaysViolates()],
                                    registry=P.registry.MetricsRegistry())
            r.step_once()
            back = json.loads(json.dumps(r.report().to_dict()))
            assert back["clean"] is False
            assert back["invariant_violations"] == {"always": 1}
            assert back["violations"][0] == {
                "invariant": "always", "tick": 0, "detail": "forged breach"}
            return back

        both(case)

    def test_default_invariants_is_the_full_library(self):
        def case(P):
            names = [i.name for i in P.drill.default_invariants()]
            assert set(names) == {
                "no_silent_drop", "legal_lease_transitions",
                "monotone_watermarks", "bounded_failover_lag",
                "ordered_replay", "consistent_counters",
            }
            return names

        both(case)


# ------------------------------------- seeded violations, one per checker
def _ctx(P, cluster, tick=0, now=0.0):
    return P.drill.DrillContext(cluster=cluster, tick=tick, now=now)


def _proxy(P, parking=None, live=(6,), conn_info=None, notices=None,
           conn_notices=None):
    return SimpleNamespace(
        parking=parking if parking is not None else P.failover.ParkingBuffer(),
        games=SimpleNamespace(servers={int(g): object() for g in live}),
        _conn_info=dict(conn_info or {}),
        notice_counts=dict(notices or {}),
        conn_notices=dict(conn_notices or {}),
    )


class TestNoSilentDrop:
    def test_dropped_frames_without_notice_violate(self):
        def case(P):
            pb = P.failover.ParkingBuffer(max_frames=1, deadline_s=60.0)
            pb.park("c1", 3, b"a", now=0.0)
            pb.park("c1", 3, b"b", now=0.0)  # overflow: oldest dropped
            assert pb.dropped_overflow == 1
            cluster = SimpleNamespace(proxy=_proxy(P, parking=pb))
            out = P.drill.NoSilentDrop().check(_ctx(P, cluster))
            assert out and "zero DROPPED notices" in out[0]
            cluster.proxy.notice_counts = {
                int(P.defines.SwitchNoticeCode.DROPPED): 1}
            clean = P.drill.NoSilentDrop().check(_ctx(P, cluster))
            assert clean == []
            return out

        both(case)

    def test_unbound_session_past_grace_violates(self):
        def case(P):
            inv = P.drill.NoSilentDrop(grace_samples=3)
            cluster = SimpleNamespace(proxy=_proxy(
                P, live=(16,), conn_info={"c9": {"game_id": 6}}))
            assert inv.check(_ctx(P, cluster)) == []
            assert inv.check(_ctx(P, cluster)) == []
            out = inv.check(_ctx(P, cluster))
            assert out and "no switch notice" in out[0]
            cluster.proxy.conn_notices = {
                "c9": [int(P.defines.SwitchNoticeCode.REHOMING)]}
            assert P.drill.NoSilentDrop(grace_samples=1).check(
                _ctx(P, cluster)) == []
            return out

        both(case)


class TestLegalLeaseTransitions:
    @staticmethod
    def _master(lease):
        return SimpleNamespace(
            lease_suspect_seconds=1.0, lease_down_seconds=2.0,
            registry={6: {6: SimpleNamespace(lease=lease)}})

    def test_up_to_down_with_tight_sampling_violates(self):
        def case(P):
            inv = P.drill.LegalLeaseTransitions()
            m = self._master("UP")
            cluster = SimpleNamespace(master=m)
            assert inv.check(_ctx(P, cluster, now=0.0)) == []
            m.registry[6][6].lease = "DOWN"
            out = inv.check(_ctx(P, cluster, now=0.01))
            assert out and "UP->DOWN" in out[0]
            return out

        both(case)

    def test_legal_path_is_clean(self):
        def case(P):
            inv = P.drill.LegalLeaseTransitions()
            m = self._master("UP")
            cluster = SimpleNamespace(master=m)
            outs = []
            for i, lease in enumerate(
                    ["UP", "SUSPECT", "DOWN", "UP", "SUSPECT", "UP"]):
                m.registry[6][6].lease = lease
                outs.append(inv.check(_ctx(P, cluster, now=0.01 * i)))
            assert outs == [[]] * 6
            return outs

        both(case)

    def test_coarse_gap_tolerates_skipped_suspect(self):
        def case(P):
            inv = P.drill.LegalLeaseTransitions()
            m = self._master("UP")
            cluster = SimpleNamespace(master=m)
            inv.check(_ctx(P, cluster, now=0.0))
            m.registry[6][6].lease = "DOWN"
            out = inv.check(_ctx(P, cluster, now=5.0))
            assert out == []
            return out

        both(case)

    def test_previous_gap_also_excuses_the_jump(self):
        def case(P):
            inv = P.drill.LegalLeaseTransitions()
            m = self._master("UP")
            cluster = SimpleNamespace(master=m)
            inv.check(_ctx(P, cluster, now=0.0))
            inv.check(_ctx(P, cluster, now=5.0))
            m.registry[6][6].lease = "DOWN"
            excused = inv.check(_ctx(P, cluster, now=5.01))
            assert excused == []
            m.registry[6][6].lease = "UP"
            inv.check(_ctx(P, cluster, now=5.02))
            m.registry[6][6].lease = "DOWN"
            out = inv.check(_ctx(P, cluster, now=5.03))
            assert out and "UP->DOWN" in out[0]
            return [excused, out]

        both(case)


class TestMonotoneWatermarks:
    @staticmethod
    def _cluster(seq, tick):
        wal = SimpleNamespace(flushed_seq=seq, flushed_tick=tick)
        game = SimpleNamespace(persist=SimpleNamespace(name="Game1", wal=wal))
        return SimpleNamespace(games=[game]), wal

    def test_seq_regression_violates(self):
        def case(P):
            inv = P.drill.MonotoneWatermarks()
            cluster, wal = self._cluster(5, 10)
            assert inv.check(_ctx(P, cluster)) == []
            wal.flushed_seq = 3
            out = inv.check(_ctx(P, cluster))
            assert out and "moved backwards" in out[0]
            return out

        both(case)

    def test_tick_regression_at_equal_seq_violates(self):
        def case(P):
            inv = P.drill.MonotoneWatermarks()
            cluster, wal = self._cluster(5, 10)
            inv.check(_ctx(P, cluster))
            wal.flushed_tick = 9
            out = inv.check(_ctx(P, cluster))
            assert out
            return out

        both(case)

    def test_disappear_then_restart_below_watermark_is_caught(self):
        def case(P):
            probe = {"store:g1": (7, 40)}
            inv = P.drill.MonotoneWatermarks(store_probe=lambda: dict(probe))
            cluster = SimpleNamespace(games=[])
            assert inv.check(_ctx(P, cluster)) == []
            probe.clear()
            assert inv.check(_ctx(P, cluster)) == []
            probe["store:g1"] = (2, 5)
            out = inv.check(_ctx(P, cluster))
            assert out and "7:40 -> 2:5" in out[0]
            return out

        both(case)

    def test_advancing_marks_are_clean(self):
        def case(P):
            inv = P.drill.MonotoneWatermarks()
            cluster, wal = self._cluster(1, 1)
            outs = []
            for seq in range(1, 5):
                wal.flushed_seq, wal.flushed_tick = seq, seq * 3
                outs.append(inv.check(_ctx(P, cluster)))
            assert outs == [[]] * 4
            return outs

        both(case)


class TestBoundedFailoverLag:
    @staticmethod
    def _cluster(lag):
        driver = SimpleNamespace(deadline_s=2.0, lag=lambda now: lag)
        return SimpleNamespace(world=SimpleNamespace(failover=driver))

    def test_lag_past_deadline_plus_slack_violates(self):
        def case(P):
            out = P.drill.BoundedFailoverLag(slack_s=0.5).check(
                _ctx(P, self._cluster(lag=2.6)))
            assert out and "exceeds deadline" in out[0]
            return out

        both(case)

    def test_lag_within_bound_is_clean(self):
        def case(P):
            out = P.drill.BoundedFailoverLag(slack_s=0.5).check(
                _ctx(P, self._cluster(lag=2.4)))
            assert out == []
            return out

        both(case)


class TestOrderedReplay:
    def test_scrambled_replay_violates_once(self):
        def case(P):
            pb = P.failover.ParkingBuffer(max_frames=16, deadline_s=60.0)
            for i in range(3):
                pb.park("c1", 3, b"m%d" % i, now=0.0)
            pb._q["c1"].rotate(1)  # last frame now replays first
            sent = []
            pb.replay("c1", lambda mid, body: sent.append(body) or True)
            assert pb.order_violations > 0
            inv = P.drill.OrderedReplay()
            cluster = SimpleNamespace(proxy=SimpleNamespace(parking=pb))
            out = inv.check(_ctx(P, cluster))
            assert out and "out of per-session" in out[0]
            assert inv.check(_ctx(P, cluster)) == []
            return {"out": out, "sent": sent,
                    "violations": pb.order_violations}

        both(case)

    def test_in_order_replay_is_clean(self):
        def case(P):
            pb = P.failover.ParkingBuffer(max_frames=16, deadline_s=60.0)
            for i in range(3):
                pb.park("c1", 3, b"m%d" % i, now=0.0)
            pb.replay("c1", lambda mid, body: True)
            assert pb.order_violations == 0
            cluster = SimpleNamespace(proxy=SimpleNamespace(parking=pb))
            out = P.drill.OrderedReplay().check(_ctx(P, cluster))
            assert out == []
            return out

        both(case)


class _FakeReg:
    """value()-only registry stand-in so counters can be forged."""

    def __init__(self, **vals):
        self.vals = dict(vals)

    def value(self, name, **labels):
        return float(self.vals.get(name, 0.0))


def _counters_cluster(P, reg, pending=0, parking=None):
    driver = SimpleNamespace(pending_count=lambda: pending)
    world = SimpleNamespace(failover=driver,
                            telemetry=SimpleNamespace(registry=reg))
    proxy = SimpleNamespace(
        parking=parking if parking is not None else P.failover.ParkingBuffer())
    return SimpleNamespace(world=world, proxy=proxy)


class TestConsistentCounters:
    def test_unbalanced_failover_bank_violates(self):
        def case(P):
            reg = _FakeReg(nf_failover_initiated_total=3.0,
                           nf_failover_completed_total=1.0,
                           nf_failover_deadline_exceeded_total=0.0)
            out = P.drill.ConsistentCounters().check(
                _ctx(P, _counters_cluster(P, reg, pending=1)))
            assert out and "failover bank not conserved" in out[0]
            return out

        both(case)

    def test_balanced_bank_is_clean(self):
        def case(P):
            reg = _FakeReg(nf_failover_initiated_total=3.0,
                           nf_failover_completed_total=2.0,
                           nf_failover_deadline_exceeded_total=0.0)
            out = P.drill.ConsistentCounters().check(
                _ctx(P, _counters_cluster(P, reg, pending=1)))
            assert out == []
            return out

        both(case)

    def test_parking_bank_not_conserved_violates(self):
        def case(P):
            pb = P.failover.ParkingBuffer(max_frames=16, deadline_s=60.0)
            pb.park("c1", 3, b"x", now=0.0)
            pb.parked_total += 1  # forge a leak: one frame unaccounted for
            out = P.drill.ConsistentCounters().check(
                _ctx(P, _counters_cluster(P, _FakeReg(), parking=pb)))
            assert out and "parking bank not conserved" in out[0]
            return out

        both(case)

    def test_busy_counter_going_backwards_violates(self):
        def case(P):
            reg = _FakeReg(nf_failover_busy_total=5.0)
            inv = P.drill.ConsistentCounters()
            cluster = _counters_cluster(P, reg)
            assert inv.check(_ctx(P, cluster)) == []
            reg.vals["nf_failover_busy_total"] = 3.0
            out = inv.check(_ctx(P, cluster))
            assert out and "busy_total went backwards" in out[0]
            return out

        both(case)

    def test_real_failover_bank_names_are_registered(self):
        # the checker reads the world's failover bank by name: the port's
        # FailoverDriver registers every series under JAX's names
        def case(P):
            reg = P.registry.MetricsRegistry()
            P.failover.FailoverDriver(SimpleNamespace(
                telemetry=SimpleNamespace(registry=reg)))
            names = ("nf_failover_initiated_total", "nf_failover_completed_total",
                     "nf_failover_deadline_exceeded_total", "nf_failover_busy_total")
            assert all(reg.get(n) is not None for n in names)
            return [ln for ln in reg.exposition().splitlines()
                    if ln.startswith("# TYPE nf_failover_")]

        both(case)


# ------------------------------------ chaos campaign primitives
class _Backend:
    """Write-behind StoreBackend seam stand-in."""

    def __init__(self):
        self.data = {}

    def write(self, key, blob):
        self.data[key] = blob

    def delete(self, key):
        self.data.pop(key, None)

    def ping(self):
        return True


class TestChaosCampaignPrimitives:
    def test_store_phase_exposes_op_clock_and_budgets(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(
                seed=7, stores={"game6.store": P.chaos.StoreFaults(fail_first=2)}))
            store = d.wrap_store(_Backend(), "game6.store")
            for _ in range(2):
                with pytest.raises(P.chaos.StoreFaultError):
                    store.write("k", b"v")
            store.write("k", b"v")
            ph = d.store_phase()["game6.store"]
            assert ph["ops_seen"] == 3 and ph["fails_injected"] == 2
            assert ph["fail_first_remaining"] == 0
            assert ph["down_active"] is None and ph["down_upcoming"] == []
            assert d.status()["store_phase"]["game6.store"]["ops_seen"] == 3
            return d.status()

        both(case)

    def test_store_phase_tracks_down_windows(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(
                seed=7, stores={"game6.store": P.chaos.StoreFaults(down=((2, 4),))}))
            store = d.wrap_store(_Backend(), "game6.store")
            store.write("a", b"1")
            store.write("b", b"2")
            first = d.store_phase()["game6.store"]
            assert first["down_active"] == [2, 4]
            assert first["down_remaining_ops"] == 2
            for _ in range(2):
                with pytest.raises(P.chaos.StoreFaultError):
                    store.write("c", b"3")
            store.write("c", b"3")
            ph = d.store_phase()["game6.store"]
            assert ph["downs_hit"] == 2
            assert ph["down_active"] is None and ph["down_upcoming"] == []
            return [first, ph]

        both(case)

    def test_set_store_faults_rearms_live_wrappers(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(seed=7))
            store = d.wrap_store(_Backend(), "game6.store")
            store.write("k", b"v")
            n = d.set_store_faults("game6.store", P.chaos.StoreFaults(fail_first=1))
            assert n == 1
            with pytest.raises(P.chaos.StoreFaultError):
                store.write("k", b"v")
            assert d.plan.stores["game6.store"].fail_first == 1
            return d.status()

        both(case)

    def test_heal_is_idempotent(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(
                seed=7,
                links={"proxy5.games": P.chaos.LinkFaults(dup=0.5)},
                stores={"game6.store": P.chaos.StoreFaults(fail_first=5)}))
            t = d.wrap(SimpleNamespace(), "proxy5.games->6")
            s = d.wrap_store(_Backend(), "game6.store")
            assert t.faults.any() and s.faults.any()
            healed = [d.heal("game6.store")]
            assert not s.faults.any() and t.faults.any()
            healed += [d.heal("game6.store"), d.heal(), d.heal()]
            assert healed == [1, 0, 1, 0]
            assert not t.faults.any()
            assert not d.plan.links and not d.plan.stores
            return healed

        both(case)

    def test_rewrap_does_not_nest_or_reset(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(
                seed=7, stores={"game6.store": P.chaos.StoreFaults(fail_first=1)}))
            backend = _Backend()
            s1 = d.wrap_store(backend, "game6.store")
            with pytest.raises(P.chaos.StoreFaultError):
                s1.write("k", b"v")
            s2 = d.wrap_store(s1, "game6.store")
            assert s2.inner is backend
            s2.write("k", b"v")
            assert d.store_phase()["game6.store"]["ops_seen"] == 2
            return d.store_phase()

        both(case)

    def test_consumed_budget_survives_heal_and_rearm(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(
                seed=7, stores={"game6.store": P.chaos.StoreFaults(fail_first=1)}))
            store = d.wrap_store(_Backend(), "game6.store")
            with pytest.raises(P.chaos.StoreFaultError):
                store.write("k", b"v")
            d.heal("game6.store")
            store.write("k", b"v")
            d.set_store_faults("game6.store", P.chaos.StoreFaults(fail_first=1))
            store.write("k", b"v")
            store2 = d.wrap_store(_Backend(), "game6.store")
            store2.write("k", b"v")
            assert d.store_phase()["game6.store"]["fails_injected"] == 1
            return d.store_phase()

        both(case)

    def test_set_link_faults_rearms_live_transports(self):
        def case(P):
            d = P.chaos.ChaosDirector(P.chaos.FaultPlan(seed=7))
            t = d.wrap(SimpleNamespace(), "proxy5.games->6")
            assert not t.faults.any()
            n = d.set_link_faults("proxy5.games", P.chaos.LinkFaults(dup=0.9))
            assert n == 1 and t.faults.dup == 0.9
            assert d.plan.links["proxy5.games"].dup == 0.9
            return d.plan

        both(case)


# --------------------------------- many-worlds room actions + isolation
def _room_cluster(log):
    """Forged cluster whose game role records room-action dispatch."""
    role = SimpleNamespace(
        config=SimpleNamespace(name="Game1"),
        create_room=lambda seed, room_id, control: log.append(
            ("create_room", seed, room_id, control)),
        destroy_room=lambda rid: log.append(("destroy_room", rid)),
        rehome_room=lambda rid: log.append(("rehome_room", rid)),
    )
    return SimpleNamespace(
        execute=lambda: log.append(("pump",)),
        chaos=None,
        roles=[role],
    )


class TestRoomActions:
    def test_room_actions_dispatch_with_kwargs(self):
        def case(P):
            log = []
            c = (P.drill.Campaign("t")
                 .add(0, "create_room", role="Game1", seed=7, room_id=3,
                      control=True)
                 .add(1, "rehome_room", role="Game1", room_id=3)
                 .add(2, "destroy_room", role="Game1", room_id=3))
            r = P.drill.DrillRunner(_room_cluster(log), c, invariants=[],
                                    registry=P.registry.MetricsRegistry())
            for _ in range(3):
                r.step_once()
            assert log == [
                ("create_room", 7, 3, True), ("pump",),
                ("rehome_room", 3), ("pump",),
                ("destroy_room", 3), ("pump",),
            ]
            return {"log": log, "report": _report_json(r)}

        both(case)

    def test_room_actions_are_builtin(self):
        def case(P):
            return [P.drill.Campaign("t").add(0, action, role="Game1",
                                              room_id=1).describe()
                    for action in ("create_room", "destroy_room", "rehome_room")]

        both(case)


def _room_game(digests, controls=(1,), rooms=None, tick=5, calls=None):
    """Forged game role hosting a rooms-directory stand-in.

    ``digests`` maps room_id -> (live, want)."""
    calls = calls if calls is not None else []

    def digest(rid):
        calls.append(("digest", rid))
        return digests[rid][0]

    directory = SimpleNamespace(
        controls={rid: object() for rid in controls},
        rooms=dict(rooms if rooms is not None
                   else {rid: rid for rid in controls}),
        batch=SimpleNamespace(tick_count=tick),
        digest=digest,
        control_digest=lambda rid: digests[rid][1],
    )
    return SimpleNamespace(config=SimpleNamespace(name="Game1"),
                           rooms=directory)


class TestRoomIsolation:
    def test_divergent_room_violates(self):
        def case(P):
            game = _room_game({1: (0xAA, 0xAA), 2: (0xDEAD, 0xBEEF)},
                              controls=(1, 2))
            out = P.drill.RoomIsolation().check(
                _ctx(P, SimpleNamespace(games=[game])))
            assert len(out) == 1 and "room 2" in out[0]
            assert "cross-room leak" in out[0]
            return out

        both(case)

    def test_lockstep_rooms_are_clean_and_roomless_games_skipped(self):
        def case(P):
            game = _room_game({1: (0x5150, 0x5150)})
            bare = SimpleNamespace(config=SimpleNamespace(name="Game2"))
            out = P.drill.RoomIsolation().check(
                _ctx(P, SimpleNamespace(games=[game, bare])))
            assert out == []
            return out

        both(case)

    def test_static_batch_is_not_redigested(self):
        def case(P):
            calls = []
            game = _room_game({1: (7, 7)}, calls=calls)
            inv = P.drill.RoomIsolation()
            inv.check(_ctx(P, SimpleNamespace(games=[game]), tick=0))
            inv.check(_ctx(P, SimpleNamespace(games=[game]), tick=1))
            assert calls == [("digest", 1)]
            game.rooms.batch.tick_count = 6
            inv.check(_ctx(P, SimpleNamespace(games=[game]), tick=2))
            assert calls == [("digest", 1), ("digest", 1)]
            return calls

        both(case)

    def test_sample_every_gates_drill_ticks(self):
        def case(P):
            calls = []
            game = _room_game({1: (7, 7)}, calls=calls)
            inv = P.drill.RoomIsolation(sample_every=4)
            for t in range(4):
                game.rooms.batch.tick_count = 5 + t
                inv.check(_ctx(P, SimpleNamespace(games=[game]), tick=t))
            assert calls == [("digest", 1)]
            return calls

        both(case)

    def test_destroyed_room_with_straggler_control_skipped(self):
        def case(P):
            calls = []
            game = _room_game({1: (1, 2)}, controls=(1,), rooms={},
                              calls=calls)
            out = P.drill.RoomIsolation().check(
                _ctx(P, SimpleNamespace(games=[game])))
            assert out == [] and calls == []
            return out

        both(case)


# ---------------------------- StableUnderReshard (tests/test_elastic.py)
def _forged_elastic_cluster(status, digest=None, tick=10):
    elastic = SimpleNamespace(status=lambda: status, digest=lambda: digest)
    game = SimpleNamespace(
        elastic=elastic,
        kernel=SimpleNamespace(tick_count=tick),
        config=SimpleNamespace(name="game6"),
    )
    return SimpleNamespace(games=[game])


def _healthy_status(**over):
    st = {
        "devices": 2, "inflight": None, "stage": None,
        "exodus_ticks": 3, "exodus_tick_bound": 64,
        "dropped_rows": 0, "rows_moved_total": 5,
        "pop": 24, "pop_baseline": 24,
        "resharded_total": 1, "generation": 4,
    }
    st.update(over)
    return st


class TestStableUnderReshard:
    def test_stable_under_reshard_clean_cluster_is_silent(self):
        def case(P):
            inv = P.drill.StableUnderReshard()
            out = [inv.check(_ctx(P, _forged_elastic_cluster(_healthy_status())))]
            plain = SimpleNamespace(games=[SimpleNamespace(elastic=None)])
            out.append(inv.check(_ctx(P, plain)))
            assert out == [[], []]
            return out

        both(case)

    def test_stable_under_reshard_flags_forged_breaches(self):
        def case(P):
            inv = P.drill.StableUnderReshard()

            def check(**over):
                return inv.check(_ctx(P, _forged_elastic_cluster(
                    _healthy_status(**over))))

            outs = [check(dropped_rows=2), check(pop=23),
                    check(inflight="drain", exodus_ticks=99),
                    check(inflight="grow", pop=23)]
            assert outs[0] and "dropped 2 row" in outs[0][0]
            assert outs[1] and "population not conserved" in outs[1][0]
            assert outs[2] and "exodus lag 99" in outs[2][0]
            assert outs[3] == []  # in-flight ops defer the pop clause
            return outs

        both(case)

    def test_stable_under_reshard_digest_clause_pins_control(self):
        def case(P):
            control = SimpleNamespace(tick_count=8, advance_to=lambda t: 0xAB)
            inv = P.drill.StableUnderReshard(control=control)
            ok = inv.check(_ctx(P, _forged_elastic_cluster(
                _healthy_status(), digest=0xAB, tick=10)))
            assert ok == []
            inv2 = P.drill.StableUnderReshard(control=control)
            cluster = _forged_elastic_cluster(_healthy_status(), digest=0xCD,
                                              tick=10)
            bad = inv2.check(_ctx(P, cluster))
            assert bad and "digest diverged" in bad[0]
            # each tick is checked once: a second sample at the same tick
            # neither re-runs nor re-flags the digest
            again = inv2.check(_ctx(P, cluster))
            assert again == []
            return [ok, bad, again]

        both(case)


# ----------------------------------------------------- the flagship drill
def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def fixed_view(checks: dict, reports: list) -> dict:
    """What a wall-paced campaign fixes: each check's verdict, the
    campaign, the fired steps and the violation count."""
    (rep,) = reports
    return {
        "checks": dict(checks),
        "campaign": json.loads(json.dumps(rep.campaign)),
        "fired": [(a["tick"], a["action"], a["label"]) for a in rep.actions_fired],
        "violations": len(rep.violations),
    }


def run_campaign(monkeypatch, P, script: str, tmp_path, **kw) -> dict:
    """Run ``script``'s campaign and keep the drill's report."""
    reports = []
    runner = P.drill.DrillRunner
    report = runner.report
    monkeypatch.setattr(runner, "report",
                        lambda self: reports.append(report(self)) or reports[-1])
    checks = _load_script(script).run(tmp_path, **kw)
    monkeypatch.setattr(runner, "report", report)
    return fixed_view(checks, reports)


class TestGamedayE2E:
    def test_gameday_short_campaign(self, monkeypatch, tmp_path):
        port = run_campaign(monkeypatch, PKGS["torch"], "torch_gameday_smoke",
                            tmp_path / "torch", seed=7, sessions=6, chats=3,
                            device="cpu")
        failed = [name for name, ok in port["checks"].items() if not ok]
        assert not failed
        assert port["violations"] == 0
        assert [f[0] for f in port["fired"]] == [0, 5, 10, 15, 20, 120, 125]
        ref = run_campaign(monkeypatch, PKGS["jax"], "gameday_smoke",
                           tmp_path / "jax", seed=7, sessions=6, chats=3)
        assert port == ref
