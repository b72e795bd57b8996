"""Structural thread/clock contracts: the JAX package's
``lint/rules_contracts.py``, rule for rule.  The port keeps the same
files at the same paths (the journal tap still lives on ``GameRole`` in
``net/roles/game.py``), so scopes and messages carry over unchanged.

These rules are scoped to the specific files whose *shape* is the
contract: the write-behind pump surface, the failover parking path, the
drill clock discipline, and the journal tap's trace-sidecar guard.  A
vanished class or method is itself a finding — the contract silently
evaporating is exactly what the original tests defended against.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Tuple

from .engine import Rule, dotted_name

# -- write-behind pump surface -------------------------------------------

PUMP_METHODS = {"enqueue", "enqueue_one", "note_tick", "barrier", "pump",
                "pending", "discard", "lag_ticks", "queue_depth",
                "degraded"}
SYNC_ALLOWED = {"barrier", "drain", "close", "kill"}

# -- failover parking path -----------------------------------------------

PARKING_METHODS = {"park", "expire", "replay", "discard", "depth", "keys"}
PROXY_PARKING_SURFACE = {"_parking_pump", "_on_client_message",
                         "_on_switch_route", "_notify_switch"}
_BLOCKING = ("sleep", "fsync", "open", "connect", "recv", "accept")

# -- drill clock discipline ----------------------------------------------

DRILL_CLOCKLESS = ("drill/schedule.py", "drill/invariants.py")
RUNNER_CLOCK_ALLOWED = {"monotonic", "sleep"}


def _class_methods(tree, class_name: str) -> Optional[Dict]:
    for n in tree.body:
        if isinstance(n, ast.ClassDef) and n.name == class_name:
            return {m.name: m for m in n.body
                    if isinstance(m, ast.FunctionDef)}
    return None


def _calls(fn) -> Iterator[Tuple[int, str]]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            dotted = dotted_name(node.func)
            if dotted is not None:
                yield node.lineno, dotted


def _blocking_calls(fn) -> Iterator[Tuple[int, str]]:
    for line, dotted in _calls(fn):
        if dotted.rsplit(".", 1)[-1] in _BLOCKING:
            yield line, dotted


class PumpSurfaceRule(Rule):
    """The per-tick pump surfaces never block: WriteBehindPipeline's
    pump-thread methods touch no store and never sleep (the flusher
    thread's ``_flush_batch`` is the single store caller), and the
    proxy-side ParkingBuffer/parking pump — which every OTHER client's
    traffic waits behind — makes no blocking call."""

    name = "pump-surface"
    description = ("Write-behind pump methods: no store/sleep; "
                   "_flush_batch owns all store I/O.  ParkingBuffer and "
                   "the proxy parking pump: no blocking calls.")
    scope = ("persist/writebehind.py", "net/failover.py",
             "net/roles/proxy.py")

    def check_module(self, module, ctx):
        if module.rel.endswith("persist/writebehind.py") \
                or module.rel == "persist/writebehind.py":
            self._check_writebehind(module)
        elif module.rel.endswith("failover.py"):
            self._check_parking(module)
        elif module.rel.endswith("proxy.py"):
            self._check_proxy(module)

    def _check_writebehind(self, module):
        methods = _class_methods(module.tree, "WriteBehindPipeline")
        if methods is None:
            self.flag(1, "WriteBehindPipeline class vanished — the "
                      "pump-surface contract has nothing to hold onto")
            return
        missing = PUMP_METHODS - set(methods)
        if missing:
            self.flag(1, "pump-thread methods vanished: "
                      f"{sorted(missing)}")
        for name in sorted(PUMP_METHODS & set(methods)):
            for line, dotted in _calls(methods[name]):
                if dotted.startswith("self.backend.") \
                        or dotted == "self._flush_batch" \
                        or dotted.endswith(".sleep") or dotted == "sleep":
                    self.flag(line, f"store/sleep call `{dotted}` on the "
                              f"pump-thread surface ({name})")
        store_callers = {
            name for name, fn in methods.items()
            if any(d.startswith("self.backend.") for _, d in _calls(fn))
        }
        if store_callers - {"_flush_batch"}:
            for name in sorted(store_callers - {"_flush_batch"}):
                self.flag(methods[name].lineno,
                          f"`{name}` calls the store directly — "
                          "_flush_batch (flusher thread) must own every "
                          "store call")

    def _check_parking(self, module):
        methods = _class_methods(module.tree, "ParkingBuffer")
        if methods is None:
            self.flag(1, "ParkingBuffer class vanished — the parking "
                      "no-blocking contract has nothing to hold onto")
            return
        missing = PARKING_METHODS - set(methods)
        if missing:
            self.flag(1, f"parking methods vanished: {sorted(missing)}")
        for name in sorted(PARKING_METHODS & set(methods)):
            for line, dotted in _blocking_calls(methods[name]):
                self.flag(line, f"blocking call `{dotted}` inside "
                          f"ParkingBuffer.{name}")

    def _check_proxy(self, module):
        methods = _class_methods(module.tree, "ProxyRole")
        if methods is None:
            return  # fixture proxies without the class are out of scope
        for name in sorted(PROXY_PARKING_SURFACE):
            if name not in methods:
                self.flag(1, f"proxy parking surface lost `{name}`")
                continue
            for line, dotted in _blocking_calls(methods[name]):
                self.flag(line, f"blocking call `{dotted}` on the proxy "
                          f"parking path ({name})")


class FsyncBarrierRule(Rule):
    """WAL fsync only at barrier/drain/close/kill — per-tick fsync puts
    disk latency on the tick path."""

    name = "fsync-barrier"
    description = ("Only WriteBehindPipeline.barrier/drain/close/kill may "
                   "fsync the WAL.")
    scope = ("persist/writebehind.py",)

    def check_module(self, module, ctx):
        methods = _class_methods(module.tree, "WriteBehindPipeline")
        if methods is None:
            return  # PumpSurfaceRule already reports the vanished class
        for name, fn in methods.items():
            if name in SYNC_ALLOWED:
                continue
            for line, dotted in _calls(fn):
                if dotted in ("self.wal.sync", "os.fsync"):
                    self.flag(line, f"per-tick WAL fsync in `{name}` "
                              "(disk latency on the tick path)")


class DrillClocklessRule(Rule):
    """Campaign schedules/invariants reference no clock AT ALL; the
    runner touches monotonic()/sleep() pacing only."""

    name = "drill-clockless"
    description = ("drill/schedule.py + drill/invariants.py must not "
                   "reference the time module; drill/runner.py only "
                   "monotonic/sleep.")
    scope = ("drill/schedule.py", "drill/invariants.py", "drill/runner.py")

    def check_module(self, module, ctx):
        clockless = any(module.rel.endswith(f) or module.rel == f
                        for f in DRILL_CLOCKLESS)
        aliases = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        aliases.add(a.asname or a.name)
                        if clockless:
                            self.flag(node, "import time — campaign "
                                      "schedules/invariants are "
                                      "tick-indexed by contract")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if clockless or a.name not in RUNNER_CLOCK_ALLOWED:
                        self.flag(node, f"from time import {a.name} — "
                                  "beyond the drill clock contract")
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                dotted = dotted_name(node)
                if dotted is None or dotted.split(".")[0] not in aliases:
                    continue
                leaf = dotted.split(".")[-1]
                if clockless:
                    self.flag(node, f"clock reference `{dotted}` — "
                              "schedules/invariants must be clockless")
                elif leaf not in RUNNER_CLOCK_ALLOWED:
                    self.flag(node, f"clock use `{dotted}` beyond "
                              "monotonic/sleep pacing")


class JournalTapGuardRule(Rule):
    """FRAME_TRACE sidecars must never enter the journal: the tap's
    event writes stay guarded by a TRACE_MSG_IDS membership test, so
    replay is bit-identical with tracing on or off."""

    name = "journal-tap-guard"
    description = ("GameRole._journal_tap's journal writes must be "
                   "guarded by TRACE_MSG_IDS.")
    scope = ("net/roles/game.py",)

    def check_module(self, module, ctx):
        methods = _class_methods(module.tree, "GameRole")
        if methods is None or "_journal_tap" not in (methods or {}):
            self.flag(1, "GameRole._journal_tap vanished — the trace "
                      "journal-exclusion contract has nothing to hold onto")
            return
        outer = methods["_journal_tap"]
        tap = next((n for n in ast.walk(outer)
                    if isinstance(n, ast.FunctionDef) and n.name == "tap"),
                   None)
        if tap is None:
            self.flag(outer.lineno, "_journal_tap no longer defines the "
                      "`tap` closure")
            return
        writes = [n for n in ast.walk(tap)
                  if isinstance(n, ast.Call)
                  and dotted_name(n.func) is not None
                  and dotted_name(n.func).endswith(".event")]
        if not writes:
            self.flag(tap.lineno, "journal tap no longer writes events")
            return
        guarded = [
            n for n in ast.walk(tap)
            if isinstance(n, ast.If)
            and any(isinstance(x, ast.Name) and x.id == "TRACE_MSG_IDS"
                    for x in ast.walk(n.test))
            and any(w in ast.walk(n) for w in writes)
        ]
        if not guarded:
            self.flag(tap.lineno, "journal writes are not guarded by a "
                      "TRACE_MSG_IDS test — trace sidecars would enter "
                      "the journal and break replay identity between "
                      "traced and untraced runs")
