"""Seeded, tick-indexed fault-campaign schedules.

A campaign is a declarative list of ``(at_tick, action)`` steps.  The
clock is the **drill tick** — one tick per :meth:`DrillRunner.step_once`
pump pass — never wall time: the same campaign over the same cluster
fires the same actions at the same points in the event stream, which is
what makes a game-day drill a regression test instead of an anecdote.
This module must not reference the ``time`` module at all.

Built-in actions (resolved by the runner against its cluster):

=================  ====================================================
``kill_role``      ``role=<config name>, hard=True`` → ``cluster.kill_role``
``revive_role``    ``name=<config name>, resume=True, world_factory=fn``
``heal``           ``pattern=None`` → ``cluster.chaos.heal(pattern)``
``store_faults``   ``pattern=, faults=StoreFaults(...)`` → live re-arm
``link_faults``    ``pattern=, faults=LinkFaults(...)`` → live re-arm
``checkpoint``     ``role=<config name>`` → ``role.checkpoint_now()``
``grow_mesh``      ``role=<config name>, n=<devices>`` → ``role.grow_mesh``
``drain_device``   ``role=<config name>, device=<index>`` →
                   ``role.drain_device``
``create_room``    ``role=<config name>, seed=, room_id=, control=`` →
                   ``role.create_room`` (many-worlds engine)
``destroy_room``   ``role=<config name>, room_id=`` → ``role.destroy_room``
``rehome_room``    ``role=<config name>, room_id=`` → ``role.rehome_room``
``call``           ``fn=<callable(runner)>`` — surge traffic, asserts, …
``note``           no-op marker; lands in the report's action log
=================  ====================================================

Steps at the same tick fire in insertion order.  ``kwargs`` may hold
live objects (fault dataclasses, world factories); :meth:`Campaign.
describe` renders them safely for the report/``/json``.

A copy of ``noahgameframe_tpu/drill/schedule.py``, which imports no jax: the
port keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

#: action names the runner knows how to fire (anything else must be a
#: ``call`` step); kept here so schedules can be validated at build time
BUILTIN_ACTIONS = (
    "kill_role",
    "revive_role",
    "heal",
    "store_faults",
    "link_faults",
    "checkpoint",
    "grow_mesh",
    "drain_device",
    "create_room",
    "destroy_room",
    "rehome_room",
    "call",
    "note",
)


@dataclasses.dataclass(frozen=True)
class Step:
    """One scheduled action: fire ``action(**kwargs)`` when the drill
    clock reaches ``at_tick`` (fires before that tick's pump pass)."""

    at_tick: int
    action: str
    kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    label: str = ""

    def describe(self) -> Dict[str, object]:
        """JSON-safe rendering (kwargs may hold callables/dataclasses)."""

        def safe(v: object) -> object:
            if isinstance(v, (int, float, str, bool)) or v is None:
                return v
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return dataclasses.asdict(v)
            if callable(v):
                return f"<callable {getattr(v, '__name__', repr(v))}>"
            return repr(v)

        return {
            "at_tick": int(self.at_tick),
            "action": self.action,
            "label": self.label,
            "kwargs": {k: safe(v) for k, v in self.kwargs.items()},
        }


class Campaign:
    """An ordered, seeded schedule of :class:`Step`\\ s.

    The seed does not drive the schedule itself (that is fully explicit)
    — it is the campaign's *identity* seed, recorded in the report and
    conventionally shared with the cluster's :class:`FaultPlan` so one
    number reproduces the whole run."""

    def __init__(self, name: str, seed: int = 0,
                 steps: Iterable[Step] = ()) -> None:
        self.name = str(name)
        self.seed = int(seed)
        self._steps: List[Step] = list(steps)
        for s in self._steps:
            self._validate(s)

    @staticmethod
    def _validate(step: Step) -> None:
        if step.at_tick < 0:
            raise ValueError(f"step {step.label or step.action}: "
                             f"at_tick must be >= 0, got {step.at_tick}")
        if step.action not in BUILTIN_ACTIONS:
            raise ValueError(
                f"unknown action {step.action!r}; use one of "
                f"{BUILTIN_ACTIONS} (arbitrary work goes through 'call')"
            )

    # ------------------------------------------------------------ build
    def add(self, at_tick: int, action: str, label: str = "",
            **kwargs: object) -> "Campaign":
        """Builder-style append; returns self for chaining."""
        step = Step(int(at_tick), action, dict(kwargs), label)
        self._validate(step)
        self._steps.append(step)
        return self

    # ------------------------------------------------------------ query
    @property
    def steps(self) -> List[Step]:
        """Steps in firing order: by tick, insertion order within a
        tick (Python's sort is stable)."""
        return sorted(self._steps, key=lambda s: s.at_tick)

    @property
    def horizon(self) -> int:
        """The last scheduled tick (0 for an empty campaign)."""
        return max((s.at_tick for s in self._steps), default=0)

    def __len__(self) -> int:
        return len(self._steps)

    def describe(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "seed": self.seed,
            "horizon": self.horizon,
            "steps": [s.describe() for s in self.steps],
        }


def merged(name: str, seed: int,
           *parts: Tuple[int, Campaign]) -> Campaign:
    """Compose campaigns: each ``(offset, campaign)`` part's steps are
    shifted by ``offset`` ticks into one schedule — e.g. a store-outage
    campaign overlaid on a kill/revive campaign."""
    out = Campaign(name, seed)
    for offset, part in parts:
        for s in part.steps:
            out.add(s.at_tick + int(offset), s.action,
                    label=s.label or f"{part.name}:{s.action}", **s.kwargs)
    return out
