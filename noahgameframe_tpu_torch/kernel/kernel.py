"""The kernel: the world tick, and the death end of the object lifecycle.

Counterpart of ``noahgameframe_tpu/kernel/kernel.py``.  The JAX package
traces ``Kernel._trace_step`` into one compiled function; here the same
step runs on the world's device (:meth:`Kernel._step`):

    schedule advance -> registered module phases in order ->
    flag-masked diff extraction + death masks -> packed summary vector

The per-tick counter bank (``ctx.count`` values plus the kernel's own
counters, packed in sorted name order) and the optional ``state_digest``
ride one summary tensor, the only thing :meth:`Kernel.tick` copies to the
host.  Each phase runs under ``torch.profiler.record_function``
(``nf.schedule``, ``nf.phase.<name>``, ``nf.diff``), so a profiler trace
names the stage of every device launch.

The entry points dispatch through the kernel's :class:`CostBook`:

- :meth:`tick` (``kernel.step``) runs one observed step: eagerly, or,
  after :meth:`set_graph_tick` on a CUDA device, as a captured CUDA graph
  (what the game role's frames run);
- :meth:`run_device` (``kernel.run``) advances n steps with no host sync.
  On a CUDA device the step is captured once as a CUDA graph and replayed
  n times; the JAX package's ``lax.fori_loop`` dispatch becomes that
  replay.  ``graph=False`` runs the eager loop instead;
- :meth:`train` (``kernel.train``) runs K observed steps per dispatch
  (one CUDA graph of K steps on a card), each tick's lanes stacked into
  ``[K, ...]`` buffers and one ``[K, L]`` summary fetched per dispatch.

Anything the step closes over on the host (a bucket, an engine, the
digest, K) is part of each capture's key, and :meth:`invalidate` drops
every captured graph and the registered aux entries, as the JAX package
drops its compiled tick.  Once a ``ShardedKernel`` (parallel/shard.py)
has placed the world on a mesh, the three entry points run its sharded
step, and ``state`` reads the shards' blocks back as one state.

The host control plane is the JAX package's: ``create_object`` runs the
seven-event create chain, ``destroy_object`` fires BEFORE_DESTROY and
DESTROY (or defers to the end of the frame, flushed by :meth:`execute`),
and ``set_property`` fires host property subscribers synchronously.
Deaths found on the device free their rows on the host and fire
``ObjectEvent.DESTROY``; property subscribers also hear the tick's
changes through its diff masks, which cover the ``diff_flags`` columns
plus any column opted in by :meth:`force_diff_property`.  A record with a
:meth:`register_record_diff` subscriber gets an int8 ``[C, R]`` code
lane per tick (``REC_ADDED``/``REMOVED``/``UPDATED``), fetched only when
the summary counts a change.  Both change what the step computes, so
they invalidate it and are part of every capture's key.  Not ported
here: journaling.
"""

from __future__ import annotations

import contextlib
import enum
from fnmatch import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.datatypes import Bank, Guid, Value
from ..core.device import resolve_device
from ..core.element import ElementStore
from ..core.prng import MASK32, fold_in
from ..core.schema import ClassRegistry
from ..core.store import EntityStore, StoreConfig, WorldState
from ..core.tree import flatten, unflatten
from ..ops.stencil_cuda import KERNELS
from ..telemetry.costbook import CostBook
from ..telemetry.tracing import device_annotation as _annotate
from .events import DeviceEvent, EventModule
from .module import Module, Phase
from .schedule import ScheduleModule


class ObjectEvent(enum.IntEnum):
    """Create/destroy state chain (reference COE_* states, NFIObject.h:22-30)."""

    CREATE_NODATA = 0
    CREATE_LOADDATA = 1
    CREATE_BEFORE_EFFECT = 2
    CREATE_EFFECTDATA = 3
    CREATE_AFTER_EFFECT = 4
    CREATE_HASDATA = 5
    CREATE_FINISH = 6
    BEFORE_DESTROY = 7
    DESTROY = 8


ClassEventFn = Callable[[Guid, str, "ObjectEvent"], None]
PropertyEventFn = Callable[[str, str, np.ndarray], None]  # (class, prop, changed_rows)
# (class, record, codes[C, R] int8) — 0 none, 1 added, 2 removed, 3 updated
RecordDiffFn = Callable[[str, str, np.ndarray], None]

REC_NONE, REC_ADDED, REC_REMOVED, REC_UPDATED = 0, 1, 2, 3

# Every per-tick output lane of Kernel._step that host code consumes must
# match one of these patterns (or appear in TRAIN_EXCLUDED): a K-tick
# train stacks exactly these lanes into [K, ...] buffers, and a lane
# missing from the stack would lose its per-tick history inside a train.
# _assert_train_lanes enforces it.
TRAIN_LANE_SPEC = (
    "fired",
    "diff",
    "diff_count",
    "rec_diff",
    "rec_diff_count",
    "died",
    "died_count",
    "events",
    "summary",
)

# Out lanes waived from train stacking (none: every per-tick output is
# host-consumed), as in the JAX package.
TRAIN_EXCLUDED: Tuple[str, ...] = ()


def _assert_train_lanes(out: Dict[str, object]) -> None:
    """Coverage check of the train's stacked lane set, both directions: a
    lane no pattern names (a new per-tick output without a train fate), or
    a pattern no lane matches (stale)."""
    spec = TRAIN_LANE_SPEC + TRAIN_EXCLUDED
    unlisted = [k for k in out if not any(fnmatch(k, p) for p in spec)]
    stale = [p for p in spec if not any(fnmatch(k, p) for k in out)]
    if unlisted or stale:
        raise AssertionError(
            "TRAIN_LANE_SPEC drift: "
            f"unlisted out lanes {unlisted}, stale patterns {stale}"
        )


# multiplier for the rolling state-digest fold (odd, so it is invertible
# mod 2^32 and single-bit flips diffuse instead of cancelling)
_DIGEST_MULT = 1000003
_DIGEST_SEED = 0x9E3779B9
# elements per digest partial sum: bounds the int64 temporaries, and keeps
# every partial sum of products (< 2^32 each) far below 2^63
_DIGEST_CHUNK = 1 << 24


def _digest_u32(x: torch.Tensor) -> torch.Tensor:
    """Any bank as int64 holding its uint32 words, bit-exactly for f32."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    if x.dtype == torch.float32:
        # nf-lint: disable=capture-safety -- no vmapped step digests: the
        # rooms engine steps with digest_in_step=False and digests all
        # rooms after its vmap (state_digest(..., rooms=True))
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


def _fold(acc: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """``acc * MULT + sum(u32(x_i) * (2i + 1))``, all mod 2^32, per row of
    ``acc``'s shape: ``acc`` 0-dim folds all of ``arr``, ``acc`` [R] folds
    each room of ``arr`` [R, ...] apart."""
    lead = acc.shape
    x = _digest_u32(arr).reshape(*lead, -1)
    cols = x.shape[-1]
    step = max(1, _DIGEST_CHUNK // max(1, acc.numel()))
    total = torch.zeros(lead, dtype=torch.int64, device=acc.device)
    for start in range(0, cols, step):
        part = x[..., start:start + step]
        w = torch.arange(start, start + part.shape[-1], dtype=torch.int64,
                         device=acc.device) * 2 + 1
        total = (total + ((part * w) & MASK32).sum(-1)) & MASK32
    return (acc * _DIGEST_MULT + total) & MASK32


def state_digest(state: WorldState, class_order: Sequence[str],
                 rooms: bool = False) -> torch.Tensor:
    """One uint32 digest of the whole world (int64 0-dim tensor), equal to
    the JAX package's ``state_digest`` of the same state: position-weighted
    modular sums per bank, folded across banks with a rolling multiply.
    ``WorldState.aux`` is excluded, as there.  ``rooms=True`` takes a
    batch of rooms (every leaf with a leading room axis, parallel/rooms.py)
    and returns each room's digest ([R] int64); the room axis is written
    out rather than vmapped, because reading a float32 bank's bits is a
    dtype view, which ``torch.func.vmap`` does not batch on every torch."""
    lead = tuple(state.tick.shape) if rooms else ()
    acc = torch.full(lead, _DIGEST_SEED, dtype=torch.int64, device=state.tick.device)
    acc = _fold(acc, state.tick)
    acc = _fold(acc, state.rng)
    for cname in class_order:
        cs = state.classes[cname]
        for arr in (cs.i32, cs.f32, cs.vec, cs.alive,
                    cs.timers.next_fire, cs.timers.interval,
                    cs.timers.remain, cs.timers.active):
            acc = _fold(acc, arr)
        for rname in sorted(cs.records):
            rec = cs.records[rname]
            for arr in (rec.i32, rec.f32, rec.vec, rec.used):
                acc = _fold(acc, arr)
    return acc


def _as_int32(u32: torch.Tensor) -> torch.Tensor:
    """uint32 value (int64) -> the int32 with the same bits."""
    return (u32 - ((u32 >> 31) << 32)).to(torch.int32)


class TickCtx:
    """Per-tick context handed to device phases."""

    def __init__(self, kernel: "Kernel", tick: torch.Tensor, rng: torch.Tensor,
                 fired_masks: Dict[str, torch.Tensor], shard=None):
        self.kernel = kernel
        self.store = kernel.store
        self.tick = tick
        self.dt = kernel.schedule.dt
        self._rng = rng
        self._rng_count = 0
        self._fired = fired_masks
        self.emitted: List[DeviceEvent] = []
        # named int32 0-dim tensors accumulated across phases; the kernel
        # packs them into the per-tick summary (counter bank)
        self._counters: Dict[str, torch.Tensor] = {}
        # counters given as a 0-dim value (the same on every shard of a
        # sharded tick, which keeps one) rather than summed over rows
        self._counter_scalar: set = set()
        # the shard this ctx steps in a sharded tick (parallel/shard.py
        # ShardInfo: mesh, index, row offsets), None on one device
        self.shard = shard

    def row_offset(self, class_name: str) -> int:
        """The global row index of this ctx's first row of ``class_name``:
        0 on one device and for a class a sharded tick replicates."""
        return 0 if self.shard is None else self.shard.row_offset(class_name)

    def fired(self, class_name: str, timer_name: str) -> torch.Tensor:
        """[C] bool — which entities' `timer_name` fired this tick."""
        slot = self.kernel.schedule.slot(class_name, timer_name)
        return self._fired[class_name][:, slot]

    def remap_fired(self, class_name: str, fired: torch.Tensor) -> None:
        """Republish a class's ``[C, T]`` fired mask after a phase moved its
        rows (cross-shard migration): the schedule computed the masks
        before the phases ran, and a fire must move with its row."""
        self._fired[class_name] = fired

    def rng(self) -> torch.Tensor:
        """A fresh PRNG key (deterministic per tick + call position)."""
        self._rng_count += 1
        return fold_in(self._rng, self._rng_count)

    def emit(self, event_id: int, class_name: str, mask: torch.Tensor,
             **params: torch.Tensor) -> None:
        """Emit a batch event; delivered to host subscribers after the tick."""
        self.emitted.append(DeviceEvent(int(event_id), class_name, mask, dict(params)))

    def count(self, name: str, value) -> None:
        """Accumulate into the tick's counter bank: bool masks and int
        vectors are summed to one int32 scalar."""
        v = value if isinstance(value, torch.Tensor) else torch.full(
            (), int(value), dtype=torch.int32, device=self.tick.device)
        if v.dim():
            # a per-row value: a shard's part of the sum over all rows
            v = torch.sum(v, dtype=torch.int32)
        else:
            self._counter_scalar.add(name)
            v = v.to(torch.int32)
        prev = self._counters.get(name)
        self._counters[name] = v if prev is None else prev + v


class TickOutputs:
    """What one observed tick returns: fired masks, flag-masked diff masks,
    death masks, the emitted events, the record-diff codes of subscribed
    records (class -> record -> ``[C, R]`` int8) with their per-class
    counts, and the decoded counter bank.  A train's frames are views of
    that dispatch's own ``[K, ...]`` lanes."""

    def __init__(self, fired, diff, diff_count, died, died_count, events,
                 rec_diff=None, rec_diff_count=None, counters=None):
        self.fired: Dict[str, torch.Tensor] = fired
        self.diff: Dict[str, Dict[str, torch.Tensor]] = diff
        self.diff_count: Dict[str, torch.Tensor] = diff_count
        self.died: Dict[str, torch.Tensor] = died
        self.died_count: Dict[str, torch.Tensor] = died_count
        self.events: List[DeviceEvent] = events
        self.rec_diff: Dict[str, Dict[str, torch.Tensor]] = rec_diff or {}
        self.rec_diff_count: Dict[str, torch.Tensor] = rec_diff_count or {}
        self.counters: Dict[str, int] = counters or {}


class Kernel(Module):
    """Owns the world: registry + store + state + the tick."""

    name = "KernelModule"

    def __init__(
        self,
        registry: ClassRegistry,
        store_config: Optional[StoreConfig] = None,
        dt: float = 1.0 / 30.0,
        seed: int = 0,
        class_names: Optional[Sequence[str]] = None,
        diff_flags: Tuple[str, ...] = ("public", "upload"),
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.registry = registry
        self.store_config = store_config or StoreConfig()
        self.schedule = ScheduleModule(dt=dt)
        self.events = EventModule()
        self.elements = ElementStore(registry)
        self._seed = seed
        self._class_names = class_names
        self._diff_flags = diff_flags
        self.store: Optional[EntityStore] = None
        # the ShardedKernel (parallel/shard.py) holding this world's rows
        # as per-shard blocks, or None; while set, ``state`` is assembled
        # from the blocks on read and written back to them lazily
        self.sharded = None
        self._state: Optional[WorldState] = None
        self._composed: List[Phase] = []
        self._modules: List[Module] = []
        self._diff_cols: Dict[str, Dict[str, torch.Tensor]] = {}
        self._class_event_subs: List[ClassEventFn] = []
        self._class_event_by_class: Dict[str, List[ClassEventFn]] = {}
        self._prop_event_subs: Dict[Tuple[str, str], List[PropertyEventFn]] = {}
        # class -> properties opted into diff extraction beyond diff_flags
        self._forced_diff: Dict[str, set] = {}
        self._rec_event_subs: Dict[Tuple[str, str], List[RecordDiffFn]] = {}
        self._pending_destroy: List[Guid] = []
        # the capture and launch ledger of every entry point (tick, run,
        # train); TelemetryModule.attach_kernel adopts it
        self.costbook = CostBook()
        self._step_fn = None
        self._run_fn = None
        self._train_fn = None
        self._train_k = 0
        self.train_dispatches = 0
        self.train_ticks = 0
        self.train_fetch_bytes = 0
        # bumped whenever the captured tick is dropped (invalidate,
        # set_phases), so a wrapper that captures its own variants of the
        # step (parallel/rooms.py RoomBatch) drops them too
        self._trace_gen = 0
        # module-registered carried tick state (WorldState.aux): name ->
        # zero-arg init fn, primed right before a dispatch and dropped by
        # invalidate() (aux layouts bake geometry such as buckets)
        self._aux_init: Dict[str, Callable[[], Any]] = {}
        # host metadata of the last step: counter and event names
        self._counter_names: Tuple[str, ...] = ()
        self._summary_len = 0
        self._event_meta: List[Tuple[int, str, Tuple[str, ...]]] = []
        self.tick_count = 0
        self.last_counters: Dict[str, int] = {}
        self.counter_totals: Dict[str, int] = {}  # cumulative over observed ticks
        self.digest_enabled = False
        # optional telemetry.SpanTracer for host spans; None = no cost
        self.tracer = None
        # honest per-stage timing (NF_STAGE_TIMING=1, set by GameRole from
        # telemetry/pipeline.stage_timing_enabled): synchronize after the
        # dispatch so the kernel.dispatch span measures device time, not
        # the launch.  Never on by default: it serializes the device queue
        self.stage_timing = False
        # observed ticks as a CUDA graph (set_graph_tick); off by default
        self.graph_tick = False

    @property
    def state(self) -> Optional[WorldState]:
        """The whole world state.  On a mesh (``sharded`` set) the blocks
        hold the newest rows after a sharded step, and reading assembles
        them first."""
        if self.sharded is not None:
            self.sharded.sync_host()
        return self._state

    @state.setter
    def state(self, value: Optional[WorldState]) -> None:
        self._state = value
        if self.sharded is not None:
            self.sharded.host_wrote()

    # -- build --------------------------------------------------------------

    def build(self, modules: Sequence[Module] = ()) -> None:
        """Freeze timer slots, construct the store + initial state, and
        collect device phases from ``modules``."""
        self.store_config.timer_slots = {
            **self.store_config.timer_slots, **self.schedule.freeze()
        }
        self.store = EntityStore(
            self.registry, self.store_config, strings=self.elements.strings,
            class_names=self._class_names, device=self.device,
        )
        self.state = self.store.init_state(self._seed)
        self._modules = list(modules)
        self.set_phases([p for m in modules for p in m.phases])
        for cname in self.store.class_order:
            self._diff_cols[cname] = self._diff_columns(cname)

    def _diff_columns(self, cname: str) -> Dict[str, torch.Tensor]:
        """The columns each bank's diff extraction keeps: the union of the
        ``diff_flags`` masks and the forced properties; a bank with none
        has no mask."""
        spec = self.store.spec(cname)
        cols = {}
        for bank in (Bank.I32, Bank.F32, Bank.VEC):
            fm = np.zeros(spec.bank_size(bank), bool)
            for fl in self._diff_flags:
                fm |= spec.mask(bank, fl)
            for pname in self._forced_diff.get(cname, ()):
                slot = spec.slot(pname)
                if slot.bank == bank:
                    fm[slot.col] = True
            if fm.any():
                cols[bank.value] = torch.from_numpy(fm).to(self.device)
        return cols

    def set_phases(self, phases: Sequence[Phase],
                   modules: Optional[Sequence[Module]] = None) -> None:
        """Replace the composed phase chain (drops every captured graph);
        ``modules``, when given, replaces the modules whose capture keys
        key the captures (a plugin reload)."""
        if modules is not None:
            self._modules = list(modules)
        # nf-lint: disable=recapture-hazard -- the phase chain is the
        # step's code, which no capture key can hold: this method drops
        # every captured graph itself and bumps the cost book's generation
        self._composed = sorted(phases, key=lambda p: p.order)
        self._step_fn = self._run_fn = self._train_fn = None
        self._trace_gen += 1
        self.costbook.generation_bump("set_phases")

    # -- captures, invalidation and carried aux state -------------------------

    def _statics(self) -> Dict[str, Any]:
        """The host values the step closes over: the capture key."""
        key: Dict[str, Any] = {
            "digest": self.digest_enabled,
            "forced_diff": tuple(sorted((c, tuple(sorted(ps)))
                                        for c, ps in self._forced_diff.items())),
            "rec_diff": tuple(sorted(self._rec_event_subs)),
        }
        for m in self._modules:
            key.update(m.capture_key())
        return key

    def _train_statics(self) -> Dict[str, Any]:
        return {**self._statics(), "train_k": self._train_k}

    def compile(self) -> None:
        if self._step_fn is None:
            graph = self.graph_tick and self.device.type == "cuda"
            self._step_fn = self.costbook.wrap(
                "kernel.step", lambda st: self._step(st, observe=True),
                stage="tick", statics=self._statics, graph=graph,
                launch_counters=KERNELS if graph else None)

    def set_graph_tick(self, on: bool) -> None:
        """Run :meth:`tick` / :meth:`tick_begin` as a CUDA graph on a card
        (a sanctioned re-capture when it changes).  Off by default; the
        graph's state banks are updated in place by each replay."""
        on = bool(on)
        if on != self.graph_tick:
            self.graph_tick = on
            if self._step_fn is not None:
                self._step_fn = None
                self.costbook.generation_bump(f"graph_tick:{int(on)}")

    def invalidate(self) -> None:
        """Drop every captured graph, and the registered aux entries, whose
        layouts bake the same geometry (a stale Verlet slot assignment must
        not outlive a bucket change).  Call after changing anything the
        phases close over; the next dispatch captures anew."""
        self._step_fn = None
        self._run_fn = None
        self._train_fn = None
        self._trace_gen += 1
        self.costbook.generation_bump("invalidate")
        if self._aux_init and self.state is not None and self.state.aux:
            kept = {k: v for k, v in self.state.aux.items() if k not in self._aux_init}
            if len(kept) != len(self.state.aux):
                self.state = self.state.replace(aux=kept)

    def enable_digest(self) -> None:
        """Turn on the per-tick ``state_digest`` counter (drops the
        captured tick, whose counter bank grows a slot)."""
        if not self.digest_enabled:
            self.digest_enabled = True
            self.invalidate()

    def register_aux(self, name: str, init_fn: Callable[[], Any]) -> None:
        """Register module-owned carried tick state (``WorldState.aux``):
        ``init_fn()`` builds it before the next dispatch and again after
        every :meth:`invalidate`."""
        self._aux_init[name] = init_fn

    def _ensure_aux(self) -> None:
        """Prime registered aux entries the state lacks, before a dispatch."""
        missing = [k for k in self._aux_init if k not in self.state.aux]
        if missing:
            aux = dict(self.state.aux)
            for k in missing:
                aux[k] = self._aux_init[k]()
            self.state = self.state.replace(aux=aux)

    def _span(self, name: str):
        """Host-side tracer span if a tracer is attached, else free."""
        if self.tracer is not None:
            return self.tracer.span(name)
        return contextlib.nullcontext()

    # -- the tick ------------------------------------------------------------

    def _step(self, state: WorldState, observe: bool = True, digest_in_step: bool = True):
        """One frame: ``(state', raw)``.  ``raw`` is the dict of per-tick
        lanes (TRAIN_LANE_SPEC) of an observed step; with ``observe=False``
        (run_device) it is None, as XLA drops those outputs from the JAX
        package's fused run loop.  ``digest_in_step=False`` leaves the
        ``state_digest`` lane 0 for the caller to fill (the rooms engine
        digests all rooms at once, outside its vmapped step)."""
        old = state
        state, ctx = self._begin_step(state)
        for phase in self._composed:
            with _annotate(f"nf.phase.{phase.name}"):
                state = phase.fn(state, ctx)
        state = state.replace(tick=state.tick + 1)
        if not observe:
            return state, None
        with _annotate("nf.diff"):
            lanes = self._class_lanes(old, state)
        diff, diff_count, rec_diff, rec_diff_count, died, died_count = lanes
        ev_counts = [torch.sum(e.mask, dtype=torch.int32) for e in ctx.emitted]
        counters = dict(ctx._counters)
        if self.digest_enabled:
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            counters["state_digest"] = _as_int32(
                state_digest(state, self.store.class_order)
            ) if digest_in_step else zero
        summary = self._pack_summary(ctx, state.tick, died_count, diff_count,
                                     rec_diff_count, ev_counts, counters)
        raw = {
            "fired": ctx._fired,
            "diff": diff,
            "diff_count": diff_count,
            "rec_diff": rec_diff,
            "rec_diff_count": rec_diff_count,
            "died": died,
            "died_count": died_count,
            "events": [(e.mask, e.params) for e in ctx.emitted],
            "summary": summary,
        }
        return state, raw

    def _begin_step(self, state: WorldState, shard=None) -> Tuple[WorldState, "TickCtx"]:
        """The schedule advance and the tick's context (``shard``: the
        ShardInfo of one shard of a sharded tick)."""
        fired: Dict[str, torch.Tensor] = {}
        new_classes = {}
        with _annotate("nf.schedule"):
            for cname in self.store.class_order:
                cs, f = self.schedule.advance_class(state.classes[cname], state.tick)
                new_classes[cname] = cs
                fired[cname] = f
            state = state.replace(classes=new_classes)
        rng = fold_in(state.rng, state.tick)
        return state, TickCtx(self, state.tick, rng, fired, shard)

    def _class_lanes(self, old: WorldState, state: WorldState):
        """Per class: the flag-masked diff masks and their cell count, the
        record-diff codes and count, and the died mask and count."""
        zero = torch.zeros((), dtype=torch.int32, device=state.tick.device)
        diff: Dict[str, Dict[str, torch.Tensor]] = {}
        diff_count: Dict[str, torch.Tensor] = {}
        rec_diff: Dict[str, Dict[str, torch.Tensor]] = {}
        rec_diff_count: Dict[str, torch.Tensor] = {}
        died: Dict[str, torch.Tensor] = {}
        died_count: Dict[str, torch.Tensor] = {}
        for cname in self.store.class_order:
            oc, nc = old.classes[cname], state.classes[cname]
            masks = {}
            total = zero
            for bank, cols in self._diff_cols[cname].items():
                ob, nb = getattr(oc, bank), getattr(nc, bank)
                ne = ob != nb
                if bank == "vec":
                    ne = ne.any(dim=-1)
                m = ne & nc.alive[:, None] & cols.to(nb.device)[None, :]
                masks[bank] = m
                total = total + torch.sum(m, dtype=torch.int32)
            if masks:
                diff[cname] = masks
                diff_count[cname] = total
            codes = self._record_codes(cname, oc, nc)
            if codes:
                rec_diff[cname] = codes
                rec_diff_count[cname] = sum(
                    (torch.sum(c != 0, dtype=torch.int32) for c in codes.values()), zero)
            d = oc.alive & ~nc.alive
            died[cname] = d
            died_count[cname] = torch.sum(d, dtype=torch.int32)
        return diff, diff_count, rec_diff, rec_diff_count, died, died_count

    def _pack_summary(self, ctx: "TickCtx", tick: torch.Tensor, died_count, diff_count,
                      rec_diff_count, ev_counts, counters) -> torch.Tensor:
        """The kernel's own counters added to ``counters``, the host
        metadata of the tick recorded, and the ONE packed int32 vector:
        deaths per class, diff cells per class (sorted), record-diff cells
        per class (sorted), event counts, then the counter bank in name
        order."""
        zero = torch.zeros((), dtype=torch.int32, device=tick.device)
        self._event_meta = [(e.event_id, e.class_name, tuple(e.params)) for e in ctx.emitted]
        counters["deaths"] = sum(died_count.values(), zero)
        counters["diff_cells"] = sum(diff_count.values(), zero)
        counters["rec_diff_cells"] = sum(rec_diff_count.values(), zero)
        counters["events_fired"] = sum(ev_counts, zero)
        counters["tick"] = tick
        self._counter_names = tuple(sorted(counters))
        self._summary_len = (len(self.store.class_order) + len(diff_count)
                             + len(rec_diff_count) + len(ev_counts) + len(self._counter_names))
        return torch.stack(
            [died_count[c] for c in self.store.class_order]
            + [diff_count[c] for c in sorted(diff_count)]
            + [rec_diff_count[c] for c in sorted(rec_diff_count)]
            + list(ev_counts)
            + [counters[k].to(torch.int32) for k in self._counter_names]
        )

    def _record_codes(self, cname: str, oc, nc) -> Dict[str, torch.Tensor]:
        """The ``[C, R]`` int8 row-change codes of each subscribed record of
        a class between two states: ADDED where a row became used, REMOVED
        where it stopped being used, UPDATED where a used row's cells
        changed, 0 elsewhere and on dead entities."""
        spec = self.store.spec(cname)
        codes = {}
        for rname in spec.record_order:
            if (cname, rname) not in self._rec_event_subs:
                continue
            rs = spec.records[rname]
            orec, nrec = oc.records[rname], nc.records[rname]
            changed = torch.zeros_like(nrec.used)
            if rs.n_i32:
                changed = changed | (orec.i32 != nrec.i32).any(dim=-1)
            if rs.n_f32:
                changed = changed | (orec.f32 != nrec.f32).any(dim=-1)
            if rs.n_vec:
                changed = changed | (orec.vec != nrec.vec).flatten(-2).any(dim=-1)
            code = torch.where(
                ~orec.used & nrec.used, REC_ADDED,
                torch.where(orec.used & ~nrec.used, REC_REMOVED,
                            torch.where(nrec.used & changed, REC_UPDATED, REC_NONE)),
            ).to(torch.int8)
            codes[rname] = code * nc.alive[:, None].to(torch.int8)
        return codes

    def tick(self) -> TickOutputs:
        """Advance the world one frame, fetch the summary, and fan out
        host-visible effects (events, deaths, counters)."""
        return self.tick_finish(self.tick_begin())

    def tick_begin(self) -> Dict[str, object]:
        """Run one observed step and return its raw lanes without fetching
        anything (the device may still be running it).  On a mesh the
        step is the sharded one (parallel/shard.py)."""
        if self.sharded is not None:
            return self.sharded.tick_begin()
        self.compile()
        self._ensure_aux()
        with self._span("kernel.dispatch"):
            self.state, raw = self._step_fn(self.state)
            if self.stage_timing and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.tick_count += 1
        return raw

    def _outputs(self, lane: Dict[str, object]) -> TickOutputs:
        events = [DeviceEvent(eid, cname, mask, dict(params))
                  for (eid, cname, _names), (mask, params) in zip(self._event_meta, lane["events"])]
        return TickOutputs(lane["fired"], lane["diff"], lane["diff_count"], lane["died"],
                           lane["died_count"], events, lane["rec_diff"],
                           lane["rec_diff_count"])

    def _observe_counters(self, out: TickOutputs, summary: np.ndarray) -> None:
        out.counters = {k: int(v) for k, v in self.decode_counters(summary).items()}
        self.last_counters = dict(out.counters)
        for k, v in out.counters.items():
            if k in ("state_digest", "tick"):
                continue  # a hash and a stamp: summing either is noise
            self.counter_totals[k] = self.counter_totals.get(k, 0) + v

    def tick_finish(self, raw: Dict[str, object]) -> TickOutputs:
        """Fetch a step's summary and fan out its host-visible effects."""
        out = self._outputs(raw)
        with self._span("kernel.summary_fetch"):
            summary = raw["summary"].cpu().numpy()
        self._observe_counters(out, summary)
        with self._span("kernel.post_tick"):
            self._post_tick(out, summary)
        return out

    def summary_lane(self, name: str) -> int:
        """The index of counter ``name`` in the summary vector."""
        return self._summary_len - len(self._counter_names) + self._counter_names.index(name)

    def decode_counters(self, summary) -> Dict[str, np.ndarray]:
        """The named counter bank off a summary's tail (the last
        ``len(self._counter_names)`` lanes); works on a ``[K, L]`` stack."""
        names = self._counter_names
        if not names:
            return {}
        arr = np.asarray(summary)
        tail = arr[..., arr.shape[-1] - len(names):]
        return {k: tail[..., i] for i, k in enumerate(names)}

    def device_spans(self, entry: str = "kernel.run") -> Optional[List[Tuple[str, float]]]:
        """``(name, ms)`` of each part of the last replay of ``entry``'s
        graph on the device (``nf.schedule``, each ``nf.phase.*``,
        ``nf.step``, ``nf.copy_back``), or None unless it was captured with
        the tracer on (:meth:`CostBook.device_spans`).  Read after a
        device sync."""
        return self.costbook.device_spans(entry)

    def run_device(self, n: int, reconcile: bool = True, graph: Optional[bool] = None) -> int:
        """Advance n frames with no host sync: per-tick host observation is
        skipped, and deaths are reconciled once at the end (unless
        ``reconcile=False``).  Returns the number of rows freed.

        On a CUDA device (``graph`` None or True) the step is captured
        once as a CUDA graph (``kernel.run``) and replayed n times; the
        state's banks are then updated in place.  ``graph=False`` runs the
        eager loop of functional steps; on the CPU that is the only way."""
        n = int(n)
        if self.sharded is not None:
            return self.sharded.run_device(n, reconcile=reconcile)
        use_graph = self.device.type == "cuda" if graph is None else bool(graph)
        if use_graph and self.device.type != "cuda":
            raise ValueError("run_device(graph=True) needs a CUDA device")
        self._ensure_aux()
        if n > 0 and use_graph:
            if self._run_fn is None:
                self._run_fn = self.costbook.wrap(
                    "kernel.run", lambda st: (self._step(st, observe=False)[0], None),
                    stage="tick", statics=self._statics, graph=True,
                    launch_counters=KERNELS)
            with self._span("kernel.dispatch"):
                self.state, _ = self._run_fn(self.state, times=n)
        else:
            with self._span("kernel.dispatch"):
                state = self.state
                for _ in range(n):
                    state, _ = self._step(state, observe=False)
                self.state = state
        self.tick_count += n
        if not reconcile:
            return 0
        freed = 0
        for cname in self.store.class_order:
            for g in self.store.reconcile_deaths(self.state, cname):
                self._fire_class_event(g, cname, ObjectEvent.DESTROY)
                freed += 1
        return freed

    # -- K-tick trains ---------------------------------------------------------

    def configure_train(self, k: int) -> None:
        """Pin the train length.  Changing K drops only the train's capture,
        announced as a sanctioned re-capture."""
        k = int(k)
        if k < 1:
            raise ValueError(f"train length must be >= 1, got {k}")
        if k == self._train_k:
            return
        self._train_k = k
        if self._train_fn is not None:
            self._train_fn = None
            self.costbook.generation_bump(f"train_k:{k}")

    def _trace_train(self, state: WorldState):
        """K observed steps; each tick's lanes are copied into ``[K, ...]``
        buffers allocated at the first tick."""
        k = self._train_k
        bufs = spec = raw = None
        for i in range(k):
            state, raw = self._step(state, observe=True)
            leaves, lane_spec, _ = flatten(raw)
            if bufs is None:
                spec = lane_spec
                bufs = [torch.empty((k, *x.shape), dtype=x.dtype, device=x.device)
                        for x in leaves]
            for b, x in zip(bufs, leaves):
                b[i].copy_(x)
        _assert_train_lanes(raw)
        return state, unflatten(spec, bufs)

    def compile_train(self) -> None:
        if self._train_fn is None:
            if self._train_k < 1:
                raise RuntimeError("configure_train(k) before train()")
            self._train_fn = self.costbook.wrap(
                "kernel.train", self._trace_train, stage="tick",
                statics=self._train_statics, graph=True, launch_counters=KERNELS)

    def train_begin(self) -> Dict[str, object]:
        """Dispatch one K-tick train (one graph replay on a card; the
        sharded train on a mesh)."""
        if self.sharded is not None:
            return self.sharded.train_begin()
        self.compile_train()
        self._ensure_aux()
        with self._span("kernel.dispatch"):
            self.state, raw = self._train_fn(self.state)
            if self.stage_timing and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.tick_count += self._train_k
        self.train_dispatches += 1
        self.train_ticks += self._train_k
        return raw

    def train_finish(self, raw: Dict[str, object]) -> List[TickOutputs]:
        """Fetch one train's ``[K, L]`` summary and fan out its K frames in
        tick order: lane i's events, then lane i's deaths (attributed from
        lane i's own died mask), before anything of lane i+1."""
        with self._span("kernel.summary_fetch"):
            summary = raw["summary"].cpu().numpy()
        self.train_fetch_bytes += summary.nbytes
        leaves, spec, _ = flatten({k: v for k, v in raw.items() if k != "summary"})
        outs: List[TickOutputs] = []
        for i in range(self._train_k):
            out = self._outputs(unflatten(spec, [x[i] for x in leaves]))
            row = summary[i]
            self._observe_counters(out, row)
            with self._span("kernel.post_tick"):
                self._post_tick(out, row, exact_deaths=True)
            outs.append(out)
        return outs

    def train(self, n: int) -> List[TickOutputs]:
        """Advance n frames in n // K train dispatches plus n % K single
        ticks, delivering every frame's host effects; one TickOutputs per
        frame, in order."""
        n = int(n)
        k = self._train_k
        if k < 1:
            raise RuntimeError("configure_train(k) before train()")
        outs: List[TickOutputs] = []
        for _ in range(n // k):
            outs.extend(self.train_finish(self.train_begin()))
        for _ in range(n % k):
            outs.append(self.tick())
        return outs

    def _post_tick(self, out: TickOutputs, summary: np.ndarray,
                   exact_deaths: bool = False) -> None:
        n_cls = len(self.store.class_order)
        off = n_cls + len(out.diff_count)
        rec_counts = dict(zip(sorted(out.rec_diff_count),
                              summary[off:off + len(out.rec_diff_count)]))
        off2 = off + len(out.rec_diff_count)
        event_counts = summary[off2:off2 + len(out.events)]
        # device-emitted events first, so entities that died this tick
        # still deliver theirs (the reference fires events before destroy)
        live = [
            DeviceEvent(
                ev.event_id, ev.class_name, ev.mask.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in ev.params.items()},
            )
            for ev, cnt in zip(out.events, event_counts) if cnt > 0
        ]
        if live:
            self.events.dispatch_device_events(live, self.store)
        for cname, cnt in zip(self.store.class_order, summary[:n_cls]):
            if not int(cnt):
                continue
            if exact_deaths:
                # a train frees the rows of THIS lane's died mask: the
                # carried state cannot say which tick killed a row
                rows = np.flatnonzero(out.died[cname].cpu().numpy())
                dead = self.store.release_rows(cname, rows)
            else:
                dead = self.store.reconcile_deaths(self.state, cname)
            for g in dead:
                self._fire_class_event(g, cname, ObjectEvent.DESTROY)
        # property subscribers, at batch granularity, from the diff masks
        diff_counts = dict(zip(sorted(out.diff_count), summary[n_cls:off]))
        for (cname, pname), fns in self._prop_event_subs.items():
            masks = out.diff.get(cname)
            if not masks or not int(diff_counts[cname]):
                continue
            slot = self.store.spec(cname).slot(pname)
            m = masks.get(slot.bank.value)
            if m is None:
                continue
            rows = np.flatnonzero(m[:, slot.col].cpu().numpy())
            if rows.size:
                for fn in fns:
                    fn(cname, pname, rows)
        # record-diff subscribers: the codes are fetched only when the
        # summary counts a change in their class
        for (cname, rname), fns in self._rec_event_subs.items():
            if not int(rec_counts.get(cname, 0)):
                continue
            codes_dev = out.rec_diff.get(cname, {}).get(rname)
            if codes_dev is None:
                continue
            codes = codes_dev.cpu().numpy()
            if codes.any():
                for fn in fns:
                    fn(cname, rname, codes)

    # -- object lifecycle (host control plane) ------------------------------

    def create_object(self, class_name: str, values: Optional[Dict[str, Value]] = None,
                      guid: Optional[Guid] = None, scene: int = 0, group: int = 0) -> Guid:
        """Create one object and run the full create chain (reference
        NFCKernelModule.cpp:251-267): SceneID, GroupID, ClassName and ID
        default as in the JAX package."""
        spec = self.store.spec(class_name)
        vals = dict(values or {})
        if spec.has_property("SceneID"):
            vals.setdefault("SceneID", scene)
        if spec.has_property("GroupID"):
            vals.setdefault("GroupID", group)
        if spec.has_property("ClassName"):
            vals.setdefault("ClassName", class_name)
        self.state, g, _ = self.store.create_object(self.state, class_name, guid, vals)
        if spec.has_property("ID"):
            self.state = self.store.set_property(self.state, g, "ID", str(g))
        for ev in (
            ObjectEvent.CREATE_NODATA,
            ObjectEvent.CREATE_LOADDATA,
            ObjectEvent.CREATE_BEFORE_EFFECT,
            ObjectEvent.CREATE_EFFECTDATA,
            ObjectEvent.CREATE_AFTER_EFFECT,
            ObjectEvent.CREATE_HASDATA,
            ObjectEvent.CREATE_FINISH,
        ):
            self._fire_class_event(g, class_name, ev)
        return g

    def create_from_element(self, class_name: str, elem_id: str,
                            overrides: Optional[Dict[str, Value]] = None,
                            scene: int = 0, group: int = 0) -> Guid:
        """Create seeded from element config (the element's property
        values, its ConfigID, then ``overrides``)."""
        e = self.elements.element(elem_id)
        vals = dict(e.values)
        vals["ConfigID"] = elem_id
        vals.update(overrides or {})
        spec = self.store.spec(class_name)
        vals = {k: v for k, v in vals.items() if spec.has_property(k)}
        return self.create_object(class_name, vals, scene=scene, group=group)

    def destroy_object(self, guid: Guid, deferred: bool = False) -> None:
        """Destroy now, or at the end of the current frame if deferred
        (reference NFCKernelModule.cpp:273-308)."""
        if deferred:
            self._pending_destroy.append(guid)
            return
        class_name, _ = self.store.row_of(guid)
        self._fire_class_event(guid, class_name, ObjectEvent.BEFORE_DESTROY)
        self.state = self.store.destroy_object(self.state, guid)
        self._fire_class_event(guid, class_name, ObjectEvent.DESTROY)

    def flush_pending_destroy(self) -> int:
        n = 0
        for g in self._pending_destroy:
            if g in self.store.guid_map:
                self.destroy_object(g)
                n += 1
        self._pending_destroy.clear()
        return n

    def execute(self) -> None:
        self.flush_pending_destroy()
        self.events.execute()

    # -- property access with host-callback parity --------------------------

    def set_property(self, guid: Guid, prop_name: str, value: Value) -> None:
        """Host-originated write; fires property subscribers synchronously
        (the reference's SetProperty -> OnEventHandler chain)."""
        class_name, row = self.store.row_of(guid)
        old = self.store.get_property(self.state, guid, prop_name)
        self.state = self.store.set_property(self.state, guid, prop_name, value)
        if old != value:
            for fn in self._prop_event_subs.get((class_name, prop_name), ()):
                fn(class_name, prop_name, np.asarray([row]))

    def get_property(self, guid: Guid, prop_name: str) -> Value:
        return self.store.get_property(self.state, guid, prop_name)

    # -- event registration --------------------------------------------------

    def register_class_event(self, fn: ClassEventFn, class_name: Optional[str] = None) -> None:
        """Subscribe to create/destroy chains: all classes, or one."""
        if class_name is None:
            self._class_event_subs.append(fn)
        else:
            self._class_event_by_class.setdefault(class_name, []).append(fn)

    def register_property_event(self, class_name: str, prop_name: str,
                                fn: PropertyEventFn) -> None:
        """Subscribe to a property's changes: called with the changed rows
        after each tick (diff-flagged columns) and on each host write."""
        self.store.spec(class_name).slot(prop_name)  # validate
        self._prop_event_subs.setdefault((class_name, prop_name), []).append(fn)

    def force_diff_property(self, class_name: str, prop_name: str) -> None:
        """Opt a property outside ``diff_flags`` into the device diff
        extraction, so its tick-path changes reach property subscribers.
        A new column invalidates the captured tick."""
        self.store.spec(class_name).slot(prop_name)  # validate
        s = self._forced_diff.setdefault(class_name, set())
        if prop_name not in s:
            s.add(prop_name)
            self._diff_cols[class_name] = self._diff_columns(class_name)
            self.invalidate()

    def register_record_diff(self, class_name: str, record_name: str,
                             fn: RecordDiffFn) -> None:
        """Subscribe to a record's device-path changes: called after each
        tick with its int8 ``[C, R]`` codes (REC_ADDED/REMOVED/UPDATED).
        The codes are computed only for subscribed records, so the first
        subscriber of a record invalidates the captured tick."""
        spec = self.store.spec(class_name)
        if record_name not in spec.records:
            raise KeyError(f"{class_name!r} has no record {record_name!r}")
        key = (class_name, record_name)
        first = key not in self._rec_event_subs
        self._rec_event_subs.setdefault(key, []).append(fn)
        if first:
            self.invalidate()

    def subscribe_record_host(self, fn) -> None:
        """Host-path per-op record hook (store mutators; reference
        NFIRecord::AddRecordHook): see EntityStore.subscribe_records."""
        self.store.subscribe_records(fn)

    def _fire_class_event(self, guid: Guid, class_name: str, ev: ObjectEvent) -> None:
        for fn in self._class_event_by_class.get(class_name, ()):
            fn(guid, class_name, ev)
        for fn in self._class_event_subs:
            fn(guid, class_name, ev)
