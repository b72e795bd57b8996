"""Structure-of-Arrays entity store on one torch device.

Counterpart of ``noahgameframe_tpu/core/store.py``: the whole world is a
tree of dense tensors, laid out exactly as the JAX package lays it out so
the two can be compared bank by bank and digest by digest::

    WorldState
      .classes: {class_name: ClassState}
      .tick:    int32 0-dim     (frame counter)
      .rng:     int64 [2]       (threefry key words, see core/prng.py)
      .aux:     {}              (module-owned carried state: Verlet caches)

    ClassState                       (capacity C, from StoreConfig)
      .i32:   int32  [C, n_i32]      int / interned-string / object-handle
      .f32:   float32[C, n_f32]      float properties
      .vec:   float32[C, n_vec, 3]   vector2/3 properties
      .alive: bool   [C]             row in use
      .timers: TimerState [C, n_timers]
      .records: {record_name: RecordState}

    RecordState                      (R = max_rows per entity)
      .i32 [C, R, n_i32]  .f32 [C, R, n_f32]  .vec [C, R, n_vec, 3]  .used [C, R]

The containers are plain dataclasses.  Updates are functional
(``replace`` returns a new container; a written bank is a fresh tensor),
so the kernel can diff the pre-tick state against the post-tick one.

Row allocation, guids and the string table stay on the host, as in the
JAX package, and so does the host object API: ``create_object``,
``destroy_object``, typed ``set_property``/``get_property`` and the record
operations, each taking a WorldState and returning a new one (a written
bank is a fresh tensor).  ``state_from_numpy`` / ``state_to_numpy`` carry a world
between the two packages as nested dicts of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .datatypes import (
    Bank,
    DataType,
    Guid,
    GuidAllocator,
    NULL_OBJECT,
    Value,
    coerce,
    default_value,
)
from .device import resolve_device
from .prng import MASK32, prng_key
from .schema import ClassRegistry, ClassSpec, RecordSpec
from .strings import StringTable

HANDLE_ROW_BITS = 24
HANDLE_ROW_MASK = (1 << HANDLE_ROW_BITS) - 1


class RecordOp(enum.IntEnum):
    """Per-op record event types, value-compatible with the reference's
    NFIRecord::RecordOptype (NFIRecord.h:16-25)."""

    ADD = 0
    DEL = 1
    SWAP = 2
    CREATE = 3
    UPDATE = 4
    CLEARED = 5
    SORT = 6
    COVER = 7


# (class_name, record_name, op, entity_rows, rec_row, tags): fired by the
# host-side record mutators, batch-first (entity_rows is an int array, so
# a bulk write costs one call).  tags is the touched-column subset for
# UPDATE, None for whole-row ops; for SWAP, rec_row is the (origin,
# target) row pair.
RecordEventFn = Callable[
    [str, str, "RecordOp", np.ndarray, Any, Optional[Tuple[str, ...]]], None
]


def pack_handle(class_idx: int, row: int) -> int:
    return (class_idx << HANDLE_ROW_BITS) | row


def unpack_handle(handle: int) -> Tuple[int, int]:
    return handle >> HANDLE_ROW_BITS, handle & HANDLE_ROW_MASK


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class TimerState(_Replace):
    next_fire: torch.Tensor  # int32 [C, T] tick of next firing
    interval: torch.Tensor  # int32 [C, T] ticks between firings
    remain: torch.Tensor  # int32 [C, T] remaining count, -1 = forever
    active: torch.Tensor  # bool  [C, T]


@dataclasses.dataclass
class RecordState(_Replace):
    i32: torch.Tensor
    f32: torch.Tensor
    vec: torch.Tensor
    used: torch.Tensor


@dataclasses.dataclass
class ClassState(_Replace):
    i32: torch.Tensor
    f32: torch.Tensor
    vec: torch.Tensor
    alive: torch.Tensor
    timers: TimerState
    records: Dict[str, RecordState]

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


@dataclasses.dataclass
class WorldState(_Replace):
    classes: Dict[str, ClassState]
    tick: torch.Tensor  # int32 0-dim
    rng: torch.Tensor  # int64 [2], uint32 words
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)


def with_class(state: WorldState, class_name: str, cs: ClassState) -> WorldState:
    """Functional single-class replacement — the universal update idiom."""
    return state.replace(classes={**state.classes, class_name: cs})


def set_column(bank: torch.Tensor, col, value) -> torch.Tensor:
    """``bank.at[:, col].set(value)``: a copy of ``bank`` with one column
    (or column list) replaced."""
    out = bank.clone()
    out[:, col] = value
    return out


# -- carrying a world between packages ---------------------------------------

_TIMER_LEAVES = ("next_fire", "interval", "remain", "active")
_RECORD_LEAVES = ("i32", "f32", "vec", "used")
_CLASS_LEAVES = ("i32", "f32", "vec", "alive")


def _cpu(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _classes_to_numpy(state: WorldState) -> Dict[str, Any]:
    classes = {}
    for cname, cs in state.classes.items():
        d = {k: _cpu(getattr(cs, k)) for k in _CLASS_LEAVES}
        d["timers"] = {k: _cpu(getattr(cs.timers, k)) for k in _TIMER_LEAVES}
        d["records"] = {
            r: {k: _cpu(getattr(rec, k)) for k in _RECORD_LEAVES}
            for r, rec in cs.records.items()
        }
        classes[cname] = d
    return classes


def state_to_numpy(state: WorldState) -> Dict[str, Any]:
    """The world's leaves as nested dicts of numpy arrays, with the JAX
    package's dtypes (the key as uint32 words)::

        {"tick": int32, "rng": uint32[2], "classes": {name: {
            "i32", "f32", "vec", "alive",
            "timers": {"next_fire", "interval", "remain", "active"},
            "records": {rname: {"i32", "f32", "vec", "used"}}}}}
    """
    return {
        "tick": np.int32(_cpu(state.tick)),
        "rng": _cpu(state.rng).astype(np.uint32),
        "classes": _classes_to_numpy(state),
    }


def rooms_to_numpy(state: WorldState) -> Dict[str, Any]:
    """:func:`state_to_numpy` of a room batch's state (parallel/rooms.py
    ``RoomBatch.state``): every leaf keeps its leading ``[R]`` room axis
    (``tick`` int32 [R], ``rng`` uint32 [R, 2]); aux is left out."""
    return {
        "tick": _cpu(state.tick).astype(np.int32),
        "rng": _cpu(state.rng).astype(np.uint32),
        "classes": _classes_to_numpy(state),
    }


def _classes_from_numpy(tree: Dict[str, Any], dev) -> Dict[str, ClassState]:
    classes = {}
    for cname, d in tree["classes"].items():
        classes[cname] = ClassState(
            **{k: dev(d[k]) for k in _CLASS_LEAVES},
            timers=TimerState(**{k: dev(d["timers"][k]) for k in _TIMER_LEAVES}),
            records={
                r: RecordState(**{k: dev(rd[k]) for k in _RECORD_LEAVES})
                for r, rd in d["records"].items()
            },
        )
    return classes


def _device_copier(device):
    def dev(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return dev


def state_from_numpy(tree: Dict[str, Any], device=None) -> WorldState:
    """Inverse of :func:`state_to_numpy`: build a WorldState on ``device``
    (``None`` = ``"cuda"``) from nested dicts of numpy arrays, e.g. a JAX
    world's leaves."""
    dev = _device_copier(resolve_device(device))
    rng = np.asarray(tree["rng"]).astype(np.int64) & MASK32
    return WorldState(
        classes=_classes_from_numpy(tree, dev),
        tick=dev(np.asarray(tree["tick"], np.int32)).reshape(()),
        rng=dev(rng),
    )


def rooms_from_numpy(tree: Dict[str, Any], device=None) -> WorldState:
    """Inverse of :func:`rooms_to_numpy`: a room batch's state on ``device``
    (``None`` = ``"cuda"``) from nested dicts of numpy arrays with a leading
    ``[R]`` axis, e.g. the leaves of the JAX package's ``RoomBatch.state``.
    Its aux is empty: ``RoomBatch.load_state`` supplies fresh caches."""
    dev = _device_copier(resolve_device(device))
    rng = np.asarray(tree["rng"]).astype(np.int64) & MASK32
    return WorldState(
        classes=_classes_from_numpy(tree, dev),
        tick=dev(np.asarray(tree["tick"], np.int32)).reshape(-1),
        rng=dev(rng),
    )


# -- the store ----------------------------------------------------------------


@dataclasses.dataclass
class StoreConfig:
    default_capacity: int = 1024
    capacities: Dict[str, int] = dataclasses.field(default_factory=dict)
    timer_slots: Dict[str, int] = dataclasses.field(default_factory=dict)

    def capacity_of(self, class_name: str) -> int:
        return int(self.capacities.get(class_name, self.default_capacity))


def _zeros_class_state(spec: ClassSpec, cap: int, n_timers: int, device) -> ClassState:
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    recs = {}
    for rname in spec.record_order:
        rs: RecordSpec = spec.records[rname]
        recs[rname] = RecordState(
            i32=z((cap, rs.max_rows, rs.n_i32), i32),
            f32=z((cap, rs.max_rows, rs.n_f32), f32),
            vec=z((cap, rs.max_rows, rs.n_vec, 3), f32),
            used=z((cap, rs.max_rows), torch.bool),
        )
    return ClassState(
        i32=z((cap, spec.n_i32), i32),
        f32=z((cap, spec.n_f32), f32),
        vec=z((cap, spec.n_vec, 3), f32),
        alive=z((cap,), torch.bool),
        timers=TimerState(
            next_fire=z((cap, n_timers), i32),
            interval=torch.ones((cap, n_timers), dtype=i32, device=device),
            remain=z((cap, n_timers), i32),
            active=z((cap, n_timers), torch.bool),
        ),
        records=recs,
    )


def _scatter(bank: torch.Tensor, index, value) -> torch.Tensor:
    """``bank.at[index].set(value)``: a copy of ``bank`` with the indexed
    cells written (``value`` a Python scalar, a numpy array or a tensor)."""
    out = bank.clone()
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value).to(out.device)
    elif isinstance(value, np.generic):
        value = value.item()
    out[index] = value
    return out


def _reset_and_write_rows(cs: ClassState, rows: torch.Tensor, i32, f32, vec) -> ClassState:
    """Row (re)initialization: value banks from the staged payloads,
    timers disarmed, records cleared, alive on.  A recycled row must not
    leak the previous entity's records or heartbeat schedule."""
    t = cs.timers
    timers = TimerState(
        next_fire=_scatter(t.next_fire, rows, 0),
        interval=_scatter(t.interval, rows, 1),
        remain=_scatter(t.remain, rows, 0),
        active=_scatter(t.active, rows, False),
    )
    records = {
        r: RecordState(i32=_scatter(rec.i32, rows, 0), f32=_scatter(rec.f32, rows, 0.0),
                       vec=_scatter(rec.vec, rows, 0.0), used=_scatter(rec.used, rows, False))
        for r, rec in cs.records.items()
    }
    return cs.replace(
        i32=_scatter(cs.i32, rows, i32) if cs.i32.shape[1] else cs.i32,
        f32=_scatter(cs.f32, rows, f32) if cs.f32.shape[1] else cs.f32,
        vec=_scatter(cs.vec, rows, vec) if cs.vec.shape[1] else cs.vec,
        alive=_scatter(cs.alive, rows, True),
        timers=timers,
        records=records,
    )


class _ClassHost:
    """Host bookkeeping for one class: free rows, row -> guid, and the
    columnar mirrors the JAX package keeps beside them."""

    def __init__(self, spec: ClassSpec, class_idx: int, capacity: int):
        self.spec = spec
        self.class_idx = class_idx
        self.capacity = capacity
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        self.row_guid: List[Optional[Guid]] = [None] * capacity
        # allocation bitmap: reconcile_deaths finds device deaths with one
        # vector op instead of a scan of every row
        self.alloc_mask = np.zeros(capacity, bool)
        # columnar guid mirror of row_guid
        self.guid_head = np.zeros(capacity, np.int64)
        self.guid_data = np.zeros(capacity, np.int64)
        # allocation generation, +1 per free: guids never recycle, so
        # within one generation row and guid name the same entity
        self.row_gen = np.zeros(capacity, np.int32)
        self.live_count = 0

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError(f"class {self.spec.name!r} capacity {self.capacity} exhausted")
        self.live_count += 1
        row = self.free.pop()
        self.alloc_mask[row] = True
        return row

    def alloc_many(self, n: int) -> np.ndarray:
        if n <= 0:  # free[-0:] would slice the whole list
            return np.zeros(0, np.int32)
        if len(self.free) < n:
            raise RuntimeError(
                f"class {self.spec.name!r} capacity {self.capacity} exhausted "
                f"({len(self.free)} free, {n} requested)"
            )
        rows = np.asarray(self.free[-n:][::-1], np.int32)
        del self.free[-n:]
        self.live_count += n
        self.alloc_mask[rows] = True
        return rows

    def release(self, row: int) -> None:
        self.row_guid[row] = None
        self.free.append(row)
        self.alloc_mask[row] = False
        self.guid_head[row] = 0
        self.guid_data[row] = 0
        self.row_gen[row] += 1
        self.live_count -= 1


_BANK_NP = {Bank.I32: np.int32, Bank.F32: np.float32, Bank.VEC: np.float32}
_FAST_TYPES = (DataType.INT, DataType.FLOAT, DataType.VECTOR2, DataType.VECTOR3)


class EntityStore:
    """Host-side owner of the device world: allocation, identity, typed
    access.  Methods take and return WorldState.  ``device=None`` means
    ``"cuda"``."""

    def __init__(
        self,
        registry: ClassRegistry,
        config: Optional[StoreConfig] = None,
        strings: Optional[StringTable] = None,
        class_names: Optional[Sequence[str]] = None,
        device=None,
    ):
        self.registry = registry
        self.config = config or StoreConfig()
        self.strings = strings or StringTable()
        self.guids = GuidAllocator()
        self.device = resolve_device(device)
        names = list(class_names) if class_names is not None else registry.names()
        self.class_order: List[str] = names
        self.class_index: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self._hosts: Dict[str, _ClassHost] = {}
        self.guid_map: Dict[Guid, int] = {}  # guid -> packed handle
        # host-path record hooks (reference NFIRecord::AddRecordHook)
        self.record_subs: List[RecordEventFn] = []
        for n in names:
            spec = registry.spec(n)
            self._hosts[n] = _ClassHost(spec, self.class_index[n], self.config.capacity_of(n))

    def init_state(self, seed: int = 0) -> WorldState:
        classes = {}
        for n in self.class_order:
            h = self._hosts[n]
            n_timers = int(self.config.timer_slots.get(n, 0))
            classes[n] = _zeros_class_state(h.spec, h.capacity, n_timers, self.device)
        return WorldState(
            classes=classes,
            tick=torch.zeros((), dtype=torch.int32, device=self.device),
            rng=prng_key(seed, self.device),
        )

    def spec(self, class_name: str) -> ClassSpec:
        return self._hosts[class_name].spec

    def capacity(self, class_name: str) -> int:
        return self._hosts[class_name].capacity

    def live_count(self, class_name: str) -> int:
        return self._hosts[class_name].live_count

    # -- value encoding -----------------------------------------------------

    def encode(self, t: DataType, v: Value):
        """Host value -> device scalar/vector for a property of type t."""
        if t != DataType.OBJECT:
            v = coerce(t, v)
        if t == DataType.INT:
            return np.int32(v)
        if t == DataType.FLOAT:
            return np.float32(v)
        if t == DataType.STRING:
            return np.int32(self.strings.intern(v))
        if t == DataType.OBJECT:
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                return np.int32(v)  # a raw packed handle passed straight through
            v = coerce(t, v)
            if v.is_null():
                return np.int32(NULL_OBJECT)
            h = self.guid_map.get(v)
            if h is None:
                raise KeyError(f"unknown guid {v} for OBJECT property")
            return np.int32(h)
        if t == DataType.VECTOR2:
            return np.asarray([v[0], v[1], 0.0], np.float32)
        if t == DataType.VECTOR3:
            return np.asarray(v, np.float32)
        raise ValueError(f"cannot encode {t}")

    def encode_column(self, t: DataType, bank: Bank, values) -> np.ndarray:
        """A column of host values encoded for its bank.  A numpy array of
        a numeric type is converted in one step (the bulk-seeding path);
        anything else goes value by value through :meth:`encode`."""
        if isinstance(values, np.ndarray) and t in _FAST_TYPES:
            if t == DataType.INT:
                return values.astype(np.int64).astype(np.int32)
            if t == DataType.FLOAT:
                return values.astype(np.float64).astype(np.float32)
            n = 2 if t == DataType.VECTOR2 else 3
            out = np.zeros((values.shape[0], 3), np.float32)
            out[:, :n] = values[:, :n].astype(np.float64)
            return out
        return np.asarray([self.encode(t, v) for v in values], _BANK_NP[bank])

    def decode(self, t: DataType, raw) -> Value:
        """Device scalar/vector -> host value."""
        if isinstance(raw, torch.Tensor):
            raw = _cpu(raw)
        if t == DataType.INT:
            return int(raw)
        if t == DataType.FLOAT:
            return float(raw)
        if t == DataType.STRING:
            return self.strings.lookup(int(raw))
        if t == DataType.OBJECT:
            h = int(raw)
            if h == NULL_OBJECT:
                return Guid()
            ci, row = unpack_handle(h)
            g = self._hosts[self.class_order[ci]].row_guid[row]
            return g if g is not None else Guid()
        if t == DataType.VECTOR2:
            a = np.asarray(raw)
            return (float(a[0]), float(a[1]))
        if t == DataType.VECTOR3:
            a = np.asarray(raw)
            return (float(a[0]), float(a[1]), float(a[2]))
        raise ValueError(f"cannot decode {t}")

    # -- identity -----------------------------------------------------------

    def handle_of(self, guid: Guid) -> int:
        return self.guid_map[guid]

    def guid_of_handle(self, handle: int) -> Optional[Guid]:
        h = int(handle)
        if h < 0:  # NULL_OBJECT and any other negative sentinel
            return None
        ci, row = unpack_handle(h)
        if ci >= len(self.class_order):
            return None
        return self._hosts[self.class_order[ci]].row_guid[row]

    def row_of(self, guid: Guid) -> Tuple[str, int]:
        ci, row = unpack_handle(self.guid_map[guid])
        return self.class_order[ci], row

    # -- create / destroy / reconcile -----------------------------------------

    def create_object(
        self,
        state: WorldState,
        class_name: str,
        guid: Optional[Guid] = None,
        values: Optional[Dict[str, Value]] = None,
    ) -> Tuple[WorldState, Guid, int]:
        """Allocate one row; returns (state', guid, row).  The create-event
        chain is driven by the kernel on top of this primitive."""
        state, guids, rows = self.create_many(
            state, class_name, 1,
            guids=[guid] if guid is not None else None,
            values={k: [v] for k, v in (values or {}).items()},
        )
        return state, guids[0], rows[0]

    def create_many(
        self,
        state: WorldState,
        class_name: str,
        n: int,
        guids: Optional[Sequence[Guid]] = None,
        values: Optional[Dict[str, Any]] = None,
    ) -> Tuple[WorldState, List[Guid], np.ndarray]:
        """Bulk allocate n rows of class_name with per-property value
        columns; each written row is fully reset (banks to defaults or
        the given values, timers off, records cleared, alive on).  Every
        payload and identity is validated before any host bookkeeping
        changes, so a bad name, an unknown guid or a full class leaks
        nothing."""
        host = self._hosts[class_name]
        spec = host.spec
        i32 = np.zeros((n, spec.n_i32), np.int32)
        f32 = np.zeros((n, spec.n_f32), np.float32)
        vec = np.zeros((n, spec.n_vec, 3), np.float32)
        staged = {Bank.I32: i32, Bank.F32: f32, Bank.VEC: vec}
        for slot in spec.slots.values():
            staged[slot.bank][:, slot.col] = self.encode(
                slot.prop.type, slot.prop.resolved_default()
            )
        for pname, col_vals in (values or {}).items():
            slot = spec.slot(pname)
            staged[slot.bank][:, slot.col] = self.encode_column(
                slot.prop.type, slot.bank, col_vals
            )
        if guids is not None:
            if len(guids) != n:
                raise ValueError("guids length must equal n")
            if len({*guids}) != n:
                raise ValueError("duplicate guids in create_many batch")
            for g in guids:
                if g in self.guid_map:
                    raise ValueError(f"guid {g} already exists")
        rows = host.alloc_many(n)  # raises on a full class before changing anything
        out_guids: List[Guid] = list(guids) if guids is not None else self.guids.next_batch(n)
        ci = host.class_idx
        for g, row in zip(out_guids, rows.tolist()):
            self.guid_map[g] = pack_handle(ci, row)
            host.row_guid[row] = g
        host.guid_head[rows] = np.fromiter((g.head for g in out_guids), np.int64, n)
        host.guid_data[rows] = np.fromiter((g.data for g in out_guids), np.int64, n)
        if n == 0:
            return state, out_guids, rows
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        cs = _reset_and_write_rows(state.classes[class_name], idx, i32, f32, vec)
        return with_class(state, class_name, cs), out_guids, rows

    def destroy_object(self, state: WorldState, guid: Guid) -> WorldState:
        class_name, row = self.row_of(guid)
        host = self._hosts[class_name]
        cs = state.classes[class_name]
        cs = cs.replace(
            alive=_scatter(cs.alive, row, False),
            timers=cs.timers.replace(active=_scatter(cs.timers.active, row, False)),
        )
        del self.guid_map[guid]
        host.release(row)
        return with_class(state, class_name, cs)

    def reconcile_deaths(self, state: WorldState, class_name: str) -> List[Guid]:
        """Free rows whose ``alive`` the device cleared; returns their guids."""
        host = self._hosts[class_name]
        alive = _cpu(state.classes[class_name].alive)
        return self.release_rows(class_name, np.flatnonzero(host.alloc_mask & ~alive))

    def release_rows(self, class_name: str, rows) -> List[Guid]:
        """Free exactly ``rows`` (killed on the device) and return their
        guids; rows already free are skipped.  A train frees each lane's
        own died rows through this."""
        host = self._hosts[class_name]
        dead: List[Guid] = []
        for row in np.asarray(rows).tolist():
            if not host.alloc_mask[row]:
                continue
            g = host.row_guid[row]
            if g is None:
                continue
            dead.append(g)
            del self.guid_map[g]
            host.release(row)
        return dead

    # -- typed property access (host control plane) -------------------------

    def set_property(self, state: WorldState, guid: Guid, prop_name: str,
                     value: Value) -> WorldState:
        class_name, row = self.row_of(guid)
        slot = self.spec(class_name).slot(prop_name)
        enc = self.encode(slot.prop.type, value)
        cs = state.classes[class_name]
        bank = slot.bank.value
        cs = cs.replace(**{bank: _scatter(getattr(cs, bank), (row, slot.col), enc)})
        return with_class(state, class_name, cs)

    def get_property(self, state: WorldState, guid: Guid, prop_name: str) -> Value:
        class_name, row = self.row_of(guid)
        slot = self.spec(class_name).slot(prop_name)
        raw = getattr(state.classes[class_name], slot.bank.value)[row, slot.col]
        return self.decode(slot.prop.type, raw)

    # -- record access (host control plane) ---------------------------------

    def _rec(self, class_name: str, record_name: str) -> RecordSpec:
        return self.spec(class_name).records[record_name]

    def subscribe_records(self, fn: RecordEventFn) -> None:
        """Register a host-path record hook (NFIRecord::AddRecordHook):
        fired after every host record mutation with the op, the touched
        entity rows, the record row, and (for UPDATE) the column tags."""
        self.record_subs.append(fn)

    def _fire_record(self, class_name: str, record_name: str, op: RecordOp,
                     entity_rows, rec_row, tags: Optional[Tuple[str, ...]] = None) -> None:
        if not self.record_subs:
            return
        rows = np.atleast_1d(np.asarray(entity_rows, np.int64))
        for fn in self.record_subs:
            fn(class_name, record_name, op, rows, rec_row, tags)

    def _with_record(self, state: WorldState, class_name: str, record_name: str,
                     rec: RecordState) -> WorldState:
        cs = state.classes[class_name]
        return with_class(state, class_name,
                          cs.replace(records={**cs.records, record_name: rec}))

    def _full_row(self, rs: RecordSpec, row_values: Dict[str, Value]) -> Dict[str, Value]:
        """Every column of a record row: defaults, then ``row_values``
        (a reused slot must not expose the deleted row's data)."""
        full: Dict[str, Value] = {
            tag: default_value(rs.cols[tag].col_def.type) for tag in rs.col_order
        }
        full.update(row_values)
        return full

    def _mark_used(self, state: WorldState, class_name: str, row: int, record_name: str,
                   rec_row: int, used: bool) -> WorldState:
        rec = state.classes[class_name].records[record_name]
        rec = rec.replace(used=_scatter(rec.used, (row, rec_row), used))
        return self._with_record(state, class_name, record_name, rec)

    def record_add_row(self, state: WorldState, guid: Guid, record_name: str,
                       row_values: Dict[str, Value]) -> Tuple[WorldState, int]:
        """Append a row into the first unused slot (reference
        NFCRecord::AddRow semantics)."""
        class_name, row = self.row_of(guid)
        rs = self._rec(class_name, record_name)
        used = _cpu(state.classes[class_name].records[record_name].used[row])
        free = np.flatnonzero(~used)
        if free.size == 0:
            raise RuntimeError(f"record {record_name!r} full ({rs.max_rows} rows)")
        r = int(free[0])
        state = self._record_write(state, class_name, row, record_name, r,
                                   self._full_row(rs, row_values))
        state = self._mark_used(state, class_name, row, record_name, r, True)
        self._fire_record(class_name, record_name, RecordOp.ADD, row, r)
        return state, r

    def record_restore_row(self, state: WorldState, guid: Guid, record_name: str,
                           rec_row: int, row_values: Dict[str, Value]) -> WorldState:
        """Write a row at an exact index and mark it used: the load path,
        which keeps row indices (the saved record blobs are row-addressed)."""
        class_name, row = self.row_of(guid)
        rs = self._rec(class_name, record_name)
        state = self._record_write(state, class_name, row, record_name, rec_row,
                                   self._full_row(rs, row_values))
        state = self._mark_used(state, class_name, row, record_name, rec_row, True)
        self._fire_record(class_name, record_name, RecordOp.ADD, row, rec_row)
        return state

    def record_remove_row(self, state: WorldState, guid: Guid, record_name: str,
                          rec_row: int) -> WorldState:
        class_name, row = self.row_of(guid)
        state = self._mark_used(state, class_name, row, record_name, rec_row, False)
        self._fire_record(class_name, record_name, RecordOp.DEL, row, rec_row)
        return state

    def record_swap_rows(self, state: WorldState, guid: Guid, record_name: str,
                         row_origin: int, row_target: int) -> WorldState:
        """Exchange two record rows' contents and used flags in one op
        (reference NFCRecord::SwapRowInfo)."""
        class_name, row = self.row_of(guid)
        rec = state.classes[class_name].records[record_name]
        pair = [row_origin, row_target]
        swapped = [row_target, row_origin]

        def swap(bank: torch.Tensor) -> torch.Tensor:
            out = bank.clone()
            out[row, pair] = bank[row, swapped]
            return out

        rec = RecordState(i32=swap(rec.i32), f32=swap(rec.f32), vec=swap(rec.vec),
                          used=swap(rec.used))
        state = self._with_record(state, class_name, record_name, rec)
        self._fire_record(class_name, record_name, RecordOp.SWAP, row,
                          (row_origin, row_target))
        return state

    def record_set(self, state: WorldState, guid: Guid, record_name: str, rec_row: int,
                   tag: str, value: Value) -> WorldState:
        class_name, row = self.row_of(guid)
        state = self._record_write(state, class_name, row, record_name, rec_row, {tag: value})
        self._fire_record(class_name, record_name, RecordOp.UPDATE, row, rec_row, (tag,))
        return state

    def record_get(self, state: WorldState, guid: Guid, record_name: str, rec_row: int,
                   tag: str) -> Value:
        class_name, row = self.row_of(guid)
        slot = self._rec(class_name, record_name).cols[tag]
        rec = state.classes[class_name].records[record_name]
        raw = getattr(rec, slot.bank.value)[row, rec_row, slot.col]
        return self.decode(slot.col_def.type, raw)

    def record_used_rows(self, state: WorldState, guid: Guid, record_name: str) -> List[int]:
        """Indices of used rows in an entity's record."""
        class_name, row = self.row_of(guid)
        rec = state.classes[class_name].records.get(record_name)
        if rec is None:
            return []
        return [int(r) for r in np.flatnonzero(_cpu(rec.used[row]))]

    def record_find_rows(self, state: WorldState, guid: Guid, record_name: str, tag: str,
                         value: Value) -> List[int]:
        """Used rows whose ``tag`` column equals value (reference
        NFCRecord::FindInt/FindString family)."""
        class_name, row = self.row_of(guid)
        slot = self._rec(class_name, record_name).cols[tag]
        rec = state.classes[class_name].records[record_name]
        enc = self.encode(slot.col_def.type, value)
        if slot.bank == Bank.VEC:
            raise TypeError("find on vector columns unsupported")
        col = _cpu(getattr(rec, slot.bank.value)[row, :, slot.col])
        used = _cpu(rec.used[row])
        return [int(i) for i in np.flatnonzero(used & (col == enc))]

    def record_write_rows(
        self,
        state: WorldState,
        class_name: str,
        rows: np.ndarray,
        record_name: str,
        rec_row: int,
        col_values: Dict[str, Any],
        mark_used: bool = True,
    ) -> WorldState:
        """Bulk write one record row (``rec_row``) across many entities:
        ``col_values[tag][i]`` lands in entity ``rows[i]``."""
        rs = self._rec(class_name, record_name)
        rec = state.classes[class_name].records[record_name]
        banks = {Bank.I32: rec.i32, Bank.F32: rec.f32, Bank.VEC: rec.vec}
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        for tag, vals in col_values.items():
            slot = rs.cols[tag]
            enc = self.encode_column(slot.col_def.type, slot.bank, vals)
            banks[slot.bank] = _scatter(banks[slot.bank], (idx, rec_row, slot.col), enc)
        used = _scatter(rec.used, (idx, rec_row), True) if mark_used else rec.used
        rec = RecordState(i32=banks[Bank.I32], f32=banks[Bank.F32], vec=banks[Bank.VEC],
                          used=used)
        state = self._with_record(state, class_name, record_name, rec)
        self._fire_record(class_name, record_name, RecordOp.UPDATE, rows, rec_row,
                          tuple(col_values))
        return state

    def _record_write(self, state: WorldState, class_name: str, row: int, record_name: str,
                      rec_row: int, row_values: Dict[str, Value]) -> WorldState:
        rs = self._rec(class_name, record_name)
        rec = state.classes[class_name].records[record_name]
        banks = {Bank.I32: rec.i32, Bank.F32: rec.f32, Bank.VEC: rec.vec}
        written = set()
        for tag, v in row_values.items():
            slot = rs.cols[tag]
            if slot.bank not in written:
                banks[slot.bank] = banks[slot.bank].clone()
                written.add(slot.bank)
            enc = self.encode(slot.col_def.type, v)
            banks[slot.bank][row, rec_row, slot.col] = (
                torch.from_numpy(enc).to(self.device) if isinstance(enc, np.ndarray)
                else enc.item())
        rec = rec.replace(i32=banks[Bank.I32], f32=banks[Bank.F32], vec=banks[Bank.VEC])
        return self._with_record(state, class_name, record_name, rec)

    # -- column views -------------------------------------------------------

    def column(self, state: WorldState, class_name: str, prop_name: str) -> torch.Tensor:
        """Whole property column [C] (or [C, 3] for vectors)."""
        slot = self.spec(class_name).slot(prop_name)
        return getattr(state.classes[class_name], slot.bank.value)[:, slot.col]

    def with_column(self, state: WorldState, class_name: str, prop_name: str,
                    col: torch.Tensor) -> WorldState:
        slot = self.spec(class_name).slot(prop_name)
        cs = state.classes[class_name]
        bank = slot.bank.value
        return with_class(state, class_name,
                          cs.replace(**{bank: set_column(getattr(cs, bank), slot.col, col)}))
