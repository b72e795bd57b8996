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
JAX package.  ``state_from_numpy`` / ``state_to_numpy`` carry a world
between the two packages as nested dicts of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
)
from .device import resolve_device
from .prng import MASK32, prng_key
from .schema import ClassRegistry, ClassSpec, RecordSpec
from .strings import StringTable

HANDLE_ROW_BITS = 24
HANDLE_ROW_MASK = (1 << HANDLE_ROW_BITS) - 1


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


class _ClassHost:
    """Host bookkeeping for one class: free rows + row->guid."""

    def __init__(self, spec: ClassSpec, class_idx: int, capacity: int):
        self.spec = spec
        self.class_idx = class_idx
        self.capacity = capacity
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        self.row_guid: List[Optional[Guid]] = [None] * capacity
        self.alloc_mask = np.zeros(capacity, bool)

    def alloc_many(self, n: int) -> np.ndarray:
        if n <= 0:
            return np.zeros(0, np.int32)
        if len(self.free) < n:
            raise RuntimeError(
                f"class {self.spec.name!r} capacity {self.capacity} exhausted "
                f"({len(self.free)} free, {n} requested)"
            )
        rows = np.asarray(self.free[-n:][::-1], np.int32)
        del self.free[-n:]
        self.alloc_mask[rows] = True
        return rows

    def release(self, row: int) -> None:
        self.row_guid[row] = None
        self.free.append(row)
        self.alloc_mask[row] = False


_BANK_NP = {Bank.I32: np.int32, Bank.F32: np.float32, Bank.VEC: np.float32}
_FAST_TYPES = (DataType.INT, DataType.FLOAT, DataType.VECTOR2, DataType.VECTOR3)


class EntityStore:
    """Host-side owner of the device world: allocation, identity, typed
    access.  Methods take and return WorldState."""

    def __init__(
        self,
        registry: ClassRegistry,
        config: Optional[StoreConfig] = None,
        strings: Optional[StringTable] = None,
        device="cpu",
        class_names: Optional[Sequence[str]] = None,
    ):
        self.registry = registry
        self.config = config or StoreConfig()
        self.strings = strings or StringTable()
        self.guids = GuidAllocator()
        self.device = torch.device(device)
        names = list(class_names) if class_names is not None else registry.names()
        self.class_order: List[str] = names
        self.class_index: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self._hosts: Dict[str, _ClassHost] = {}
        self.guid_map: Dict[Guid, int] = {}  # guid -> packed handle
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
        return int(self._hosts[class_name].alloc_mask.sum())

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
                return np.int32(v)
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

    # -- create / reconcile -------------------------------------------------

    def create_many(
        self,
        state: WorldState,
        class_name: str,
        n: int,
        values: Optional[Dict[str, Any]] = None,
    ) -> Tuple[WorldState, List[Guid], np.ndarray]:
        """Bulk allocate n rows of class_name with per-property value
        columns; each written row is fully reset (banks to defaults or
        the given values, timers off, records cleared, alive on)."""
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
        rows = host.alloc_many(n)
        guids = self.guids.next_batch(n)
        ci = host.class_idx
        for g, row in zip(guids, rows.tolist()):
            self.guid_map[g] = pack_handle(ci, row)
            host.row_guid[row] = g
        if n == 0:
            return state, guids, rows

        cs = state.classes[class_name]
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)

        def put(bank, value):
            out = bank.clone()
            out[idx] = value if not isinstance(value, np.ndarray) else torch.from_numpy(value).to(self.device)
            return out

        t = cs.timers
        timers = TimerState(
            next_fire=put(t.next_fire, 0),
            interval=put(t.interval, 1),
            remain=put(t.remain, 0),
            active=put(t.active, False),
        )
        records = {
            r: RecordState(i32=put(rec.i32, 0), f32=put(rec.f32, 0.0),
                           vec=put(rec.vec, 0.0), used=put(rec.used, False))
            for r, rec in cs.records.items()
        }
        cs = cs.replace(
            i32=put(cs.i32, i32) if spec.n_i32 else cs.i32,
            f32=put(cs.f32, f32) if spec.n_f32 else cs.f32,
            vec=put(cs.vec, vec) if spec.n_vec else cs.vec,
            alive=put(cs.alive, True),
            timers=timers,
            records=records,
        )
        return with_class(state, class_name, cs), guids, rows

    def reconcile_deaths(self, state: WorldState, class_name: str) -> List[Guid]:
        """Free rows whose ``alive`` the device cleared; returns their guids."""
        host = self._hosts[class_name]
        alive = state.classes[class_name].alive.cpu().numpy()
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

    # -- record bulk write --------------------------------------------------

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
        rs = self.spec(class_name).records[record_name]
        cs = state.classes[class_name]
        rec = cs.records[record_name]
        banks = {Bank.I32: rec.i32, Bank.F32: rec.f32, Bank.VEC: rec.vec}
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
        for tag, vals in col_values.items():
            slot = rs.cols[tag]
            enc = self.encode_column(slot.col_def.type, slot.bank, vals)
            out = banks[slot.bank].clone()
            out[idx, rec_row, slot.col] = torch.from_numpy(enc).to(self.device)
            banks[slot.bank] = out
        used = rec.used
        if mark_used:
            used = used.clone()
            used[idx, rec_row] = True
        rec = RecordState(i32=banks[Bank.I32], f32=banks[Bank.F32],
                          vec=banks[Bank.VEC], used=used)
        return with_class(
            state, class_name, cs.replace(records={**cs.records, record_name: rec})
        )

    # -- column views -------------------------------------------------------

    def column(self, state: WorldState, class_name: str, prop_name: str) -> torch.Tensor:
        """Whole property column [C] (or [C, 3] for vectors)."""
        slot = self.spec(class_name).slot(prop_name)
        cs = state.classes[class_name]
        if slot.bank == Bank.I32:
            return cs.i32[:, slot.col]
        if slot.bank == Bank.F32:
            return cs.f32[:, slot.col]
        return cs.vec[:, slot.col]
