"""Schema-driven object ↔ wire serialization (persistence + sync share it).

Reference: NFCCommonRedisModule converts a live object's property/record
managers to `ObjectPropertyList`/`ObjectRecordList` protos and back
(`NFCCommonRedisModule.h:45-49`); only properties/records flagged
Save/Cache participate (flag plumbing `NFCKernelModule.cpp:158-184`).
The network sync path serializes the *same* structures with a different
flag predicate (Public/Private, `NFCGameServerNet_ServerModule.cpp:
271-400`), so both paths here go through one serializer parameterized by
a predicate — the save blob is literally a replayable sync burst.

GUID-valued cells (OBJECT properties and record columns) are written as
wire Idents, never as packed row handles: row handles are allocation-
dependent and dangle across restarts.

Counterpart of ``noahgameframe_tpu/persist/codec.py``: the same bytes for
the same entity (cells are read from the port's banks as numpy, so a
float cell is encoded from the same float32 bits, and strings and
vectors go through the same intern table).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.datatypes import Bank, DataType, Guid
from ..core.store import EntityStore, WorldState, _cpu
from ..net.wire import (
    Ident,
    Message,
    ObjectPropertyList,
    ObjectRecordBase,
    ObjectRecordList,
    PropertyFloat,
    PropertyInt,
    PropertyObject,
    PropertyString,
    PropertyVector3,
    RecordAddRowStruct,
    RecordFloat,
    RecordInt,
    RecordObject,
    RecordString,
    RecordVector3,
    Vector3,
)

# predicate over a PropertyDef / RecordDef deciding inclusion
DefPredicate = Callable[[object], bool]


def flag_predicate(flags: Tuple[str, ...]) -> DefPredicate:
    return lambda d: any(d.flag(f) for f in flags)


def _guid_to_ident(store: EntityStore, handle: int) -> Ident:
    g = store.guid_of_handle(int(handle))
    return Ident(svrid=g.head if g else 0, index=g.data if g else 0)


def record_row_cells(store, rs, i32_rows, f32_rows, vec_rows, r_i, tags=None):
    """Per-kind wire cell lists for one record row — the ONE record→wire
    cell mapping (snapshots and per-change sync must emit identical
    encodings).  `i32_rows`/`f32_rows`/`vec_rows` are one entity's record
    arrays [R, ncols]; `col` on the wire is the position in col_order;
    `tags` restricts to a column subset (None = all)."""
    ints, floats, strings, objects, vecs = [], [], [], [], []
    for c_i, tag in enumerate(rs.col_order):
        if tags is not None and tag not in tags:
            continue
        cslot = rs.cols[tag]
        t = cslot.col_def.type
        if cslot.bank == Bank.I32:
            raw = int(i32_rows[r_i, cslot.col])
            if t == DataType.STRING:
                strings.append(RecordString(
                    row=r_i, col=c_i,
                    data=store.strings.lookup(raw).encode()))
            elif t == DataType.OBJECT:
                objects.append(RecordObject(
                    row=r_i, col=c_i, data=_guid_to_ident(store, raw)))
            else:
                ints.append(RecordInt(row=r_i, col=c_i, data=raw))
        elif cslot.bank == Bank.F32:
            floats.append(RecordFloat(
                row=r_i, col=c_i, data=float(f32_rows[r_i, cslot.col])))
        else:
            v = vec_rows[r_i, cslot.col]
            vecs.append(RecordVector3(
                row=r_i, col=c_i,
                data=Vector3(x=float(v[0]), y=float(v[1]), z=float(v[2]))))
    return ints, floats, strings, objects, vecs


def record_row_struct(store, rs, i32_rows, f32_rows, vec_rows, r_i,
                      tags=None) -> RecordAddRowStruct:
    """One full record row as a wire RecordAddRowStruct."""
    ints, floats, strings, objects, vecs = record_row_cells(
        store, rs, i32_rows, f32_rows, vec_rows, r_i, tags)
    return RecordAddRowStruct(
        row=r_i, record_int_list=ints, record_float_list=floats,
        record_string_list=strings, record_object_list=objects,
        record_vector3_list=vecs)


def serialize_properties(
    store: EntityStore,
    state: WorldState,
    guid: Guid,
    pred: DefPredicate,
) -> ObjectPropertyList:
    """One entity's predicate-selected properties as a wire list, read
    straight out of the SoA row slices."""
    cname, row = store.row_of(guid)
    spec = store.spec(cname)
    cs = state.classes[cname]
    out = ObjectPropertyList(player_id=Ident(svrid=guid.head, index=guid.data))
    banks = {
        Bank.I32: _cpu(cs.i32[row]),
        Bank.F32: _cpu(cs.f32[row]),
        Bank.VEC: _cpu(cs.vec[row]),
    }
    for bank, rowvals in banks.items():
        for slot in spec.bank_props(bank):
            p = slot.prop
            if not pred(p):
                continue
            raw = rowvals[slot.col]
            name = p.name.encode()
            if p.type == DataType.INT:
                out.property_int_list.append(
                    PropertyInt(property_name=name, data=int(raw)))
            elif p.type == DataType.FLOAT:
                out.property_float_list.append(
                    PropertyFloat(property_name=name, data=float(raw)))
            elif p.type == DataType.STRING:
                out.property_string_list.append(PropertyString(
                    property_name=name,
                    data=store.strings.lookup(int(raw)).encode()))
            elif p.type == DataType.OBJECT:
                out.property_object_list.append(PropertyObject(
                    property_name=name, data=_guid_to_ident(store, raw)))
            else:  # VECTOR2 / VECTOR3 (vec bank)
                out.property_vector3_list.append(PropertyVector3(
                    property_name=name,
                    data=Vector3(x=float(raw[0]), y=float(raw[1]),
                                 z=float(raw[2]))))
    return out


def serialize_records(
    store: EntityStore,
    state: WorldState,
    guid: Guid,
    pred: DefPredicate,
) -> ObjectRecordList:
    """One entity's predicate-selected records, all column types."""
    cname, row = store.row_of(guid)
    spec = store.spec(cname)
    cs = state.classes[cname]
    out = ObjectRecordList(player_id=Ident(svrid=guid.head, index=guid.data))
    for rname, rs in spec.records.items():
        if not pred(rs.rec):
            continue
        rstate = cs.records[rname]
        used = _cpu(rstate.used[row])
        if not used.any():
            continue
        r_i32 = _cpu(rstate.i32[row]) if rs.n_i32 else None
        r_f32 = _cpu(rstate.f32[row]) if rs.n_f32 else None
        r_vec = _cpu(rstate.vec[row]) if rs.n_vec else None
        base = ObjectRecordBase(record_name=rname.encode())
        for r_i in np.flatnonzero(used):
            base.row_struct.append(
                record_row_struct(store, rs, r_i32, r_f32, r_vec, int(r_i))
            )
        out.record_list.append(base)
    return out


class ObjectDataPack(Message):
    """The persisted unit: class name + flagged properties + records."""

    FIELDS = [
        (1, "class_name", "bytes", b""),
        (2, "property_list", ObjectPropertyList, None),
        (3, "record_list", ObjectRecordList, None),
        (4, "guid", Ident, None),
    ]


def snapshot_object(
    store: EntityStore,
    state: WorldState,
    guid: Guid,
    flags: Tuple[str, ...] = ("save",),
) -> bytes:
    """Serialize the flag-masked slice of one entity (save-on-destroy)."""
    cname, _ = store.row_of(guid)
    pred = flag_predicate(flags)
    return ObjectDataPack(
        class_name=cname.encode(),
        property_list=serialize_properties(store, state, guid, pred),
        record_list=serialize_records(store, state, guid, pred),
        guid=Ident(svrid=guid.head, index=guid.data),
    ).encode()


def _ident_to_guid(store: EntityStore, ident: Optional[Ident]) -> Optional[Guid]:
    if ident is None:
        return Guid()
    g = Guid(ident.svrid, ident.index)
    if g.is_null() or g in store.guid_map:
        return g
    return None  # referenced entity doesn't exist (yet)


# one unresolved OBJECT reference: owner guid, site, target guid.  site is
# ("prop", name) or ("rec", record_name, row, tag)
PendingRef = Tuple[Guid, Tuple, Guid]


def resolve_pending(
    store: EntityStore, state: WorldState, pending: List[PendingRef]
) -> Tuple[WorldState, List[PendingRef]]:
    """Re-apply deferred OBJECT references whose targets now exist (call
    after a bulk load so restores aren't load-order dependent).  Returns
    (state', still-unresolved)."""
    left: List[PendingRef] = []
    for owner, site, target in pending:
        if owner not in store.guid_map:
            continue  # owner died before the target appeared
        if target not in store.guid_map:
            left.append((owner, site, target))
            continue
        if site[0] == "prop":
            state = store.set_property(state, owner, site[1], target)
        else:
            _, rname, row, tag = site
            state = store.record_set(state, owner, rname, row, tag, target)
    return state, left


def apply_snapshot(
    store: EntityStore,
    state: WorldState,
    guid: Guid,
    blob: bytes,
    pending: Optional[List[PendingRef]] = None,
) -> WorldState:
    """Write a saved blob back onto a live entity (load-on-create,
    the COE_CREATE_LOADDATA attach).

    OBJECT references to not-yet-loaded entities are appended to `pending`
    (resolve with resolve_pending after the batch) instead of being
    silently dropped; with pending=None they are dropped as before."""
    pack = ObjectDataPack.decode(blob)
    cname, _ = store.row_of(guid)
    spec = store.spec(cname)
    # self-references (WearGUID = owner, MasterID = owner, ...) must
    # remap to the entity's NEW guid: a relog mints a fresh guid, and the
    # old one will never exist again
    old_self = (Guid(pack.guid.svrid, pack.guid.index)
                if pack.guid is not None else None)

    def deref(ident: Optional[Ident]) -> Optional[Guid]:
        if (old_self is not None and ident is not None
                and Guid(ident.svrid, ident.index) == old_self):
            return guid
        return _ident_to_guid(store, ident)

    pl = pack.property_list or ObjectPropertyList()
    for p in pl.property_int_list:
        name = p.property_name.decode()
        if spec.has_property(name):
            state = store.set_property(state, guid, name, int(p.data))
    for p in pl.property_float_list:
        name = p.property_name.decode()
        if spec.has_property(name):
            state = store.set_property(state, guid, name, float(p.data))
    for p in pl.property_string_list:
        name = p.property_name.decode()
        if spec.has_property(name):
            state = store.set_property(state, guid, name, p.data.decode())
    for p in pl.property_object_list:
        name = p.property_name.decode()
        if spec.has_property(name):
            target = deref(p.data)
            if target is not None:
                state = store.set_property(state, guid, name, target)
            elif pending is not None and p.data is not None:
                pending.append(
                    (guid, ("prop", name), Guid(p.data.svrid, p.data.index))
                )
    for p in pl.property_vector3_list:
        name = p.property_name.decode()
        if not spec.has_property(name):
            continue
        v = p.data or Vector3()
        t = spec.slot(name).prop.type
        val = (v.x, v.y) if t == DataType.VECTOR2 else (v.x, v.y, v.z)
        state = store.set_property(state, guid, name, val)

    rl = pack.record_list or ObjectRecordList()
    for rec in rl.record_list:
        rname = rec.record_name.decode()
        if rname not in spec.records:
            continue
        rs = spec.records[rname]

        def tag_of(col: int) -> Optional[str]:
            return rs.col_order[col] if col < len(rs.col_order) else None

        for rowmsg in rec.row_struct:
            values: Dict[str, object] = {}
            for c in rowmsg.record_int_list:
                tag = tag_of(c.col)
                if tag is not None:
                    values[tag] = int(c.data)
            for c in rowmsg.record_float_list:
                tag = tag_of(c.col)
                if tag is not None:
                    values[tag] = float(c.data)
            for c in rowmsg.record_string_list:
                tag = tag_of(c.col)
                if tag is not None:
                    values[tag] = c.data.decode()
            for c in rowmsg.record_object_list:
                tag = tag_of(c.col)
                if tag is not None:
                    target = deref(c.data)
                    if target is not None:
                        values[tag] = target
                    elif (pending is not None and c.data is not None
                          and int(rowmsg.row) < rs.max_rows):
                        pending.append((
                            guid,
                            ("rec", rname, int(rowmsg.row), tag),
                            Guid(c.data.svrid, c.data.index),
                        ))
            for c in rowmsg.record_vector3_list:
                tag = tag_of(c.col)
                if tag is None:
                    continue
                v = c.data or Vector3()
                t = rs.cols[tag].col_def.type
                values[tag] = ((v.x, v.y) if t == DataType.VECTOR2
                               else (v.x, v.y, v.z))
            if rowmsg.row < rs.max_rows:
                state = store.record_restore_row(
                    state, guid, rname, int(rowmsg.row), values
                )
    return state
