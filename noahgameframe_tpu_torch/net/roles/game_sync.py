"""The game role's property and record spine: per-frame accumulation of
property events and record diffs, the frame-batched broadcast index, the
per-entity property and record messages, the columnar
``ACK_BATCH_PROPERTY`` lanes (group-broadcast, interest-scoped and
batched), world-relayed sync from other games, and the leave events.

Counterpart of ``noahgameframe_tpu/net/roles/game.py:2172-2652`` and
``:3344-3668``.  Device reads are row-subset gathers (utils/hostio.py) and
whole record banks fetched once per flushed record; each is one host sync.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..defines import MsgID
from ..wire import (
    AckPlayerLeaveList,
    Ident,
    Message,
    MsgBase,
    ObjectPropertyFloat,
    ObjectPropertyInt,
    ObjectPropertyObject,
    ObjectPropertyString,
    ObjectPropertyVector2,
    ObjectPropertyVector3,
    ObjectRecordAddRow,
    ObjectRecordFloat,
    ObjectRecordInt,
    ObjectRecordObject,
    ObjectRecordRemove,
    ObjectRecordString,
    ObjectRecordVector3,
    PropertyFloat,
    PropertyInt,
    PropertyObject,
    PropertyString,
    PropertyVector2,
    PropertyVector3,
    RecordFloat,
    RecordInt,
    RecordObject,
    RecordString,
    RecordVector3,
    Vector2,
    Vector3,
    wrap,
)
from ...core.datatypes import Bank, DataType, Guid
from ...core.store import RecordOp
from ...kernel.kernel import (
    ObjectEvent,
    REC_ADDED,
    REC_REMOVED,
    REC_UPDATED,
)
from ...persist.codec import record_row_struct
from ...utils.hostio import gather_rows
from .game_session import guid_ident


class GameSyncMixin:
    def _queue_change(self, cname: str, pname: str, rows: np.ndarray) -> None:
        """Property-event sink: accumulate changed rows per (class, prop);
        flushed once per frame (per-write callbacks → per-tick batch)."""
        key = (cname, pname)
        prev = self._changed.get(key)
        self._changed[key] = (
            rows.copy() if prev is None else np.union1d(prev, rows)
        )

    # ---------------------------------------------------- record accumulation
    def _rec_bucket(self, cname: str, rname: str) -> Dict[str, object]:
        b = self._rec_changed.get((cname, rname))
        if b is None:
            # resync: rows whose FINAL state should be re-sent wholesale
            # (used -> add-row, unused -> remove).  Swaps land here: a
            # fixed replay order can't preserve intra-frame interleaving
            # of swap with other ops, but final-state resync always can.
            b = {"add": set(), "del": set(), "upd": {}, "resync": set()}
            self._rec_changed[(cname, rname)] = b
        return b

    def _on_record_host(self, cname, rname, op, erows, rec_row, tags) -> None:
        """Host-path per-op record hook (store mutators)."""
        if (cname, rname) not in self._synced_records:
            return
        b = self._rec_bucket(cname, rname)
        if op == RecordOp.ADD:
            for e in erows:
                key = (int(e), int(rec_row))
                if key not in b["resync"]:
                    b["add"].add(key)
        elif op == RecordOp.DEL:
            for e in erows:
                key = (int(e), int(rec_row))
                b["del"].add(key)
                b["add"].discard(key)
                b["upd"].pop(key, None)
                b["resync"].discard(key)
        elif op == RecordOp.UPDATE:
            for e in erows:
                key = (int(e), int(rec_row))
                if key in b["add"] or key in b["resync"]:
                    continue  # full-row send already pending
                cur = b["upd"].get(key, set())
                if cur is None or tags is None:
                    b["upd"][key] = None  # None = resend every column
                else:
                    b["upd"][key] = cur | set(tags)
        elif op == RecordOp.SWAP:
            origin, target = rec_row
            for e in erows:
                for r in (int(origin), int(target)):
                    key = (int(e), r)
                    b["resync"].add(key)
                    b["add"].discard(key)
                    b["upd"].pop(key, None)
                    b["del"].discard(key)

    def _on_record_diff(self, cname: str, rname: str, codes: np.ndarray) -> None:
        """Device-path record diff sink (buff expiry, stat groups, any
        device phase that rewrites record arrays)."""
        b = self._rec_bucket(cname, rname)
        ent, rr = np.nonzero(codes)
        for e, r, c in zip(ent.tolist(), rr.tolist(), codes[ent, rr].tolist()):
            key = (e, r)
            if c == REC_ADDED:
                if key not in b["resync"]:
                    b["add"].add(key)
            elif c == REC_REMOVED:
                b["del"].add(key)
                b["add"].discard(key)
                b["upd"].pop(key, None)
                b["resync"].discard(key)
            elif c == REC_UPDATED and key not in b["add"] and key not in b["resync"]:
                b["upd"][key] = None

    # ---------------------------------------------------- record serialization
    def _obj_ident(self, raw: int) -> Ident:
        g = self.kernel.store.guid_of_handle(int(raw))
        return guid_ident(g) if g is not None else Ident()

    def _record_cells(self, rs, r_i32, r_f32, r_vec, ent: int, r: int, tags):
        """Per-kind cell messages for one record row, via the ONE shared
        record→wire mapping (persist.codec.record_row_cells) so snapshots
        and per-change sync can never diverge."""
        from ...persist.codec import record_row_cells

        return record_row_cells(
            self.kernel.store, rs,
            r_i32[ent] if r_i32 is not None else None,
            r_f32[ent] if r_f32 is not None else None,
            r_vec[ent] if r_vec is not None else None,
            r, tags,
        )

    def _flush_records(self, player_idx=None) -> None:
        """Mid-session record sync: accumulated per-op + device-diff record
        changes → ACK_ADD_ROW / ACK_REMOVE_ROW / ACK_RECORD_* messages
        (reference OnRecordEvent, NFCGameServerNet_ServerModule.cpp:75-81)."""
        rec_changed, self._rec_changed = self._rec_changed, {}
        k = self.kernel
        if player_idx is None and rec_changed:
            player_idx = self._build_player_index()
        for (cname, rname), b in rec_changed.items():
            public = self._synced_records.get((cname, rname), False)
            spec = k.store.spec(cname)
            rs = spec.records[rname]
            rstate = k.state.classes[cname].records[rname]
            used = rstate.used.cpu().numpy()
            r_i32 = rstate.i32.cpu().numpy() if rs.n_i32 else None
            r_f32 = rstate.f32.cpu().numpy() if rs.n_f32 else None
            r_vec = rstate.vec.cpu().numpy() if rs.n_vec else None
            host = k.store._hosts[cname]
            rname_b = rname.encode()
            per_entity: Dict[int, Dict[str, object]] = {}

            def ops_of(e: int) -> Dict[str, object]:
                o = per_entity.get(e)
                if o is None:
                    o = {"del": [], "add": [], "upd": {}}
                    per_entity[e] = o
                return o

            for e, r in b["del"]:
                ops_of(e)["del"].append(r)
            for e, r in b["add"]:
                ops_of(e)["add"].append(r)
            # resync rows (swaps): final state decides add-row vs remove
            for e, r in b["resync"]:
                if used[e, r]:
                    ops_of(e)["add"].append(r)
                else:
                    ops_of(e)["del"].append(r)
            for (e, r), tags in b["upd"].items():
                ops_of(e)["upd"][r] = tags

            ent_rows = np.asarray(sorted(per_entity), np.int64)
            ent_cells = (
                self._rows_cells(cname, ent_rows)
                if ent_rows.size else np.zeros((0, 2), np.int64)
            )
            cell_of = {
                int(r): ent_cells[i].tolist() for i, r in enumerate(ent_rows)
            }
            vis_map = None
            if (public and self.interest_radius is not None
                    and self._interest_ok(cname)):
                # public record diffs reach only observers in range (and
                # the owner), same scope as the property lanes
                vis_map = self._interest_targets(cname, ent_rows)
            for e, ops in per_entity.items():
                guid = host.row_guid[e] if e < len(host.row_guid) else None
                if guid is None:
                    continue  # died since the change was queued
                sc, gr = cell_of[e]
                if vis_map is not None:
                    targets = list(vis_map.get(e, []))
                    if cname == "Player" and guid not in targets:
                        targets.append(guid)
                else:
                    targets = self._targets_from_index(
                        player_idx, guid, sc, gr, public, cname
                    )
                if not targets:
                    continue
                pid = guid_ident(guid)
                forward = public and cname == "Player"

                def emit(msg_id, msg):
                    self._broadcast(targets, msg_id, msg)
                    if forward:
                        self._forward_world(msg_id, msg, pid)

                if ops["del"]:
                    emit(MsgID.ACK_REMOVE_ROW,
                         ObjectRecordRemove(
                             player_id=pid, record_name=rname_b,
                             remove_row=sorted(set(ops["del"]))))
                add_rows = []
                for r in sorted(set(ops["add"])):
                    if not used[e, r]:
                        continue  # added then removed within the frame
                    add_rows.append(record_row_struct(
                        k.store, rs,
                        r_i32[e] if r_i32 is not None else None,
                        r_f32[e] if r_f32 is not None else None,
                        r_vec[e] if r_vec is not None else None,
                        r))
                if add_rows:
                    emit(MsgID.ACK_ADD_ROW,
                         ObjectRecordAddRow(
                             player_id=pid, record_name=rname_b,
                             row_data=add_rows))
                u_ints: List[RecordInt] = []
                u_floats: List[RecordFloat] = []
                u_strings: List[RecordString] = []
                u_objects: List[RecordObject] = []
                u_vecs: List[RecordVector3] = []
                for r, tags in sorted(ops["upd"].items()):
                    if not used[e, r]:
                        continue
                    ints, floats, strings, objects, vecs = self._record_cells(
                        rs, r_i32, r_f32, r_vec, e, r, tags)
                    u_ints += ints
                    u_floats += floats
                    u_strings += strings
                    u_objects += objects
                    u_vecs += vecs
                if u_ints:
                    emit(MsgID.ACK_RECORD_INT,
                         ObjectRecordInt(player_id=pid, record_name=rname_b,
                                         property_list=u_ints))
                if u_floats:
                    emit(MsgID.ACK_RECORD_FLOAT,
                         ObjectRecordFloat(player_id=pid, record_name=rname_b,
                                           property_list=u_floats))
                if u_strings:
                    emit(MsgID.ACK_RECORD_STRING,
                         ObjectRecordString(player_id=pid, record_name=rname_b,
                                            property_list=u_strings))
                if u_objects:
                    emit(MsgID.ACK_RECORD_OBJECT,
                         ObjectRecordObject(player_id=pid, record_name=rname_b,
                                            property_list=u_objects))
                if u_vecs:
                    emit(MsgID.ACK_RECORD_VECTOR3,
                         ObjectRecordVector3(player_id=pid, record_name=rname_b,
                                             property_list=u_vecs))

    # ------------------------------------------- frame-batched target index
    def _build_player_index(self, player_class: str = "Player"):
        """One-frame broadcast index: players by (scene, group) and by
        scene — built with ONE device fetch per frame, replacing the
        per-entity broadcast_targets calls (each of which fetched whole
        columns: O(N) host cost at scale)."""
        k = self.kernel
        by_cell: Dict[Tuple[int, int], List[Guid]] = {}
        by_scene: Dict[int, List[Guid]] = {}
        spec = k.store.spec(player_class)
        cs = k.state.classes[player_class]
        host = k.store._hosts[player_class]
        rows = np.flatnonzero(host.alloc_mask)
        if rows.size:
            cols = gather_rows(
                cs.i32, rows,
                cols=[spec.slots["SceneID"].col, spec.slots["GroupID"].col],
            )
            for r, (sc, gr) in zip(rows.tolist(), cols.tolist()):
                g = host.row_guid[r]
                if g is None:
                    continue
                by_cell.setdefault((sc, gr), []).append(g)
                by_scene.setdefault(sc, []).append(g)
        return by_cell, by_scene

    def _targets_from_index(self, idx, guid: Guid, sc: int, gr: int,
                            public: bool, cname: str) -> List[Guid]:
        """GetBroadCastObject over the frame index: Public → players in the
        same (scene, group), GroupID 0 → scene-wide; Private → self if a
        player (NFCSceneAOIModule.cpp:531-593)."""
        if not public:
            return [guid] if cname == "Player" else []
        by_cell, by_scene = idx
        if gr == 0:
            return by_scene.get(sc, [])
        return by_cell.get((sc, gr), [])

    def _query_visible(self, cname: str, changed: np.ndarray, obs_rows: np.ndarray,
                       obs_valid: np.ndarray):
        """The legacy interest query over the ``changed`` rows, fetched:
        ``(rows [S, 9K], ok [S, 9K])`` as numpy."""
        k = self.kernel
        cs = k.state.classes[cname]
        pcs = k.state.classes["Player"]
        fn = self._interest_query(cname, len(obs_rows))
        if self._interest_skin > 0.0:
            ckey, cache = self._interest_cache_for(cname)
            vrows, vok, cache = fn(
                cs.vec, cs.i32, self._to_dev(changed), cs.alive, pcs.vec, pcs.i32,
                self._to_dev(obs_rows), self._to_dev(obs_valid), cache,
            )
            self._interest_cache_store(ckey, cache)
        else:
            vrows, vok = fn(
                cs.vec, cs.i32, self._to_dev(changed), pcs.vec, pcs.i32,
                self._to_dev(obs_rows), self._to_dev(obs_valid),
            )
        return vrows.cpu().numpy(), vok.cpu().numpy()

    def _interest_targets(self, cname: str,
                          rows: np.ndarray) -> Dict[int, List[Guid]]:
        """Per-row visible OBSERVERS for the per-entity sync lanes: one
        device interest query over the changed rows, inverted into
        row -> [observer avatar guid].  With a radius set, "Public"
        means public to whoever can SEE you — not to the whole group
        (the reference's broadcast scope is the coarse (scene, group),
        NFCSceneAOIModule.cpp:531-593)."""
        out: Dict[int, List[Guid]] = {}
        if rows.size == 0:
            return out
        obs, obs_rows, obs_valid = self._observer_arrays()
        if not obs:
            return out
        k = self.kernel
        changed = np.zeros(k.store.capacity(cname), bool)
        changed[rows] = True
        cs = k.state.classes[cname]
        vrows, vok = self._query_visible(cname, changed, obs_rows, obs_valid)
        # per-entity property lane shared by both engines; diffs here are
        # < batch_sync_min rows, so the loop is small-N
        for i, sess in enumerate(obs):
            g = sess.guid
            if g is None:
                continue
            for r in vrows[i][vok[i]].tolist():
                out.setdefault(int(r), []).append(g)
        return out

    def _rows_cells(self, cname: str, rows: np.ndarray) -> np.ndarray:
        """[n, 2] (SceneID, GroupID) for the given rows — one device
        gather instead of two get_property round trips per entity."""
        k = self.kernel
        spec = k.store.spec(cname)
        cs = k.state.classes[cname]
        return gather_rows(
            cs.i32, rows,
            cols=[spec.slots["SceneID"].col, spec.slots["GroupID"].col],
        )

    def _flush_changes(self) -> None:
        """The batched §3.3 spine: changed cells → grouped property-sync
        messages → proxy (client lists in the envelope).  All device reads
        are row-subset gathers done once per class per frame."""
        k = self.kernel
        sc = self.stage_clock
        with sc.stage("harvest"):
            changed, self._changed = self._changed, {}
            player_idx = self._build_player_index()
            obs_moved = False
            if self.interest_radius is not None:
                # observer-set gate: any session join/leave/respawn must
                # wake the interest lane even with zero Position diffs.
                # Lives in HARVEST (it walks the session dict — shared
                # bookkeeping, not serve work; the batched engine's
                # interest stage is loop-free)
                obs_sig = tuple(sorted(
                    (key, s.guid)
                    for key, s in self.sessions.items()
                    if s.guid is not None
                    and s.guid in self.kernel.store.guid_map
                ))
                obs_moved = obs_sig != self._last_obs_sig
                self._last_obs_sig = obs_sig
                if self.serve_batch:
                    self._serve_refresh_table()
        # interest lane: Position diffs of synced classes leave as
        # per-session interest-filtered streams when a radius is set.
        # The pipeline only runs when something that can change a visible
        # set happened — a Position diff in the class, observer movement
        # (Player Position), an observer set change, or a create/destroy
        # in the class (the dirty marks) — so an idle world pays nothing.
        self._obs_cache = None  # one _observer_arrays() per flush
        if self.interest_radius is not None:
            with sc.stage("interest"):

                def zone_changed(cn: str) -> bool:
                    # visible sets mask on scene+group too — a swap with
                    # no Position diff still changes who sees whom.
                    # These keys are NOT popped: zone props also ride
                    # the normal broadcast sync.
                    return ((cn, "SceneID") in changed
                            or (cn, "GroupID") in changed)

                player_moved = ("Player", "Position") in changed \
                    or zone_changed("Player")
                for cname in self.sync_classes:
                    # only claim the diff when the class can ride the
                    # interest lane — non-spatial classes (no SceneID/
                    # GroupID) fall through to the broadcast lanes below
                    if not self._interest_ok(cname):
                        continue
                    pos_changed = changed.pop(
                        (cname, "Position"), None) is not None
                    if (pos_changed or player_moved or obs_moved
                            or zone_changed(cname)
                            or cname in self._interest_dirty):
                        self._interest_dirty.discard(cname)
                        if self.serve_overlap:
                            # double-buffered: serve this class's lane
                            # against the PRE-tick snapshot of the next
                            # frame, overlapping assembly with its tick
                            self._serve_pending[cname] = True
                        elif self.serve_batch:
                            self._send_interest_pos_batched(cname)
                        else:
                            self._send_interest_pos(cname)
        with sc.stage("encode"):
            # columnar fast lane: large public scalar/vector diffs leave
            # as packed-array batches (100k movers = a handful of
            # messages, not 100k python serializations)
            if self.batch_sync_min > 0:
                for key in [
                    kk for kk, rows in changed.items()
                    if rows.size >= self.batch_sync_min
                ]:
                    cname, pname = key
                    p = k.store.spec(cname).slot(pname).prop
                    if p.public and p.type in (
                        DataType.INT, DataType.FLOAT,
                        DataType.VECTOR2, DataType.VECTOR3,
                    ):
                        self._send_batch_property(
                            cname, pname, changed.pop(key), player_idx
                        )
            # regroup per (class, row): one message per entity per kind
            per_entity: Dict[Tuple[str, int], List[str]] = {}
            for (cname, pname), rows in changed.items():
                for row in rows:
                    per_entity.setdefault((cname, int(row)), []).append(pname)
            rows_by_class: Dict[str, np.ndarray] = {}
            for cname, row in per_entity:
                rows_by_class.setdefault(cname, []).append(row)
            pos_by_class: Dict[str, Dict[int, int]] = {}
            cells_by_class: Dict[str, np.ndarray] = {}
            vis_by_class: Dict[str, Dict[int, List[Guid]]] = {}
            for cname, rws in list(rows_by_class.items()):
                arr = np.asarray(sorted(set(rws)), np.int64)
                rows_by_class[cname] = arr
                pos_by_class[cname] = {int(r): i for i, r in enumerate(arr)}
                cells_by_class[cname] = self._rows_cells(cname, arr)
                if (self.interest_radius is not None
                        and self._interest_ok(cname)):
                    # device visibility query: interest work even though
                    # it feeds the encode loop below
                    with sc.stage("interest"):
                        vis_by_class[cname] = self._interest_targets(
                            cname, arr)
            sub_cache: Dict[Tuple[str, str], np.ndarray] = {}

            def bank_vals(cname: str, bank: Bank) -> np.ndarray:
                """Row-subset bank fetch, indexed by LOCAL position."""
                key = (cname, bank.value)
                if key not in sub_cache:
                    cs = k.state.classes[cname]
                    sub_cache[key] = gather_rows(
                        getattr(cs, bank.value), rows_by_class[cname]
                    )
                return sub_cache[key]

            for (cname, row), pnames in per_entity.items():
                host = k.store._hosts[cname]
                guid = host.row_guid[row] if row < len(host.row_guid) else None
                if guid is None:
                    continue  # died since the change was queued
                spec = k.store.spec(cname)
                pos = pos_by_class[cname][row]
                scn, gr = cells_by_class[cname][pos].tolist()
                # public props broadcast to the (scene, group); private-
                # only props go to the owner's client alone
                for public in (True, False):
                    sel = [
                        p for p in pnames
                        if bool(spec.slot(p).prop.public) is public
                        and (public or spec.slot(p).prop.private)
                    ]
                    if not sel:
                        continue
                    if public and cname in vis_by_class:
                        # interest lane: public to whoever can see you,
                        # plus always the owner's own client
                        targets = list(vis_by_class[cname].get(row, []))
                        if cname == "Player" and guid not in targets:
                            targets.append(guid)
                    else:
                        targets = self._targets_from_index(
                            player_idx, guid, scn, gr, public, cname
                        )
                    if not targets:
                        continue
                    self._send_property_msgs(
                        cname, pos, guid, sel, targets, bank_vals,
                        forward=(public and cname == "Player"),
                    )
            self._flush_records(player_idx)

    def _send_batch_property_interest_batched(
        self, cname: str, pname: str, rows: np.ndarray
    ) -> None:
        """Batched interest-scoped columnar sync: one device query for
        all sessions, one value gather, per-session byte slices."""
        from ..serving import segments
        from ..wire import BatchPropertySync

        k = self.kernel
        st = self._session_table
        host = k.store._hosts[cname]
        spec = k.store.spec(cname)
        slot = spec.slot(pname)
        rows = rows[host.alloc_mask[rows]]
        if rows.size == 0 or st.capacity == 0 or not st.valid.any():
            return
        cap = k.store.capacity(cname)
        changed = np.zeros(cap, bool)
        changed[rows] = True
        cs = k.state.classes[cname]
        pcs = k.state.classes["Player"]
        fn = self._serve_query(cname, st.capacity)
        obs_rows = self._to_dev(st.avatar_row.astype(np.int64))
        valid = self._to_dev(st.valid)
        alloc_ok = self._to_dev(host.alloc_mask)
        if self._interest_skin > 0.0:
            ckey, cache = self._interest_cache_for(cname)
            vrows, counts, cache = fn(
                cs.vec, cs.i32, self._to_dev(changed), cs.alive,
                pcs.vec, pcs.i32, obs_rows, valid, alloc_ok, cache,
            )
            self._interest_cache_store(ckey, cache)
        else:
            vrows, counts = fn(
                cs.vec, cs.i32, self._to_dev(changed),
                pcs.vec, pcs.i32, obs_rows, valid, alloc_ok,
            )
        self._serve_dispatches.inc()
        vrows, counts = vrows.cpu().numpy(), counts.cpu().numpy()

        if slot.bank == Bank.VEC:
            vals = gather_rows(cs.vec, rows, cols=slot.col)[:, 0]
        elif slot.bank == Bank.F32:
            vals = gather_rows(cs.f32, rows, cols=slot.col)[:, 0]
        else:
            vals = gather_rows(cs.i32, rows, cols=slot.col)[:, 0]
        vals = np.asarray(vals)
        pos_of = np.full(cap, -1, np.int64)
        pos_of[rows] = np.arange(rows.size)

        with self.stage_clock.stage("assemble"):
            mask = np.arange(vrows.shape[1])[None, :] < counts[:, None]
            flat = vrows[mask]  # session-major, slot order per session
            heads_b = host.guid_head[flat].tobytes()
            datas_b = host.guid_data[flat].tobytes()
            vals_flat = np.ascontiguousarray(vals[pos_of[flat]])
            item = vals_flat.itemsize * (
                int(np.prod(vals_flat.shape[1:])) if vals_flat.ndim > 1
                else 1
            )
            data_b = vals_flat.tobytes()
            o8, _ = segments(counts, 8, heads_b)
            ov, _ = segments(counts, item, data_b)
            name_b, cls_b = pname.encode(), cname.encode()
            ptype = int(slot.prop.type)
            sent = 0
            for key, sess in self.sessions.items():
                si = st.slot_of.get(key)
                if si is None or not st.valid[si]:
                    continue
                n = int(counts[si])
                if n == 0:
                    continue
                msg = BatchPropertySync(
                    class_name=cls_b,
                    property_name=name_b,
                    ptype=ptype,
                    count=n,
                    svrid=heads_b[o8[si]:o8[si + 1]],
                    index=datas_b[o8[si]:o8[si + 1]],
                    data=data_b[ov[si]:ov[si + 1]],
                )
                self._send_to_session(sess, MsgID.ACK_BATCH_PROPERTY, msg)
                sent += 1
            self._serve_packets.inc(sent)

    def _send_batch_property_interest(self, cname: str, pname: str,
                                      rows: np.ndarray) -> None:
        """Interest-scoped columnar sync: each session gets ONE
        BatchPropertySync with only the changed entities inside its
        interest radius (same message type as the broadcast lane, so
        clients are agnostic to the fan-out mode)."""
        from ..wire import BatchPropertySync

        k = self.kernel
        host = k.store._hosts[cname]
        spec = k.store.spec(cname)
        slot = spec.slot(pname)
        rows = rows[host.alloc_mask[rows]]
        if rows.size == 0:
            return
        obs, obs_rows, obs_valid = self._observer_arrays()
        if not obs:
            return
        cap = k.store.capacity(cname)
        changed = np.zeros(cap, bool)
        changed[rows] = True
        cs = k.state.classes[cname]
        vrows, vok = self._query_visible(cname, changed, obs_rows, obs_valid)
        # one value gather for the changed set; per-session subsets map
        # through pos_of (changed row -> position in `rows`)
        if slot.bank == Bank.VEC:
            vals = gather_rows(cs.vec, rows, cols=slot.col)[:, 0]
        elif slot.bank == Bank.F32:
            vals = gather_rows(cs.f32, rows, cols=slot.col)[:, 0]
        else:
            vals = gather_rows(cs.i32, rows, cols=slot.col)[:, 0]
        vals = np.asarray(vals)
        pos_of = np.full(cap, -1, np.int64)
        pos_of[rows] = np.arange(rows.size)
        name_b, cls_b = pname.encode(), cname.encode()
        ptype = int(slot.prop.type)
        # legacy columnar lane (NF_SERVE_BATCH=0), the parity oracle for
        # the batched _send_batch_property_interest_batched above
        for i, sess in enumerate(obs):
            vis = vrows[i][vok[i]]
            vis = vis[host.alloc_mask[vis]]
            if vis.size == 0:
                continue
            idx = pos_of[vis]
            msg = BatchPropertySync(
                class_name=cls_b,
                property_name=name_b,
                ptype=ptype,
                count=int(vis.size),
                svrid=host.guid_head[vis].tobytes(),
                index=host.guid_data[vis].tobytes(),
                data=np.ascontiguousarray(vals[idx]).tobytes(),
            )
            self._send_to_session(sess, MsgID.ACK_BATCH_PROPERTY, msg)

    def _send_batch_property(self, cname: str, pname: str, rows: np.ndarray,
                             player_idx) -> None:
        """Columnar sync: ONE gather off the device + packed-array message
        per (scene, group) cell with observers.  This is the wire mirror
        of the SoA store — the per-entity proto path stays for strings,
        objects, private props and small diffs."""
        if self.interest_radius is not None and self._interest_ok(cname):
            if self.serve_batch:
                self._send_batch_property_interest_batched(cname, pname, rows)
            else:
                self._send_batch_property_interest(cname, pname, rows)
            return
        from ...kernel.scene import MAX_GROUPS_PER_SCENE
        from ..wire import BatchPropertySync

        k = self.kernel
        host = k.store._hosts[cname]
        spec = k.store.spec(cname)
        slot = spec.slot(pname)
        rows = rows[host.alloc_mask[rows]]  # drop rows that died
        if rows.size == 0:
            return
        cells = self._rows_cells(cname, rows)  # [n, 2]
        cs = k.state.classes[cname]
        if slot.bank == Bank.VEC:
            vals = gather_rows(cs.vec, rows, cols=slot.col)[:, 0]  # [n, 3]
        elif slot.bank == Bank.F32:
            vals = gather_rows(cs.f32, rows, cols=slot.col)[:, 0]
        else:
            vals = gather_rows(cs.i32, rows, cols=slot.col)[:, 0]
        heads = host.guid_head[rows]
        datas = host.guid_data[rows]
        cell_ids = cells[:, 0].astype(np.int64) * MAX_GROUPS_PER_SCENE + cells[:, 1]
        order = np.argsort(cell_ids, kind="stable")
        sorted_ids = cell_ids[order]
        uniq, starts = np.unique(sorted_ids, return_index=True)
        bounds = list(starts.tolist()) + [len(order)]
        name_b = pname.encode()
        cls_b = cname.encode()
        ptype = int(slot.prop.type)
        for i, cid in enumerate(uniq.tolist()):
            sc, gr = divmod(int(cid), MAX_GROUPS_PER_SCENE)
            targets = self._targets_from_index(
                player_idx, None, sc, gr, True, cname
            )
            if not targets:
                continue
            seg = order[bounds[i]:bounds[i + 1]]
            msg = BatchPropertySync(
                class_name=cls_b,
                property_name=name_b,
                ptype=ptype,
                count=int(seg.size),
                svrid=heads[seg].tobytes(),
                index=datas[seg].tobytes(),
                data=np.ascontiguousarray(vals[seg]).tobytes(),
            )
            self._broadcast(targets, MsgID.ACK_BATCH_PROPERTY, msg)

    def _forward_world(self, msg_id: int, msg: Message, pid: Ident) -> None:
        """Push a sync message up the world link for cross-game relay."""
        if self.cross_server_sync:
            self.world_link.send_to_all(int(msg_id), wrap(msg, player_id=pid))

    def _send_property_msgs(self, cname, row, guid, pnames, targets,
                            bank_vals, forward: bool = False) -> None:
        k = self.kernel
        spec = k.store.spec(cname)
        ints: List[PropertyInt] = []
        floats: List[PropertyFloat] = []
        strings: List[PropertyString] = []
        objects: List[PropertyObject] = []
        vec2s: List[PropertyVector2] = []
        vec3s: List[PropertyVector3] = []
        for pname in pnames:
            slot = spec.slot(pname)
            raw = bank_vals(cname, slot.bank)[row, slot.col]
            p = slot.prop
            if p.type == DataType.INT:
                ints.append(PropertyInt(
                    property_name=p.name.encode(), data=int(raw)))
            elif p.type == DataType.FLOAT:
                floats.append(PropertyFloat(
                    property_name=p.name.encode(), data=float(raw)))
            elif p.type == DataType.STRING:
                strings.append(PropertyString(
                    property_name=p.name.encode(),
                    data=k.store.strings.lookup(int(raw)).encode()))
            elif p.type == DataType.OBJECT:
                objects.append(PropertyObject(
                    property_name=p.name.encode(),
                    data=self._obj_ident(int(raw))))
            elif p.type == DataType.VECTOR2:
                vec2s.append(PropertyVector2(
                    property_name=p.name.encode(),
                    data=Vector2(x=float(raw[0]), y=float(raw[1]))))
            else:
                vec3s.append(PropertyVector3(
                    property_name=p.name.encode(),
                    data=Vector3(x=float(raw[0]), y=float(raw[1]),
                                 z=float(raw[2]))))
        pid = guid_ident(guid)
        # dedicated per-type messages matching the reference proto
        # (ObjectProperty{Int,Float,String,Object,Vector2,Vector3} all carry
        # player_id=1, property_list=2 — a protoc-generated client decodes
        # these directly)
        for msg_id, cls, items in (
            (MsgID.ACK_PROPERTY_INT, ObjectPropertyInt, ints),
            (MsgID.ACK_PROPERTY_FLOAT, ObjectPropertyFloat, floats),
            (MsgID.ACK_PROPERTY_STRING, ObjectPropertyString, strings),
            (MsgID.ACK_PROPERTY_OBJECT, ObjectPropertyObject, objects),
            (MsgID.ACK_PROPERTY_VECTOR2, ObjectPropertyVector2, vec2s),
            (MsgID.ACK_PROPERTY_VECTOR3, ObjectPropertyVector3, vec3s),
        ):
            if items:
                msg = cls(player_id=pid, property_list=items)
                self._broadcast(targets, msg_id, msg)
                if forward:
                    self._forward_world(msg_id, msg, pid)

    # --------------------------------------------------- cross-game delivery
    def _on_world_sync(self, _sid: int, msg_id: int, body: bytes) -> None:
        """World-relayed sync from another game server: deliver to every
        local client (world-scope visibility; the client mirror creates
        remote objects lazily on first property message)."""
        if not self.sessions:
            return
        base = MsgBase.decode(body)
        src = self._guid_of_ident(base.player_id)
        if src is not None and src in self.kernel.store.guid_map:
            return  # the entity lives here — local broadcast already covered it
        if msg_id == int(MsgID.ACK_ONLINE_NOTIFY):
            return  # mirror objects appear lazily with the first sync message
        per_conn: Dict[int, List[Ident]] = {}
        for sess in self.sessions.values():
            per_conn.setdefault(sess.conn_id, []).append(sess.ident)
        if msg_id == int(MsgID.ACK_OFFLINE_NOTIFY):
            leave = AckPlayerLeaveList(object_list=[base.player_id])
            for conn_id, idents in per_conn.items():
                self._send_to(idents, conn_id, MsgID.ACK_OBJECT_LEAVE, leave)
            return
        for conn_id, idents in per_conn.items():
            self.server.send_raw(
                conn_id, msg_id,
                MsgBase(player_id=base.player_id, msg_data=base.msg_data,
                        player_client_list=idents).encode(),
            )

    # ------------------------------------------------------------ leave events
    def _on_class_event(self, guid: Guid, _cname: str, ev: ObjectEvent) -> None:
        if ev == ObjectEvent.DESTROY and guid in self._guid_session:
            # destroyed outside _despawn (e.g. device death): clear binding
            key = self._guid_session.pop(guid)
            sess = self.sessions.get(key)
            if sess is not None:
                sess.guid = None
                self.reset_view(sess)

    def _on_npc_event(self, guid: Guid, _cname: str, ev: ObjectEvent) -> None:
        if ev == ObjectEvent.DESTROY and self.sessions:
            leave = AckPlayerLeaveList(object_list=[guid_ident(guid)])
            for sess in self.sessions.values():
                self._send_to_session(sess, MsgID.ACK_OBJECT_LEAVE, leave)
