"""The game role's interest and serve lanes.

Counterpart of ``noahgameframe_tpu/net/roles/game.py:2653-3343``: the
per-session Position stream (``_send_interest_pos``, the legacy engine),
the interest queries that scope the per-entity and columnar lanes, the
interest Verlet cache carried in ``WorldState.aux``, and the batched serve
engine (``NF_SERVE_BATCH``: ``_serve_pos_collect`` on the device,
``_serve_pos_emit`` on the host).

Every step runs eagerly on the world's device and is recorded in the
kernel's cost book as a graph-less entry (``interest.step/<class>``,
``serve.scan/<class>``, ...), keyed as in the JAX package by (class,
padded session count).  They are not captured as CUDA graphs: their
inputs are uploaded from host mirrors every flush (observer rows, the
changed-row mask, allocation generations) and their outputs are fetched
at once, so a graph would replay a handful of small launches between two
host syncs it cannot remove.  The cost book still records each entry's
calls and every signature change with its cause.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..defines import MsgID
from .game_session import _env_int


class GameInterestMixin:
    # ---------------------------------------------------------- helpers
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array uploaded to the world's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.kernel.device)

    def _book_entry(self, name: str, fn: Callable) -> Callable:
        """``fn(*args)`` dispatched through a graph-less cost-book entry
        (see the module docstring)."""
        dispatch = self.kernel.costbook.wrap(
            name, lambda args: (None, fn(*args)), stage="interest")
        return lambda *args: dispatch(args)[1]

    def _interest_cols(self, cname: str):
        """(pos, scene, group) columns of ``cname`` and of Player."""
        spec = self.kernel.store.spec(cname)
        pspec = self.kernel.store.spec("Player")
        return (
            spec.slots["Position"].col, spec.slots["SceneID"].col,
            spec.slots["GroupID"].col, pspec.slots["Position"].col,
            pspec.slots["SceneID"].col, pspec.slots["GroupID"].col,
        )

    def _interest_grid(self, cname: str):
        """(cell, width, bucket) of the class's interest grid."""
        from ...ops.stencil import auto_bucket

        extent = float(self.game_world.config.extent)
        radius = float(self.interest_radius)
        skin = float(self._interest_skin)
        # skin > 0 inflates the cell so the 3x3 read still covers the true
        # radius from anchors up to skin/2 stale (ops/verlet.py)
        cell = radius + skin if skin > 0.0 else radius
        width = max(1, int(np.ceil(extent / cell)))
        bucket = auto_bucket(self.kernel.store.capacity(cname), width)
        return cell, width, bucket

    # ---------------------------------------------------- legacy queries
    def _interest_step(self, cname: str, s_pad: int):
        """Cached per-(class, padded-session-count) interest pipeline:
        quantize positions, bin ALL alive in-extent entities into the cell
        table, read each observer's 3x3 neighborhood, distance+zone mask
        (ops/interest; the same stencil engine combat runs on).

        Visibility runs over the full alive set — not just movers — so the
        host can diff each session's visible set against what that session
        last saw: entities that moved while unobserved and then stopped are
        re-sent the moment an observer walks into range (the reference's
        enter-view resend, NFCSceneAOIModule OnObjectListEnter)."""
        key = (cname, s_pad)
        fn = self._interest_fns.get(key)
        if fn is not None:
            return fn
        from ...ops.interest import quantize, visible_candidates, visible_candidates_cached

        pos_col, sc_col, gr_col, p_pos, p_sc, p_gr = self._interest_cols(cname)
        extent = float(self.game_world.config.extent)
        radius = float(self.interest_radius)
        skin = float(self._interest_skin)
        cell, width, bucket = self._interest_grid(cname)
        f32 = torch.float32

        if skin > 0.0:
            def step(evec, ei32, alive, pvec, pi32, obs_rows, obs_valid, cache):
                pos3 = evec[:, pos_col]
                q, in_extent = quantize(pos3, alive, extent)
                res, cache, _rebuilt = visible_candidates_cached(
                    cache, pos3, in_extent, alive,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width,
                    bucket=bucket, skin=skin,
                )
                return q, res.rows, res.ok & obs_valid[:, None], cache
        else:
            def step(evec, ei32, alive, pvec, pi32, obs_rows, obs_valid):
                pos3 = evec[:, pos_col]
                q, in_extent = quantize(pos3, alive, extent)
                res = visible_candidates(
                    pos3, in_extent,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width, bucket=bucket,
                )
                return q, res.rows, res.ok & obs_valid[:, None]

        fn = self._book_entry(f"interest.step/{cname}", step)
        self._interest_fns[key] = fn
        return fn

    def _interest_query(self, cname: str, s_pad: int):
        """Cached query-only interest pipeline: caller supplies the
        changed-row mask (any property's diff), gets per-observer visible
        candidates.  The Position stream has its own variant with the
        quantize/delta gate fused in (_interest_step)."""
        key = ("q", cname, s_pad)
        fn = self._interest_fns.get(key)
        if fn is not None:
            return fn
        from ...ops.interest import visible_candidates, visible_candidates_cached

        pos_col, sc_col, gr_col, p_pos, p_sc, p_gr = self._interest_cols(cname)
        radius = float(self.interest_radius)
        skin = float(self._interest_skin)
        cell, width, bucket = self._interest_grid(cname)
        f32 = torch.float32

        if skin > 0.0:
            def query(evec, ei32, changed, alive, pvec, pi32, obs_rows, obs_valid, cache):
                res, cache, _rebuilt = visible_candidates_cached(
                    cache, evec[:, pos_col], changed, alive,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width,
                    bucket=bucket, skin=skin,
                )
                return res.rows, res.ok & obs_valid[:, None], cache
        else:
            def query(evec, ei32, changed, pvec, pi32, obs_rows, obs_valid):
                res = visible_candidates(
                    evec[:, pos_col], changed,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width, bucket=bucket,
                )
                return res.rows, res.ok & obs_valid[:, None]

        fn = self._book_entry(f"interest.query/{cname}", query)
        self._interest_fns[key] = fn
        return fn

    def _interest_cache_for(self, cname: str):
        """The class's interest Verlet cache, carried in WorldState.aux
        (key "verlet/interest/<class>") so telemetry and invalidate() treat
        it like any other grid cache.  Registers the aux init lazily on
        first use."""
        from ...ops.verlet import init_cache

        k = self.kernel
        key = f"verlet/interest/{cname}"
        if key not in k._aux_init:
            cap = k.store.capacity(cname)
            k.register_aux(key, lambda c=cap, d=k.device: init_cache(c, device=d))
        k._ensure_aux()
        return key, k.state.aux[key]

    def _interest_cache_store(self, key: str, cache) -> None:
        k = self.kernel
        k.state = k.state.replace(aux={**k.state.aux, key: cache})

    def _interest_ok(self, cname: str) -> bool:
        """The interest lane needs spatial columns; classes without them
        stay on the broadcast lane."""
        slots = self.kernel.store.spec(cname).slots
        return all(n in slots for n in ("Position", "SceneID", "GroupID"))

    def _observer_arrays(self):
        """(sessions with live avatars, padded row array, validity mask);
        computed once per flush (_obs_cache cleared in _flush_changes)."""
        cached = getattr(self, "_obs_cache", None)
        if cached is not None:
            return cached
        from ...core.datatypes import next_pow2

        k = self.kernel
        # nf-lint: disable=serve-loop -- the legacy engine's observer
        # collector (the parity oracle for NF_SERVE_BATCH); the batched
        # path reads the SessionTable columns
        obs = [
            s for s in self.sessions.values()
            if s.guid is not None and s.guid in k.store.guid_map
        ]
        if not obs:
            self._obs_cache = ([], None, None)
            return self._obs_cache
        rows = np.zeros(next_pow2(len(obs), lo=8), np.int64)
        for i, s in enumerate(obs):
            rows[i] = k.store.row_of(s.guid)[1]
        valid = np.zeros(rows.shape, bool)
        valid[: len(obs)] = True
        self._obs_cache = (obs, rows, valid)
        return self._obs_cache

    def _send_interest_pos(self, cname: str) -> None:
        """Per-session Position stream: ONE compact message per client
        carrying only the entities inside its interest radius, positions
        u16-quantized over the scene extent (scale rides the message).
        Replaces the group-broadcast lane for Position when
        `interest_radius` is set.

        Each session carries its OWN seen-state (sorted row array + guid +
        last-sent quantized position): an entity hits a session's wire
        when it enters that session's view (first sight or re-entry) or
        when its quantized position differs from what that session last
        received.  Leaving view drops the entity from the seen-state, so
        re-entry resends, and the guid is part of the match (no stale-row
        hazard when rows are recycled)."""
        from ...ops.interest import QMAX
        from ..wire import InterestPosSync

        k = self.kernel
        spec = k.store.spec(cname)
        if "Position" not in spec.slots:
            return
        obs, obs_rows, obs_valid = self._observer_arrays()
        if not obs:
            return

        cs = k.state.classes[cname]
        pcs = k.state.classes["Player"]
        fn = self._interest_step(cname, len(obs_rows))
        args = (cs.vec, cs.i32, cs.alive, pcs.vec, pcs.i32,
                self._to_dev(obs_rows), self._to_dev(obs_valid))
        if self._interest_skin > 0.0:
            ckey, cache = self._interest_cache_for(cname)
            q, rows, ok, cache = fn(*args, cache)
            self._interest_cache_store(ckey, cache)
        else:
            q, rows, ok = fn(*args)
        q_np = q.cpu().numpy().astype(np.uint16)
        rows_np, ok_np = rows.cpu().numpy(), ok.cpu().numpy()
        host = k.store._hosts[cname]
        scale = float(self.game_world.config.extent) / QMAX
        # nf-lint: disable=serve-loop -- the legacy per-session engine
        # itself (NF_SERVE_BATCH=0): the bit-identity oracle of the
        # batched engine
        for i, sess in enumerate(obs):
            vis = rows_np[i][ok_np[i]]
            vis = vis[host.alloc_mask[vis]]  # drop just-died rows
            seen = getattr(sess, "_interest_seen", None)
            if seen is None:
                seen = self.reset_view(sess)
            vis = np.sort(vis)
            heads = host.guid_head[vis]
            datas = host.guid_data[vis]
            qv = q_np[vis]  # [n, 3]
            prev = seen.get(cname)
            if prev is None:
                send = np.ones(vis.size, bool)
                gone_h = gone_d = np.empty(0, np.int64)
            else:
                p_rows, p_heads, p_datas, p_q = prev
                idx = np.searchsorted(p_rows, vis)
                idx_c = np.minimum(idx, max(len(p_rows) - 1, 0))
                same = (
                    (len(p_rows) > 0)
                    & (p_rows[idx_c] == vis)
                    & (p_heads[idx_c] == heads)
                    & (p_datas[idx_c] == datas)
                    & np.all(p_q[idx_c] == qv, axis=-1)
                )
                send = ~same
                # leave-view: previously-seen guids whose row is gone from
                # the visible set (or recycled to another guid) — the
                # delta stream needs an explicit despawn signal
                if vis.size:
                    j = np.searchsorted(vis, p_rows)
                    j_c = np.minimum(j, vis.size - 1)
                    still = (
                        (vis[j_c] == p_rows)
                        & (heads[j_c] == p_heads)
                        & (datas[j_c] == p_datas)
                    )
                else:
                    still = np.zeros(len(p_rows), bool)
                gone_h, gone_d = p_heads[~still], p_datas[~still]
            if vis.size == 0:
                seen.pop(cname, None)
            else:
                seen[cname] = (vis, heads, datas, qv)
            if not send.any() and gone_h.size == 0:
                continue
            msg = InterestPosSync(
                scale=scale,
                count=int(send.sum()),
                svrid=heads[send].tobytes(),
                index=datas[send].tobytes(),
                qpos=np.ascontiguousarray(qv[send]).tobytes(),
                gone_svrid=gone_h.tobytes(),
                gone_index=gone_d.tobytes(),
            )
            self._send_to_session(sess, MsgID.ACK_INTEREST_POS, msg)

    # ------------------------------------------------ batched serve edge
    # The NF_SERVE_BATCH engine.  Same wire bytes as the legacy loops
    # above, but the per-session set algebra runs as one batched dispatch
    # over the session axis (ops/serving.py) against the SessionTable's
    # seen-state, and the host's only per-session work is slicing
    # precomputed byte buffers into packets (net/serving.py).

    def _serve_geometry(self, cname: str):
        """(cell, width, bucket, m): grid geometry shared with the legacy
        queries — identical candidate sets are the parity precondition.
        `m` is the seen-table width: 9*bucket covers every candidate slot
        exactly; NF_SERVE_SLOTS can cap it (memory at huge session counts)
        at the cost of dropping the farthest-slot candidates of overfull
        views for a frame."""
        geom = getattr(self, "_serve_geom", None)
        if geom is None:
            geom = self._serve_geom = {}
        g = geom.get(cname)
        if g is not None:
            return g
        cell, width, bucket = self._interest_grid(cname)
        m = 9 * bucket
        cap_m = _env_int("NF_SERVE_SLOTS", 0)
        if cap_m > 0:
            m = min(m, cap_m)
        g = (cell, width, bucket, m)
        geom[cname] = g
        return g

    def _serve_refresh_table(self) -> None:
        """Harvest-stage SessionTable sync: one slot per session with a
        live avatar.  Slots of departed sessions free here (robust to
        every removal path), stale seen-state wipes on realloc."""
        st = self._session_table
        for key in list(st.slot_of):
            if key not in self.sessions:
                st.release(key)
        k = self.kernel
        for key, s in self.sessions.items():
            if s.guid is not None and s.guid in k.store.guid_map:
                st.ensure(key, s.conn_id, k.store.row_of(s.guid)[1])
            else:
                st.invalidate(key)

    def _serve_prepare(self, cname: str):
        """Per-class 'prepare' step: quantize + position-version bump +
        cell-table build, ONCE per frame regardless of session chunking
        (per-chunk bumping would multi-count a single move)."""
        key = ("sprep", cname)
        fn = self._serve_fns.get(key)
        if fn is not None:
            return fn
        from ...ops.interest import _interest_feats, quantize
        from ...ops.serving import bump_qver
        from ...ops.stencil import build_cell_table
        from ...ops.verlet import refresh, sub_table

        pos_col, sc_col, gr_col, _pp, _ps, _pg = self._interest_cols(cname)
        extent = float(self.game_world.config.extent)
        skin = float(self._interest_skin)
        cell, width, bucket, _m = self._serve_geometry(cname)
        f32 = torch.float32

        if skin > 0.0:
            def prep(evec, ei32, alive, qver, prev_q, cache):
                pos3 = evec[:, pos_col]
                q, in_extent = quantize(pos3, alive, extent)
                qver2, prev2 = bump_qver(q, prev_q, qver)
                cache, _rebuilt = refresh(cache, pos3, alive, cell, width, bucket, skin)
                feats = _interest_feats(pos3, ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32))
                table = sub_table(cache, in_extent & alive, feats, width * width,
                                  cell, width, bucket)
                return q, qver2, prev2, table.payload, cache
        else:
            def prep(evec, ei32, alive, qver, prev_q):
                pos3 = evec[:, pos_col]
                q, in_extent = quantize(pos3, alive, extent)
                qver2, prev2 = bump_qver(q, prev_q, qver)
                feats = _interest_feats(pos3, ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32))
                table = build_cell_table(pos3, in_extent, feats, cell, width, bucket)
                return q, qver2, prev2, table.payload

        fn = self._book_entry(f"serve.prepare/{cname}", prep)
        self._serve_fns[key] = fn
        return fn

    def _serve_scan(self, cname: str, s_chunk: int):
        """Per-(class, chunk) 'scan' step: 3x3 candidate read + the full
        delta set algebra for a contiguous block of session slots.  Only
        the payload crosses the prepare/scan seam — the grid geometry is
        static in both closures."""
        key = ("sscan", cname, s_chunk)
        fn = self._serve_fns.get(key)
        if fn is not None:
            return fn
        from ...ops.interest import _scan_observers
        from ...ops.serving import SeenTable, interest_delta, slot_compact
        from ...ops.stencil import CellTable

        _pc, _sc, _gc, p_pos, p_sc, p_gr = self._interest_cols(cname)
        radius = float(self.interest_radius)
        cell, width, bucket, m = self._serve_geometry(cname)
        k9 = 9 * bucket
        f32 = torch.float32

        def scan(payload, pvec, pi32, obs_rows, valid, alloc_ok, gen, qver,
                 seen_rows, seen_gen, seen_qver):
            table = CellTable(payload, None, None, width, cell, bucket)
            res = _scan_observers(
                table, pvec[obs_rows, p_pos][:, :2],
                pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                radius, cell,
            )
            # device-side alloc filter: the legacy loop's just-died-row
            # drop (host.alloc_mask), applied before the delta algebra
            ok = res.ok & valid[:, None] & alloc_ok[res.rows.long()]
            rows = res.rows
            if m < k9:  # NF_SERVE_SLOTS cap: keep slot-order prefix
                rows, counts = slot_compact(rows, ok)
                rows = rows[:, :m]
                ok = torch.arange(m, dtype=torch.int32, device=rows.device)[None, :] \
                    < counts[:, None]
            return interest_delta(rows, ok, gen, qver,
                                  SeenTable(seen_rows, seen_gen, seen_qver))

        fn = self._book_entry(f"serve.scan/{cname}", scan)
        self._serve_fns[key] = fn
        return fn

    def _serve_pos_collect(self, cname: str):
        """Device half of the batched Position lane: dispatch prepare +
        chunked scans and FETCH the dense delta buffers.  Returns the
        host-assembly payload, or None when there are no observers.  In
        overlap mode it runs before the tick dispatch, whose graph replay
        writes the state banks in place: everything it returns is a host
        copy, and the role-held version state (``_serve_qver``) and the
        seen-tables are tensors of their own, never views of a bank."""
        from ...ops.serving import SeenTable

        k = self.kernel
        st = self._session_table
        if st.capacity == 0 or not st.valid.any():
            return None
        host = k.store._hosts[cname]
        cs = k.state.classes[cname]
        pcs = k.state.classes["Player"]
        _cell, _width, _bucket, m = self._serve_geometry(cname)

        cap = k.store.capacity(cname)
        qp = self._serve_qver.get(cname)
        if qp is None or qp[0].shape[0] != cap:
            # prev_q = -1: every row's first observed quantum counts as
            # a change, so a fresh engine never suppresses a first send
            qp = (torch.zeros(cap, dtype=torch.int32, device=k.device),
                  torch.full((cap, 3), -1, dtype=torch.int32, device=k.device))
        qver, prev_q = qp

        prep = self._serve_prepare(cname)
        if self._interest_skin > 0.0:
            ckey, cache = self._interest_cache_for(cname)
            q, qver, prev_q, payload, cache = prep(cs.vec, cs.i32, cs.alive, qver, prev_q,
                                                   cache)
            self._interest_cache_store(ckey, cache)
        else:
            q, qver, prev_q, payload = prep(cs.vec, cs.i32, cs.alive, qver, prev_q)
        self._serve_qver[cname] = (qver, prev_q)

        gen = self._to_dev(host.row_gen)
        alloc_ok = self._to_dev(host.alloc_mask)
        obs_rows = self._to_dev(st.avatar_row.astype(np.int64))
        valid = self._to_dev(st.valid)
        seen = st.seen_for(cname, m)

        s_total = st.capacity
        chunk = _env_int("NF_SERVE_CHUNK", 0)
        if chunk <= 0 or chunk >= s_total:
            chunk = s_total
        parts, seens = [], []
        for c0 in range(0, s_total, chunk):
            c1 = c0 + chunk
            fn = self._serve_scan(cname, chunk)
            delta = fn(
                payload, pcs.vec, pcs.i32,
                obs_rows[c0:c1], valid[c0:c1], alloc_ok, gen, qver,
                seen.rows[c0:c1], seen.gen[c0:c1], seen.qver[c0:c1],
            )
            self._serve_dispatches.inc()
            parts.append(tuple(x.cpu().numpy() for x in
                               (delta.vis, delta.send, delta.gone, delta.gone_rows)))
            seens.append(delta.seen)
        seen = seens[0] if len(seens) == 1 else SeenTable(
            *(torch.cat(cols) for cols in zip(*seens)))
        st.store_seen(cname, seen)
        self._serve_sessions_hist.observe(int(st.valid.sum()))

        # gone lists carry guids AS LAST SERVED — freed rows have their
        # live guid zeroed, so gather from the previous run's mirrors
        prev_h, prev_d = self._serve_prev_guids.get(
            cname, (host.guid_head, host.guid_data)
        )
        self._serve_prev_guids[cname] = (
            host.guid_head.copy(), host.guid_data.copy()
        )
        cat = (lambda i: np.concatenate([p[i] for p in parts])
               if len(parts) > 1 else parts[0][i])
        return {
            "cname": cname,
            "q": q.cpu().numpy().astype(np.uint16),
            "vis": cat(0), "send": cat(1),
            "gone": cat(2), "gone_rows": cat(3),
            "prev_h": prev_h, "prev_d": prev_d,
        }

    def _serve_pos_emit(self, data) -> None:
        """Host half: batched frame assembly.  Flatten the [S, M] masks
        (row-major = session-major, per-session ascending because vis is
        sorted), gather ONCE from the host guid mirrors, materialize ONE
        payload per wire field, and slice per-session packets at cumsum
        byte offsets — zero per-session device syncs or numpy passes."""
        from ...ops.interest import QMAX
        from ..serving import segments
        from ..wire import InterestPosSync

        k = self.kernel
        st = self._session_table
        host = k.store._hosts[data["cname"]]
        q_np, vis, send = data["q"], data["vis"], data["send"]
        gone, gone_rows = data["gone"], data["gone_rows"]

        send_counts = send.sum(axis=1)
        gone_counts = gone.sum(axis=1)
        flat_rows = vis[send]
        heads_b = host.guid_head[flat_rows].tobytes()
        datas_b = host.guid_data[flat_rows].tobytes()
        qpos_b = np.ascontiguousarray(q_np[flat_rows]).tobytes()
        o8, _ = segments(send_counts, 8, heads_b)
        o6, _ = segments(send_counts, 6, qpos_b)
        flat_gone = gone_rows[gone]
        gh_b = data["prev_h"][flat_gone].tobytes()
        gd_b = data["prev_d"][flat_gone].tobytes()
        g8, _ = segments(gone_counts, 8, gh_b)

        scale = float(self.game_world.config.extent) / QMAX
        sent = 0
        for key, sess in self.sessions.items():
            slot = st.slot_of.get(key)
            if slot is None or not st.valid[slot]:
                continue
            ns, ng = int(send_counts[slot]), int(gone_counts[slot])
            if ns == 0 and ng == 0:
                continue
            msg = InterestPosSync(
                scale=scale,
                count=ns,
                svrid=heads_b[o8[slot]:o8[slot + 1]],
                index=datas_b[o8[slot]:o8[slot + 1]],
                qpos=qpos_b[o6[slot]:o6[slot + 1]],
                gone_svrid=gh_b[g8[slot]:g8[slot + 1]],
                gone_index=gd_b[g8[slot]:g8[slot + 1]],
            )
            self._send_to_session(sess, MsgID.ACK_INTEREST_POS, msg)
            sent += 1
        self._serve_packets.inc(sent)

    def _send_interest_pos_batched(self, cname: str) -> None:
        """Synchronous batched Position lane (NF_SERVE_BATCH without
        overlap): collect in the interest stage, assemble+send nested
        under 'assemble' so the waterfall attributes the host slicing."""
        data = self._serve_pos_collect(cname)
        if data is None:
            return
        with self.stage_clock.stage("assemble"):
            self._serve_pos_emit(data)

    def _serve_query(self, cname: str, s_pad: int):
        """Batched interest-scoped BatchPropertySync query: legacy
        `_interest_query` + device alloc filter + stable slot-order
        compaction (the lane's wire order is candidate slot order)."""
        key = ("bscan", cname, s_pad)
        fn = self._serve_fns.get(key)
        if fn is not None:
            return fn
        from ...ops.interest import visible_candidates, visible_candidates_cached
        from ...ops.serving import slot_compact

        pos_col, sc_col, gr_col, p_pos, p_sc, p_gr = self._interest_cols(cname)
        radius = float(self.interest_radius)
        skin = float(self._interest_skin)
        cell, width, bucket, _m = self._serve_geometry(cname)
        f32 = torch.float32

        if skin > 0.0:
            def query(evec, ei32, changed, alive, pvec, pi32, obs_rows, valid, alloc_ok,
                      cache):
                res, cache, _rebuilt = visible_candidates_cached(
                    cache, evec[:, pos_col], changed, alive,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width,
                    bucket=bucket, skin=skin,
                )
                ok = res.ok & valid[:, None] & alloc_ok[res.rows.long()]
                rows, counts = slot_compact(res.rows, ok)
                return rows, counts, cache
        else:
            def query(evec, ei32, changed, pvec, pi32, obs_rows, valid, alloc_ok):
                res = visible_candidates(
                    evec[:, pos_col], changed,
                    ei32[:, sc_col].to(f32), ei32[:, gr_col].to(f32),
                    pvec[obs_rows, p_pos][:, :2],
                    pi32[obs_rows, p_sc].to(f32), pi32[obs_rows, p_gr].to(f32),
                    radius=radius, cell_size=cell, width=width, bucket=bucket,
                )
                ok = res.ok & valid[:, None] & alloc_ok[res.rows.long()]
                rows, counts = slot_compact(res.rows, ok)
                return rows, counts

        fn = self._book_entry(f"serve.query/{cname}", query)
        self._serve_fns[key] = fn
        return fn
