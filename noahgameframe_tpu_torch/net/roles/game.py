"""Game role: the kernel-backed world server behind the proxy.

Reference: NFGameServerNet_ServerPlugin + NFGameServerNet_ClientPlugin —
accepts proxy connections and serves ~30 message handlers (enter/leave
game, role CRUD, swap scene, move, chat;
`NFCGameServerNet_ServerModule.cpp:31-73`), registers at World with 10 s
reports (`NFCGameServerToWorldModule.cpp:34-130`), and binds the
scene/AOI callbacks so property & record changes serialize into `NFMsg`
sync messages sent via the proxy with explicit client lists
(`OnPropertyEnter` `:271-400` and the §3.3 data-flow spine).

Device inversion: instead of per-write callbacks, the role pulls each
tick's flag-masked diff masks off the device (already reduced by the
tick) and fans the changed cells out as grouped property-sync messages to
every player in the broadcast set — one device fetch per bank per tick
instead of one callback per write.

Counterpart of ``noahgameframe_tpu/net/roles/game.py``, split by concern:
this file holds the constructor, the report and pipeline stats, the
handler table, the send and broadcast helpers, the frame (:meth:`GameRole.execute`),
rooms and elastic hooks, and checkpoint/kill/shut.  The mixins hold the
client handlers (``game_handlers``), the switch protocol (``game_switch``),
the property and record spine with the columnar lanes (``game_sync``) and
the interest and serve lanes (``game_interest``).

Deviations from the JAX package: ``GameRole(..., device=None)`` builds its
default world on ``"cuda"`` (``device="cpu"`` on request) and follows a
given world's device otherwise; the default world is JAX's
``WorldConfig(combat=False, movement=False, regen=True)``, with the
middleware stack the middleware handlers drive.  On a card the frame's
observed tick is a CUDA graph (``graph_tick=None``; ``Kernel.set_graph_tick``),
whose replay writes the state banks in place.  ``NF_STAGE_TIMING=1``
synchronizes the card after the tick dispatch.  The
``nf_train_*_total`` series are the world telemetry's callbacks over the
kernel's counts rather than counters of the role's own.
"""

from __future__ import annotations

import json as _json
import os
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.datatypes import Guid
from ...game.world import GameWorld, WorldConfig
from ...persist.codec import snapshot_object
from ...telemetry.pipeline import (
    StageClock,
    TraceContext,
    TraceError,
    decode_trace,
    encode_trace,
    stage_timing_enabled,
    trace_sample_n,
)
from ..defines import TRACE_MSG_IDS, MsgID, ServerState, ServerType
from ..wire import Ident, Message, MsgBase, RoleLiteInfo, ServerInfoExt, wrap
from .base import RoleConfig, ServerRole
from .game_handlers import GameHandlersMixin
from .game_interest import GameInterestMixin
from .game_session import ROW_TARGET_SVRID, Session, _env_int, _IdentKey, guid_ident
from .game_switch import GameSwitchMixin
from .game_sync import GameSyncMixin

__all__ = ["GameRole", "Session", "guid_ident", "ROW_TARGET_SVRID"]


class GameRole(GameHandlersMixin, GameSwitchMixin, GameSyncMixin, GameInterestMixin,
               ServerRole):
    server_type = int(ServerType.GAME)

    def __init__(
        self,
        config: RoleConfig,
        backend: str = "auto",
        world: Optional[GameWorld] = None,
        scene_id: int = 1,
        sync_classes: Sequence[str] = ("Player", "NPC"),
        skill_damage: int = 10,
        data_agent=None,
        role_store=None,
        autosave_seconds: float = 30.0,
        cross_server_sync: bool = True,
        batch_sync_min: int = 256,
        interest_radius: Optional[float] = None,
        serve_batch: Optional[bool] = None,
        serve_overlap: Optional[bool] = None,
        tick_train: Optional[int] = None,
        checkpoint_dir=None,
        checkpoint_seconds: float = 30.0,
        resume: bool = False,
        journal_dir=None,
        journal_segment_bytes: int = 1 << 20,
        persist_store=None,
        persist_wal_dir=None,
        persist_drain_timeout: float = 3.0,
        device=None,
        graph_tick: Optional[bool] = None,
    ) -> None:
        # (class, prop) diffs with >= batch_sync_min changed rows go out
        # as ONE columnar ACK_BATCH_PROPERTY message per (cell, conn)
        # instead of per-entity messages — the served-path fast lane
        self.batch_sync_min = batch_sync_min
        # with a radius, Position leaves on the per-session interest
        # stream instead (u16-quantized, delta-gated, device-filtered):
        # each client gets only entities within `interest_radius` of its
        # avatar — group-granular broadcast is full-world fan-out when a
        # group is busy
        self.interest_radius = interest_radius
        # Verlet skin for the interest grids (NF_VERLET_SKIN knob,
        # ops/verlet.py): > 0 inflates the interest cell size to
        # radius + skin and amortizes the per-flush argsort across
        # flushes via a displacement-gated cache carried in
        # WorldState.aux ("verlet/interest/<class>")
        from ...ops.verlet import skin_from_env

        self._interest_skin = (
            float(skin_from_env()) if interest_radius is not None else 0.0
        )
        self._interest_fns: Dict[Tuple[str, int], object] = {}
        # classes with a create/destroy since the last interest flush
        # (visible sets can change without any Position diff)
        self._interest_dirty: set = set()
        self._last_obs_sig: Optional[tuple] = None
        # --- batched serving edge -------------------------
        # NF_SERVE_BATCH=1 swaps the per-session Python serve loops for
        # one batched device dispatch over all sessions (ops/serving.py) plus
        # SoA host assembly (net/serving.py).  NF_SERVE_OVERLAP=1
        # (implies batch) additionally double-buffers the serve
        # snapshot: the interest Position lane is computed against the
        # PRE-tick state and its assembly/encode/send overlaps the
        # device tick — clients see those diffs exactly one tick later
        # (bounded staleness <= 1 tick, journaled in the run meta).
        def _env_flag(name: str, explicit: Optional[bool]) -> bool:
            if explicit is not None:
                return bool(explicit)
            return os.environ.get(name, "0") == "1"

        self.serve_overlap = (
            _env_flag("NF_SERVE_OVERLAP", serve_overlap)
            and interest_radius is not None
        )
        self.serve_batch = self.serve_overlap or (
            _env_flag("NF_SERVE_BATCH", serve_batch)
            and interest_radius is not None
        )
        # --- K-tick trains --------------------------------
        # NF_TICK_TRAIN=K (K >= 2) runs the device tick as one K-frame
        # graph dispatch per due frame: every host-consumed lane
        # comes back stacked [K, ...] (kernel.TRAIN_LANE_SPEC), fetched
        # once, and fanned out in tick order — journal digest marks,
        # death attribution and counters stay per-tick exact at 1/K the
        # dispatch+fetch cost.  Election: trains need K >= 2 and lose
        # to overlap mode (overlap serves each frame against the
        # pre-tick snapshot; inside a train there is no between-frame
        # host window), so NF_SERVE_OVERLAP=1 keeps K at 1.  The
        # resulting staleness contract (clients see a burst of K frames
        # per train, i.e. diffs up to K-1 ticks old) is journaled like
        # the overlap contract so replay honors the same engine.
        k_train = (int(tick_train) if tick_train is not None
                   else _env_int("NF_TICK_TRAIN", 0))
        self.tick_train = k_train if (k_train >= 2
                                      and not self.serve_overlap) else 0
        self._serve_fns: Dict[tuple, object] = {}
        # per-class device position-version state (role-held, NOT kernel
        # aux: kernel.invalidate() drops aux on recompile, but versions
        # must survive recompiles or every client would get a full
        # resend) — cname -> (qver [C] i32, prev_q [C,3] i32)
        self._serve_qver: Dict[str, tuple] = {}
        # host-side guid mirrors as of the LAST serve run: gone lists
        # name entities whose rows may already be freed (guid zeroed in
        # the live arrays), so the wire payload gathers from these
        self._serve_prev_guids: Dict[str, tuple] = {}
        # overlap mode: deferred Position-lane inputs from last frame
        self._serve_pending: Dict[str, object] = {}
        self.game_world = world if world is not None else GameWorld(
            WorldConfig(combat=False, movement=False, regen=True),
            device=device,
        ).start()
        self.kernel = self.game_world.kernel
        # the frame's observed tick as a CUDA graph (Kernel.set_graph_tick);
        # None = on a card.  A K-tick train is a graph either way
        self.kernel.set_graph_tick(
            self.kernel.device.type == "cuda" if graph_tick is None else graph_tick)
        from ..serving import SessionTable

        self._session_table = SessionTable(device=self.kernel.device)
        if self.tick_train:
            self.kernel.configure_train(self.tick_train)
        self.scene = self.game_world.scene
        self.scene_id = scene_id
        self.sync_classes = tuple(sync_classes)
        self.skill_damage = skill_damage
        if scene_id not in self.scene.scenes:
            self.scene.create_scene(scene_id)
        info = self.scene.scenes[scene_id]
        if 1 not in info.groups:
            self.scene.request_group(scene_id)
        # sessions by client ident; reverse map guid -> ident key
        self.sessions: Dict[_IdentKey, Session] = {}
        self._guid_session: Dict[Guid, _IdentKey] = {}
        # account -> role rows; backed by role_store when one is attached
        self.roles: Dict[str, List[RoleLiteInfo]] = {}
        self.role_store = role_store
        self.data_agent = data_agent
        self._last_tick = 0.0
        self.autosave_seconds = autosave_seconds
        self._last_autosave = 0.0
        # crash recovery: periodic atomic whole-world checkpoints
        # (persist/checkpoint.py) + resume-on-boot; re-registration with
        # world/master happens through the normal on-connect path
        from pathlib import Path as _Path

        self.checkpoint_dir = _Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_seconds = checkpoint_seconds
        self._last_checkpoint = 0.0
        # many-worlds room directory (parallel/rooms.py), attached via
        # attach_rooms(); None = this role serves its single GameWorld
        self.rooms = None
        # flight recorder (replay/journal.py): when a journal dir is
        # given, every dispatched net event + a per-tick on-device state
        # digest is logged so the run can be re-executed offline.  The
        # digest must be baked into the compiled tick, so flip it on
        # BEFORE anything can trigger the first compile.
        self.journal = None
        self._journal_dir = _Path(journal_dir) if journal_dir else None
        self._journal_segment_bytes = int(journal_segment_bytes)
        if self._journal_dir is not None:
            self.kernel.enable_digest()
        super().__init__(config, backend=backend)
        reg = self.telemetry.registry
        self._ckpt_counter = reg.counter(
            "nf_checkpoints_total", "atomic world checkpoints written"
        )
        self._reshard_resets = reg.counter(
            "nf_reshard_view_resets_total",
            "session views force-reset because a reshard moved their rows"
        )
        self._recover_counter = reg.counter(
            "nf_recoveries_total", "world restores from checkpoint (resume)"
        )
        if resume and self.checkpoint_dir is not None:
            if (self.checkpoint_dir / "meta.json").exists():
                # restores device banks + host identity; a torn pair
                # raises (load_world's array_tick guard) rather than
                # resuming a corrupt world
                self.game_world.load(self.checkpoint_dir)
                self._recover_counter.inc()
            # no checkpoint yet -> cold start
        # world-tick latency, separate from the pump's frame histogram
        # (a pump frame with no tick due is ~free; mixing them would
        # drown the tick percentiles in poll noise)
        self._tick_hist = self.telemetry.registry.histogram(
            "nf_game_tick_seconds", "world tick latency (kernel + modules)"
        )
        self.world_link = self.add_upstream(
            "world",
            [t for t in config.targets if t.server_type == int(ServerType.WORLD)],
            register_msg=MsgID.GTW_GAME_REGISTERED,
            refresh_msg=MsgID.STS_SERVER_REPORT,
        )
        # world relay: public Player state forwarded up; remote games' sync
        # delivered to local clients (cross-game visibility without the
        # reference's world-side object mirror — the batched messages relay
        # verbatim; NFCWorldNet_ServerModule.cpp:600-830)
        self.cross_server_sync = cross_server_sync
        if cross_server_sync:  # gate BOTH directions (isolated realms)
            from .world import CROSS_SYNC_MSGS

            for msg in CROSS_SYNC_MSGS:
                self.world_link.on(msg, self._on_world_sync)
        # PVP rooms minted by matchmaking, pending their ectype step
        self._pvp_rooms: Dict = {}
        # cross-game-server switch (NFCGSSwichServerModule): staged blobs
        # by player ident, world-link handlers for the re-home protocol
        self._switch_blobs: Dict = {}
        self.world_link.on(MsgID.SWITCH_SERVER_DATA, self._on_switch_data)
        self.world_link.on(MsgID.REQ_SWITCH_SERVER, self._on_switch_in)
        self.world_link.on(MsgID.ACK_SWITCH_SERVER, self._on_switch_ack)
        # a playable default stat table when the deployment didn't load one
        # (reference ships Property*.xlsx configs; LevelModule refreshes the
        # JOBLEVEL stat row from it on level-up)
        pc = self.game_world.property_config
        if not np.any(pc._base):
            pc.fill_linear(
                0,
                base={"MAXHP": 100, "MAXMP": 50, "MAXSP": 50, "HPREGEN": 1,
                      "ATK_VALUE": 10, "DEF_VALUE": 5, "MOVE_SPEED": 30000},
                per_level={"MAXHP": 20, "ATK_VALUE": 2, "DEF_VALUE": 1},
            )
            pc.freeze()
        if self.data_agent is not None:
            # bind BEFORE our own class-event hooks so load-on-create runs
            # inside the COE chain ahead of the enter-scene snapshot
            self.data_agent.bind(self.kernel)
        self.kernel.register_class_event(self._on_class_event, "Player")
        self.kernel.register_class_event(self._on_npc_event, "NPC")
        # subscribe every public OR private property of the synced classes;
        # the kernel fires these for host writes synchronously AND from the
        # device diff masks after each tick — one mechanism for the whole
        # spine.  Public changes broadcast to the (scene, group); private-
        # only changes go to the owner's client (GetBroadCastObject
        # semantics, NFCSceneAOIModule.cpp:531-593).
        self._changed: Dict[Tuple[str, str], np.ndarray] = {}
        for cname in self.sync_classes:
            spec = self.kernel.store.spec(cname)
            for slot in spec.slots.values():
                if slot.prop.public or slot.prop.private:
                    self.kernel.register_property_event(
                        cname, slot.prop.name, self._queue_change
                    )
        # record sync: host per-op hooks + device record diffs feed one
        # accumulator, flushed per frame (without it, bag/equip/buff
        # changes mid-session never reached clients;
        # reference NFCGameServerNet_ServerModule.cpp:75-81)
        # (cname, rname) -> {"add": set, "del": set, "upd": dict, "swap": list}
        self._rec_changed: Dict[Tuple[str, str], Dict[str, object]] = {}
        self.kernel.subscribe_record_host(self._on_record_host)
        self._synced_records: Dict[Tuple[str, str], bool] = {}  # -> public?
        for cname in self.sync_classes:
            spec = self.kernel.store.spec(cname)
            for rname, rs in spec.records.items():
                d = rs.rec
                if d.public or d.private or d.upload:
                    self._synced_records[(cname, rname)] = bool(d.public)
                    self.kernel.register_record_diff(
                        cname, rname, self._on_record_diff
                    )
        if self.interest_radius is not None:
            # creates/destroys change visible sets without a Position
            # diff — mark the class dirty so the gated interest flush runs
            def _mark_dirty(_g: Guid, cn: str, _ev) -> None:
                self._interest_dirty.add(cn)

            for cname in self.sync_classes:
                if self._interest_ok(cname):
                    self.kernel.register_class_event(_mark_dirty, cname)
        if self._journal_dir is not None:
            from ...ops.verlet import skin_from_env
            from ...replay.journal import (
                JournalWriter,
                SRC_SERVER,
                SRC_WORLD,
            )

            cfg = self.game_world.config
            # guid allocation is wall-clock seeded (epoch micros); wire
            # messages CARRY guids back into mutating handlers (e.g. the
            # switch ack destroys by guid), so an unpinned clock is a
            # hidden replay input.  Pin the allocator to a pure counter
            # from here on and journal the seed — replay pins the
            # offline role to the same point and every post-pin guid
            # comes out bit-identical
            guid_seed = self.kernel.store.guids.pin()
            self.journal = JournalWriter(
                self._journal_dir,
                segment_bytes=self._journal_segment_bytes,
                meta={
                    "server_id": config.server_id,
                    "name": config.name,
                    "world_seed": cfg.seed,
                    "dt": cfg.dt,
                    "start_tick": self.kernel.tick_count,
                    "resumed": bool(resume),
                    "verlet_skin": float(skin_from_env()),
                    "guid_seed": int(guid_seed),
                    # serving-edge staleness contract: with overlap on,
                    # the interest Position lane serves the PRE-tick
                    # snapshot (clients run <= 1 tick behind); replay
                    # must honor the same engine to stay digest-clean
                    "serve_batch": bool(self.serve_batch),
                    "serve_overlap": bool(self.serve_overlap),
                    # trains deliver diffs/events in a burst after each
                    # K-tick megadispatch: staleness <= K-1 ticks.  The
                    # per-tick marks are stamped from in-lane tick
                    # numbers, so replay (one real tick per mark) is
                    # bit-identical with the knob flipped either way.
                    "tick_train": int(self.tick_train),
                    "serve_staleness_ticks": (
                        self.tick_train - 1 if self.tick_train
                        else (1 if self.serve_overlap else 0)
                    ),
                },
            )
            # tap BOTH dispatch choke points: client/proxy traffic on the
            # listening server, world commands/switches on the world link
            # — together with the tick marks this is the complete
            # host→device input stream
            self.server.dispatch.tap = self._journal_tap(SRC_SERVER)
            self.world_link.dispatch.tap = self._journal_tap(SRC_WORLD)
            reg = self.telemetry.registry
            self._jrn_bytes = reg.counter(
                "nf_journal_bytes_total", "flight-recorder bytes appended"
            )
            self._jrn_segments = reg.counter(
                "nf_journal_segments_total", "flight-recorder segments opened"
            )
            self._jrn_ticks = reg.counter(
                "nf_journal_ticks_total", "ticks journaled with a digest"
            )
            self._jrn_sampled = [0, 0, 0]  # bytes, segments, ticks
            self._journal_pump_counters()
        # write-behind durability (persist/writebehind.py): per-tick
        # Save-flagged diffs stream to the store off-thread, staged in a
        # crash-safe WAL.  Built from kwargs (not passed in ready-made)
        # so LocalCluster.revive_role's kwargs replay reconstructs the
        # pipeline over the SAME wal dir and recovers queued batches.
        self.persist = None
        self._persist_drain_timeout = float(persist_drain_timeout)
        self._persist_dirty: set = set()
        self._persist_class = None
        self._save_props: set = set()
        self._save_records: set = set()
        if persist_store is not None and persist_wal_dir is not None:
            from ...persist.writebehind import WriteBehindPipeline

            self.persist = WriteBehindPipeline(
                persist_store, persist_wal_dir,
                registry=self.telemetry.registry,
                name=f"game{config.server_id}",
            )
            if self.data_agent is not None:
                self.data_agent.pipeline = self.persist
                self._persist_class = self.data_agent.class_name
                spec = self.kernel.store.spec(self._persist_class)
                for slot in spec.slots.values():
                    p = slot.prop
                    if not p.flag("save"):
                        continue
                    self._save_props.add(p.name)
                    # own subscriber: harvest is independent of which
                    # props the sync spine happens to watch
                    self.kernel.register_property_event(
                        self._persist_class, p.name, self._persist_prop_change
                    )
                    if not (p.public or p.upload):
                        # save-only columns aren't in diff_flags: opt
                        # them into device diff extraction or tick-path
                        # writes would never mark them dirty
                        self.kernel.force_diff_property(
                            self._persist_class, p.name
                        )
                for rname, rs in spec.records.items():
                    if rs.rec.flag("save"):
                        self._save_records.add(rname)
                        self.kernel.register_record_diff(
                            self._persist_class, rname,
                            self._persist_rec_diff,
                        )
                self.kernel.subscribe_record_host(self._persist_rec_host)
        # frame observatory: per-frame exclusive stage clock
        # over the served path (tick → harvest → interest → encode →
        # send) + sampled wire trace state.  NF_STAGE_TIMING=1 flips the
        # kernel into honest per-stage device timing; NF_TRACE_SAMPLE=N
        # traces 1-in-N sessions (0 disables).
        self.stage_clock = StageClock(self.telemetry.registry)
        # serving-edge metrics (docs/OBSERVABILITY.md): dispatch count,
        # sessions covered per dispatch, emitted packets, deferred-lane
        # frames (overlap) — the assemble stage histogram itself comes
        # from StageClock ("nf_stage_assemble_seconds")
        sreg = self.telemetry.registry
        self._serve_dispatches = sreg.counter(
            "nf_serve_dispatches_total",
            "batched serve-kernel dispatches (per class, per chunk)",
        )
        self._serve_packets = sreg.counter(
            "nf_serve_packets_total",
            "per-session packets emitted by the batched serve edge",
        )
        self._serve_deferred = sreg.counter(
            "nf_serve_deferred_frames_total",
            "frames whose interest lane was served one tick late (overlap)",
        )
        self._serve_sessions_hist = sreg.histogram(
            "nf_serve_sessions",
            "sessions covered by one batched serve dispatch",
        )
        # K-tick train accounting: nf_train_{dispatches,ticks,fetch_bytes}_total
        # are the world telemetry's callbacks over kernel.train_* (the JAX
        # role counts the same totals into counters of its own)
        self._stage_timing = stage_timing_enabled()
        self.kernel.stage_timing = self._stage_timing
        self._trace_sample = trace_sample_n()
        self._trace_seq = 0
        self._trace_pending: Dict[int, Tuple[int, int]] = {}
        self.trace_sent = 0
        self.trace_acked = 0
        self.last_trace: Optional[dict] = None
        treg = self.telemetry.registry
        self._trace_rtt_hist = treg.histogram(
            "nf_trace_rtt_seconds",
            "frame-trace round trip: encode → client ack received",
        )
        self._trace_relay_hist = treg.histogram(
            "nf_trace_proxy_relay_seconds",
            "proxy in→out relay of sampled frame traces (proxy clock)",
        )

    def _persist_prop_change(self, cname: str, pname: str, rows) -> None:
        self._persist_dirty.update(int(r) for r in rows)

    def _persist_rec_diff(self, cname: str, rname: str, codes) -> None:
        self._persist_dirty.update(int(e) for e in np.nonzero(
            np.any(codes != 0, axis=1))[0])

    def _persist_rec_host(self, cname, rname, op, erows, rec_row, tags) -> None:
        if cname == self._persist_class and rname in self._save_records:
            self._persist_dirty.update(int(e) for e in erows)

    def _persist_harvest(self) -> None:
        """Stage this tick's dirty Save-flagged entities into the
        write-behind queue as one coalesced batch.  Pump-thread only;
        never touches the store (the flusher owns every store call)."""
        tick = self.kernel.tick_count
        rows, self._persist_dirty = self._persist_dirty, set()
        if rows:
            agent = self.data_agent
            host = self.kernel.store._hosts[self._persist_class]
            k = self.kernel
            items = {}
            for r in sorted(rows):
                g = host.row_guid[r] if r < len(host.row_guid) else None
                if g is None:
                    continue  # died this tick; the destroy hook saved it
                key = agent._key_of(g)
                if key is None:
                    continue
                items[key] = snapshot_object(k.store, k.state, g, agent.flags)
            if items:
                self.persist.enqueue(tick, items)
        self.persist.note_tick(tick)
        self.persist.pump()

    def _journal_tap(self, source: int):
        def tap(ev) -> None:
            j = self.journal
            # frame-trace sidecars (TRACE_MSG_IDS) are pure observability
            # and never touch device state: journaling them would make
            # the recorded input stream — and thus replay byte-identity —
            # depend on whether tracing was sampled that run
            if j is not None and ev.msg_id not in TRACE_MSG_IDS:
                j.event(source, ev.kind, ev.conn_id, ev.msg_id, ev.body)
        return tap

    def _journal_pump_counters(self) -> None:
        """Fold the writer's monotonic totals into the registry as
        deltas (counters only go up; the writer is the source of
        truth)."""
        j = self.journal
        vals = (j.bytes_total, j.segments_total, j.ticks_total)
        for counter, new, i in zip(
            (self._jrn_bytes, self._jrn_segments, self._jrn_ticks),
            vals, range(3),
        ):
            d = new - self._jrn_sampled[i]
            if d:
                counter.inc(d)
                self._jrn_sampled[i] = new

    def journal_note(self, **info) -> None:
        """Drop an epoch marker into the journal (chaos seed + link
        budgets, config flips) — no-op when not recording."""
        if self.journal is not None:
            self.journal.note(info)

    def report(self):
        """Heartbeat report, extended with write-behind health: lag +
        degraded ride the ext map to the master's /json and status page
        (the SUSPECT-surfacing leg of the durability story), and a
        degraded store flips the advertised state to BUSY so balancers
        steer new logins elsewhere while the world stays up."""
        if self.persist is not None and self.state in (
                int(ServerState.NORMAL), int(ServerState.BUSY)):
            self.state = (int(ServerState.BUSY) if self.persist.degraded()
                          else int(ServerState.NORMAL))
        r = super().report()
        ext = r.server_info_list_ext
        if ext is None:
            ext = ServerInfoExt()
            r.server_info_list_ext = ext
        if self.persist is not None:
            for k, v in (
                ("persist_lag_ticks", self.persist.lag_ticks()),
                ("persist_queue_depth", self.persist.queue_depth()),
                ("persist_degraded", int(self.persist.degraded())),
                # durable-media locations for the world's failover
                # supervisor: when THIS role dies, the world
                # reconstructs its players' blobs read-only from here
                ("wal_dir", str(self.persist.wal.path)),
            ):
                ext.key.append(k.encode())
                ext.value.append(str(v).encode())
        if self.checkpoint_dir is not None:
            ext.key.append(b"ckpt_dir")
            ext.value.append(str(self.checkpoint_dir).encode())
        # frame-pipeline attribution blob: the master's /pipeline route
        # parses this into the cluster-wide stage waterfall
        ext.key.append(b"pipeline")
        ext.value.append(_json.dumps(self.pipeline_stats()).encode())
        # compiled-cost heartbeat: compact CostBook summary (per-entry
        # compiles/recompiles/flops/bytes + HBM live/peak) — the master's
        # /costbook route aggregates these into the cluster view
        ext.key.append(b"costbook")
        ext.value.append(
            _json.dumps(self.kernel.costbook.summary()).encode())
        # many-worlds occupancy blob: slot totals + per-room placement,
        # surfaced on the master's /json like pipeline/costbook
        if self.rooms is not None:
            ext.key.append(b"rooms")
            ext.value.append(_json.dumps(self.rooms.status()).encode())
        return r

    def pipeline_stats(self) -> dict:
        """Stage waterfall + wire-trace summary for /pipeline and bench."""
        sc = self.stage_clock
        out = {
            "frames": sc.frames,
            "last_tick": sc.last_tick,
            "last_wall_ms": round(sc.last_wall_ns / 1e6, 4),
            "last_ms": {k: round(v / 1e6, 4) for k, v in sc.last.items()},
            "stages": sc.stats(),
            "trace": {
                "sample": self._trace_sample,
                "sent": self.trace_sent,
                "acked": self.trace_acked,
                "pending": len(self._trace_pending),
            },
        }
        if self._trace_rtt_hist.count:
            out["trace"]["rtt_p50_ms"] = round(
                self._trace_rtt_hist.percentile(50.0) * 1e3, 4)
            out["trace"]["rtt_p95_ms"] = round(
                self._trace_rtt_hist.percentile(95.0) * 1e3, 4)
        if self._trace_relay_hist.count:
            out["trace"]["relay_p50_ms"] = round(
                self._trace_relay_hist.percentile(50.0) * 1e3, 4)
        return out

    def _install(self) -> None:
        s = self.server
        s.on(MsgID.REQ_ROLE_LIST, self._on_role_list)
        s.on(MsgID.REQ_CREATE_ROLE, self._on_create_role)
        s.on(MsgID.REQ_DELETE_ROLE, self._on_delete_role)
        s.on(MsgID.REQ_ENTER_GAME, self._on_enter_game)
        s.on(MsgID.REQ_LEAVE_GAME, self._on_leave_game)
        s.on(MsgID.REQ_SWAP_SCENE, self._on_swap_scene)
        s.on(MsgID.REQ_MOVE, self._on_move)
        s.on(MsgID.REQ_CHAT, self._on_chat)
        s.on(MsgID.REQ_SKILL_OBJECTX, self._on_skill)
        s.on(MsgID.REQ_SET_FIGHT_HERO, self._on_set_fight_hero)
        s.on(MsgID.REQ_SWITCH_SERVER, self._on_client_switch)
        s.on(MsgID.REQ_ITEM_OBJECT, self._on_use_item)
        s.on(MsgID.WEAR_EQUIP, self._on_wear_equip)
        s.on(MsgID.TAKEOFF_EQUIP, self._on_takeoff_equip)
        s.on(MsgID.REQ_ACCEPT_TASK, self._on_accept_task)
        s.on(MsgID.REQ_COMPLETE_TASK, self._on_complete_task)
        s.on(MsgID.REQ_CREATE_TEAM, self._on_create_team)
        s.on(MsgID.REQ_JOIN_TEAM, self._on_join_team)
        s.on(MsgID.REQ_LEAVE_TEAM, self._on_leave_team)
        s.on(MsgID.REQ_OPRMEMBER_TEAM, self._on_opr_team_member)
        s.on(MsgID.REQ_CREATE_GUILD, self._on_create_guild)
        s.on(MsgID.REQ_JOIN_GUILD, self._on_join_guild)
        s.on(MsgID.REQ_LEAVE_GUILD, self._on_leave_guild)
        s.on(MsgID.REQ_SEARCH_GUILD, self._on_search_guild)
        s.on(MsgID.REQ_CMD_NORMAL, self._on_gm_command)
        s.on(MsgID.REQ_PVP_APPLY_MATCH, self._on_pvp_apply)
        s.on(MsgID.REQ_CREATE_PVP_ECTYPE, self._on_pvp_create_ectype)
        s.on(MsgID.REQ_BUY_FORM_SHOP, self._on_slg_buy)
        s.on(MsgID.REQ_MOVE_BUILD_OBJECT, self._on_slg_move)
        s.on(MsgID.REQ_UP_BUILD_LVL, self._on_slg_upgrade)
        s.on(MsgID.REQ_CREATE_ITEM, self._on_slg_create_item)
        s.on(MsgID.REQ_BUILD_OPERATE, self._on_slg_operate)
        s.on(MsgID.FRAME_TRACE_ACK, self._on_frame_trace_ack)
        s.on_socket_event(self._on_socket)

    def cur_count(self) -> int:
        return len(self.sessions)

    # ------------------------------------------------------------ sending
    def _send_to(self, idents: Sequence[Ident], conn_id: int, msg_id: int,
                 msg: Message) -> None:
        # "send" stage = envelope encode + transport write; add_ns keeps
        # it exclusive of whichever stage (interest/encode) called us
        t0 = _time.perf_counter_ns()
        self.server.send_raw(
            conn_id, int(msg_id), wrap(msg, clients=list(idents))
        )
        self.stage_clock.add_ns("send", _time.perf_counter_ns() - t0)

    # ------------------------------------------------------ wire tracing
    def _emit_frame_traces(self) -> None:
        """End of a flushed frame: send the sampled sessions a FRAME_TRACE
        sidecar.  TCP ordering puts it *behind* the frame's sync traffic
        on the same connection, so the acked round trip upper-bounds the
        frame's true delivery latency."""
        n = self._trace_sample
        for sess in self.sessions.values():
            if sess.ident.index % n:
                continue
            self._trace_seq = (self._trace_seq + 1) & 0xFFFFFFFF
            seq = self._trace_seq
            t_enc = _time.perf_counter_ns()
            ctx = TraceContext(tick=self.kernel.tick_count,
                               game_id=self.config.server_id,
                               seq=seq, t_encode_ns=t_enc)
            self._trace_pending[seq] = (self.kernel.tick_count, t_enc)
            while len(self._trace_pending) > 4096:  # lost acks: drop oldest
                self._trace_pending.pop(next(iter(self._trace_pending)))
            base = MsgBase(player_id=sess.ident,
                           msg_data=encode_trace(ctx),
                           player_client_list=[sess.ident])
            self.server.send_raw(
                sess.conn_id, int(MsgID.FRAME_TRACE), base.encode()
            )
            self.trace_sent += 1

    def _on_frame_trace_ack(self, _conn_id: int, _msg_id: int,
                            body: bytes) -> None:
        """Client echoed the stamped header back: close the loop with
        same-clock deltas only — RTT on the game clock, relay on the
        proxy clock.  Never touches device state (replay identity)."""
        now_ns = _time.perf_counter_ns()
        base = MsgBase.decode(body)
        try:
            ctx = decode_trace(base.msg_data)
        except TraceError:
            return
        if ctx.game_id != self.config.server_id:
            return
        pend = self._trace_pending.pop(ctx.seq, None)
        if pend is None:
            return  # duplicate or aged out
        tick, t_enc = pend
        rtt_s = (now_ns - t_enc) / 1e9
        self._trace_rtt_hist.observe(rtt_s)
        relay_ms = None
        if ctx.proxy_out_ns and ctx.proxy_in_ns:
            relay_s = (ctx.proxy_out_ns - ctx.proxy_in_ns) / 1e9
            self._trace_relay_hist.observe(relay_s)
            relay_ms = round(relay_s * 1e3, 4)
        self.trace_acked += 1
        self.last_trace = {
            "tick": tick,
            "seq": ctx.seq,
            "rtt_ms": round(rtt_s * 1e3, 4),
            "proxy_relay_ms": relay_ms,
        }

    def _send_to_session(self, sess: Session, msg_id: int, msg: Message) -> None:
        self._send_to([sess.ident], sess.conn_id, msg_id, msg)

    def _broadcast(self, target_guids: Sequence[Guid], msg_id: int,
                   msg: Message, exclude: Optional[Guid] = None) -> None:
        """Fan a message out to the sessions of `target_guids`, grouping
        client idents per proxy connection (one envelope per proxy link —
        the multicast list the reference's Transpond expands)."""
        per_conn: Dict[int, List[Ident]] = {}
        for g in target_guids:
            if exclude is not None and g == exclude:
                continue
            key = self._guid_session.get(g)
            if key is None:
                continue
            sess = self.sessions.get(key)
            if sess is not None:
                per_conn.setdefault(sess.conn_id, []).append(sess.ident)
        for conn_id, idents in per_conn.items():
            self._send_to(idents, conn_id, msg_id, msg)

    def _scene_players(self, guid: Guid) -> List[Guid]:
        return self.scene.broadcast_targets(guid, public=True)


    # ------------------------------------------------------------ tick + sync
    def execute(self, now: Optional[float] = None) -> None:
        now = _time.monotonic() if now is None else now
        super().execute(now)
        pm = self.game_world.pm
        sc = self.stage_clock
        tick_due = now - self._last_tick >= self.game_world.config.dt
        # one stage-clock frame spans tick + flush of this pump pass; a
        # flush can also fire alone (host writes between ticks)
        framed = tick_due or bool(self._changed or self._rec_changed
                                  or self._interest_dirty
                                  or self._serve_pending)
        if framed:
            sc.frame_begin(self.kernel.tick_count)
        flushed = False
        # overlap mode: interest lanes deferred by the last flush, to be
        # served against THIS frame's pre-tick snapshot (sync_classes
        # order, same as a flush)
        pend_classes: List[str] = []
        if self._serve_pending:
            pend_classes = [
                cn for cn in self.sync_classes if cn in self._serve_pending
            ]
            self._serve_pending.clear()
        train_outs = None
        if tick_due:
            self._last_tick = now
            ticks_this_frame = self.tick_train or 1
            with self.telemetry.tracer.span("game.tick"), sc.stage("tick"):
                t0 = _time.perf_counter()
                for m in pm.modules.values():
                    if m is not self.kernel:
                        m.execute()
                self.kernel.execute()
                if pend_classes:
                    # double-buffered serve: fetch the deferred lanes'
                    # deltas to the host from the pre-tick state (the graph
                    # tick writes the banks in place), start the device
                    # tick, and do all
                    # host assembly/encode/send while the device runs
                    with sc.stage("interest"):
                        pend = [
                            d for d in (
                                self._serve_pos_collect(cn)
                                for cn in pend_classes
                            ) if d is not None
                        ]
                    raw = self.kernel.tick_begin()
                    self._serve_deferred.inc()
                    with sc.stage("assemble"):
                        for d in pend:
                            self._serve_pos_emit(d)
                    self.kernel.tick_finish(raw)
                elif self.tick_train:
                    # one K-frame megadispatch; per-frame host effects
                    # (events, diffs, tick-exact deaths, counters) fan
                    # out in order from the stacked lanes
                    train_outs = self.kernel.train(self.tick_train)
                else:
                    self.kernel.tick()
                pm.frame += ticks_this_frame
                # per-tick latency even under trains: one train frame is
                # K ticks of device work behind one dispatch
                self._tick_hist.observe(
                    (_time.perf_counter() - t0) / ticks_this_frame)
            if ticks_this_frame > 1:
                # nf_stage_tick_seconds stays a per-tick distribution
                # across NF_TICK_TRAIN settings (waterfall stays exact)
                sc.set_scale("tick", ticks_this_frame)
            if self.elastic is not None:
                # advance any in-flight grow/drain; when one completes,
                # force-reset exactly the sessions whose seen-state
                # intersects the rows the reshard actually moved
                with sc.stage("reshard"):
                    moved = self.elastic.poll()
                if moved:
                    self._reset_views_for_moved(moved)
            if self.journal is not None:
                # closes this tick's input window; the digest rode the
                # summary fetch the tick already paid for.  A train
                # writes one mark PER stacked frame from the in-lane
                # tick/digest stamps — replay runs one real tick per
                # mark and must compare like for like.
                if train_outs is not None:
                    for o in train_outs:
                        self.journal.tick_mark(
                            o.counters.get("tick", self.kernel.tick_count),
                            o.counters.get("state_digest", 0),
                        )
                else:
                    self.journal.tick_mark(
                        self.kernel.tick_count,
                        self.kernel.last_counters.get("state_digest", 0),
                    )
                self._journal_pump_counters()
            if self.persist is not None:
                # stage this tick's dirty set; all store I/O stays on
                # the flusher thread (the smoke asserts the tick never
                # blocks even with injected store latency)
                self._persist_harvest()
        elif pend_classes:
            # ticks stopped (idle pump): drain the deferred lanes
            # synchronously so staleness stays bounded by pump latency
            with self.telemetry.tracer.span("game.flush"):
                with sc.stage("interest"):
                    for cn in pend_classes:
                        self._send_interest_pos_batched(cn)
                flushed = True
        # _interest_dirty alone must also trigger a flush: a destroy with
        # no property diff still changes visible sets (gone lists)
        if self._changed or self._rec_changed or self._interest_dirty:
            with self.telemetry.tracer.span("game.flush"):
                if self.sessions:
                    self._flush_changes()
                    flushed = True
                else:
                    self._changed.clear()
                    self._rec_changed.clear()
                    self._interest_dirty.clear()
        if framed:
            sc.frame_end()
            if flushed and self._trace_sample > 0:
                self._emit_frame_traces()
        if tick_due:
            # periodic HBM census: live/peak device bytes sampled in-band
            # (scrape-time sampling alone misses peaks between scrapes)
            from ...telemetry.costbook import HBM_SAMPLE_FRAMES

            if self.kernel.tick_count % HBM_SAMPLE_FRAMES == 0:
                self.kernel.costbook.hbm_sample()
        # periodic autosave: device-side deaths free the row before any
        # BEFORE_DESTROY hook can run, so the blob must already be fresh
        if (self.data_agent is not None
                and now - self._last_autosave >= self.autosave_seconds):
            self._last_autosave = now
            for sess in self.sessions.values():
                if sess.guid is not None and sess.guid in self.kernel.store.guid_map:
                    self.data_agent.save(sess.guid)
        # periodic whole-world checkpoint (atomic rename; see
        # persist/checkpoint.py) — the resume path in __init__ restores
        # the latest one after a crash
        if (self.checkpoint_dir is not None
                and now - self._last_checkpoint >= self.checkpoint_seconds):
            self._last_checkpoint = now
            self.checkpoint_now()

    # ------------------------------------------------------- elastic mesh
    @property
    def elastic(self):
        """The world's grow/drain controller (parallel/elastic.py), or None
        for a single-device world.  Read through the world each time so
        a revive that swaps the world swaps the controller with it."""
        return getattr(self.game_world, "elastic", None)

    def grow_mesh(self, n_devices: int) -> None:
        """Expand the serving mesh; the reshard and spatial rebalance
        run inside subsequent ticks' ``reshard`` stage."""
        el = self.elastic
        if el is None:
            raise RuntimeError(f"{self.config.name}: world is not sharded")
        el.begin_grow(int(n_devices))

    def drain_device(self, device_index: int) -> None:
        """Evict one mesh device via the budgeted row exodus, then
        shrink — driven tick-by-tick from the ``reshard`` stage."""
        el = self.elastic
        if el is None:
            raise RuntimeError(f"{self.config.name}: world is not sharded")
        el.begin_drain(int(device_index))

    # ------------------------------------------------------- many worlds
    def attach_rooms(self, directory) -> None:
        """Host a many-worlds RoomDirectory (parallel/rooms.py) beside
        the single world: room status rides the heartbeat ext and the
        room churn verbs below become drill-addressable."""
        self.rooms = directory

    def _rooms_or_raise(self):
        if self.rooms is None:
            raise RuntimeError(
                f"{self.config.name}: no RoomDirectory attached")
        return self.rooms

    def create_room(self, seed: Optional[int] = None,
                    room_id: Optional[int] = None,
                    control: bool = False) -> int:
        return self._rooms_or_raise().create_room(
            seed=seed, room_id=room_id, control=control)

    def destroy_room(self, room_id: int) -> int:
        """Free the room's slot and release every session routed to it
        (same reset discipline as a completed reshard: the seen-state
        wipe is lazy, the routing column clears now)."""
        d = self._rooms_or_raise()
        slot = d.destroy_room(room_id)
        table = self._session_table
        if table is not None:
            for key in table.sessions_in_room(room_id):
                table.release(key)
        return slot

    def rehome_room(self, room_id: int):
        """Move a room to another slot/device; sessions keep their
        routing (the room id is stable — only its slot changed), but
        their views reset so the next serve pass resends from the
        re-homed state."""
        d = self._rooms_or_raise()
        src_dst = d.rehome_room(room_id)
        table = self._session_table
        if table is not None:
            for key in table.sessions_in_room(room_id):
                table.reset_view(key)
        return src_dst

    def _reset_views_for_moved(self, moved: Dict[str, np.ndarray]) -> None:
        """Force reset_view for sessions whose seen-state references rows
        a completed reshard moved — and ONLY those.  The batched engine
        intersects per-slot SeenTable rows exactly; the legacy engine's
        per-session seen dicts carry no row index, so it conservatively
        resets every session with a non-empty mirror."""
        from ..serving import sessions_seeing_rows

        affected = set()
        for cname, rows in moved.items():
            if len(rows) == 0:
                continue
            if self.serve_batch:
                affected.update(
                    sessions_seeing_rows(self._session_table, cname, rows))
            else:
                affected.update(
                    k for k, s in self.sessions.items()
                    if getattr(s, "_interest_seen", None))
        count = 0
        for key in affected:
            sess = self.sessions.get(key)
            if sess is not None:
                self.reset_view(sess)
                count += 1
        if count:
            self._reshard_resets.inc(count)

    def checkpoint_now(self):
        """Write one atomic whole-world checkpoint; returns its path."""
        self.game_world.save(self.checkpoint_dir)
        self._ckpt_counter.inc()
        if self.journal is not None:
            # durability point: fsync the journal at the checkpoint mark
            # so the (checkpoint, journal-suffix) pair on disk is always
            # a recoverable replay basis
            self.journal.checkpoint_mark(self.kernel.tick_count)
            self._journal_pump_counters()
        if self.persist is not None:
            # same durability point for the write-behind WAL: after this
            # fsync the newest (checkpoint, WAL suffix) pair on disk is
            # mutually recoverable
            self.persist.barrier(self.kernel.tick_count)
        return self.checkpoint_dir

    def kill(self) -> None:
        """Crash semantics (failover drills): tear the sockets
        down WITHOUT the graceful drain — no session saves, no persist
        flush, the WAL keeps whatever reached it.  This is the in-process
        stand-in for kill -9; :meth:`shut` is the orderly exit."""
        ServerRole.shut(self)
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if self.persist is not None:
            self.persist.kill()
            if self.data_agent is not None:
                self.data_agent.pipeline = None
            self.persist = None

    def shut(self) -> None:
        # pending-save drain: stage every live session player BEFORE the
        # sockets come down, then give the flusher a bounded window to
        # empty the queue — anything still unflushed (store down) stays
        # durable in the WAL for the next pipeline over this directory
        if self.persist is not None and self.data_agent is not None:
            for sess in self.sessions.values():
                if (sess.guid is not None
                        and sess.guid in self.kernel.store.guid_map):
                    self.data_agent.save(sess.guid)
        super().shut()
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if self.persist is not None:
            self.persist.drain(self._persist_drain_timeout)
            self.persist.close()
            if self.data_agent is not None:
                self.data_agent.pipeline = None
            self.persist = None

