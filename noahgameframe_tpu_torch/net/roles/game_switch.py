"""The game role's cross-server switch protocol: the player's save-flag
snapshot rides a ``SWITCH_SERVER_DATA`` companion message (CRC-framed,
persist/rowblob.py), the target game creates the avatar, applies the blob,
enters the scene and acknowledges; the source drops its copy.

Counterpart of ``noahgameframe_tpu/net/roles/game.py:1591-1790``
(reference NFCGSSwichServerModule.cpp).
"""

from __future__ import annotations

import time as _time

from ..defines import MsgID
from ..wire import (
    ReqSwitchServer,
    AckSwitchServer,
    SwitchServerData,
    ident_key as _ident_key,
    unwrap,
    wrap,
)
from ...core.datatypes import Guid
from ...persist.codec import snapshot_object
from .game_session import Session, guid_ident


class GameSwitchMixin:
    # ---------------------------------------------- cross-server switch
    # Reference NFCGSSwichServerModule.cpp: game A serializes nothing and
    # relies on a shared DB; here the player's save-flag snapshot rides a
    # SWITCH_SERVER_DATA companion message, so the re-home works without
    # one.  Flow: A.switch_server -> world -> B (_on_switch_in: create,
    # apply blob, enter scene, tell the proxy to re-route, ack) ->
    # world -> A (_on_switch_ack: drop session, destroy local copy).
    def switch_server(self, guid: Guid, target_server_id: int,
                      scene_id: int = 1, group: int = 0) -> bool:
        """ChangeServer (NFCGSSwichServerModule.cpp:49-77)."""
        from ...persist.codec import snapshot_object
        from ...persist.rowblob import frame_blob

        key = self._guid_session.get(guid)
        sess = self.sessions.get(key) if key is not None else None
        if sess is None or target_server_id == self.config.server_id:
            return False
        k = self.kernel
        # CRC-framed (persist/rowblob.py) so the target detects a blob
        # torn in transit before the codec ever parses it — the same
        # row-serialization story the on-mesh migration shares
        blob = frame_blob(snapshot_object(k.store, k.state, guid))
        ident = guid_ident(guid)
        data = SwitchServerData(
            selfid=ident,
            account=(sess.account or "").encode(),
            name=str(k.get_property(guid, "Name")).encode(),
            blob=blob,
            target_serverid=target_server_id,
        )
        req = ReqSwitchServer(
            selfid=ident,
            self_serverid=self.config.server_id,
            target_serverid=target_server_id,
            gate_serverid=0,  # proxy routing is by client ident here
            scene_id=scene_id,
            client_id=sess.ident,
            group_id=group,
        )
        # both messages MUST ride the same world link (suit-hash by the
        # player) — DATA arriving after REQ on a different link would
        # fail the switch silently
        suit = str(guid)
        self.world_link.send_by_suit(suit, int(MsgID.SWITCH_SERVER_DATA),
                                     wrap(data))
        self.world_link.send_by_suit(suit, int(MsgID.REQ_SWITCH_SERVER),
                                     wrap(req))
        return True

    def _on_client_switch(self, conn_id: int, _msg_id: int,
                          body: bytes) -> None:
        """Client-initiated switch (OnClientReqSwichServer)."""
        base, req = unwrap(body, ReqSwitchServer)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return
        self.switch_server(sess.guid, int(req.target_serverid),
                           int(req.scene_id), int(req.group_id))

    SWITCH_BLOB_TTL_S = 30.0

    def _on_switch_data(self, _sid: int, _msg_id: int, body: bytes) -> None:
        _, data = unwrap(body, SwitchServerData)
        if int(data.target_serverid) != self.config.server_id:
            return
        # sweep expired staged blobs (a world crash between DATA and REQ
        # must not leak entries forever)
        now = _time.monotonic()
        self._switch_blobs = {
            k: (d, t) for k, (d, t) in self._switch_blobs.items()
            if now - t < self.SWITCH_BLOB_TTL_S
        }
        self._switch_blobs[_ident_key(data.selfid)] = (data, now)

    def _on_switch_in(self, _sid: int, _msg_id: int, body: bytes) -> None:
        """Target side (OnReqSwichServer,
        NFCGSSwichServerModule.cpp:96-148): recreate the player from the
        blob, enter the scene, bind the client, re-route the proxy, ack.

        Hardened for supervised failover: a duplicate REQ
        re-acks idempotently, a full Player store answers
        ACK_SWITCH_REFUSED (BUSY) instead of half-admitting, and a blob
        torn in transit destroys the half-built object and refuses —
        the failover supervisor retries another survivor on every refusal."""
        from ...persist.codec import apply_snapshot
        from ...persist.rowblob import unframe_blob
        from ..failover import REFUSE_BAD_BLOB, REFUSE_BUSY
        _, req = unwrap(body, ReqSwitchServer)
        if int(req.target_serverid) != self.config.server_id:
            return
        if req.client_id is None or req.selfid is None:
            return
        ckey = _ident_key(req.client_id)
        staged = self._switch_blobs.pop(_ident_key(req.selfid), None)
        if staged is None:
            # duplicate REQ (dup'd link, or a failover re-stage racing
            # the first ack): if this client already owns a live avatar
            # here, repeat the re-route + ack instead of going silent —
            # the world-side supervisor needs the (possibly lost) ack
            sess = self.sessions.get(ckey)
            if sess is not None and sess.guid is not None:
                self._switch_accept(req, sess)
            return
        data = staged[0]
        k = self.kernel
        store = k.store
        if store.live_count("Player") >= store.capacity("Player"):
            # graceful degradation: no capacity for the refugee — refuse
            # BEFORE allocating so the supervisor can try another survivor
            self._switch_refuse(req, REFUSE_BUSY)
            return
        guid = k.create_object(
            "Player",
            {
                "Account": data.account.decode("utf-8", "replace"),
                "Name": data.name.decode("utf-8", "replace"),
                "GameID": self.config.server_id,
            },
            scene=int(req.scene_id), group=int(req.group_id),
        )
        if data.blob:
            try:
                # unframe validates CRC/length fail-closed; a legacy
                # (unframed) blob passes through to the codec unchanged
                k.state = apply_snapshot(k.store, k.state, guid,
                                         unframe_blob(data.blob))
            except Exception:
                # torn blob: k.state only mutates on success, so a clean
                # destroy admits nothing half-applied
                if guid in k.store.guid_map:
                    k.destroy_object(guid)
                self._switch_refuse(req, REFUSE_BAD_BLOB)
                return
        k.state = k.store.set_property(k.state, guid, "GameID",
                                       self.config.server_id)
        # bind the client session; the transport conn resolves to the
        # proxy link (single-proxy fast path) and self-corrects on the
        # client's first routed message (_session_for)
        sess = self.sessions.get(ckey)
        if sess is None:
            sess = Session(ident=req.client_id, conn_id=-1)
            self.sessions[ckey] = sess
        sess.account = data.account.decode("utf-8", "replace")
        sess.guid = guid
        self._guid_session[guid] = ckey
        self._enter_scene(guid, int(req.scene_id),
                          group=int(req.group_id) or 1)
        self._switch_accept(req, sess)
        if self.cross_server_sync:
            # adopted players rejoin the roster under THIS game id, so a
            # second failure can re-home them again (roster continuity)
            self._notify_online(sess, guid, int(req.scene_id),
                                int(req.group_id))

    def _switch_accept(self, req, sess: Session) -> None:
        """Re-route the proxy binding and ack the switch — shared by the
        first admit and the duplicate-REQ idempotent repeat."""
        proxy_conns = list(self.server.conn_tags)
        if len(proxy_conns) == 1:
            sess.conn_id = proxy_conns[0]
        # proxy re-route: every proxy link gets the req; the one owning
        # the client ident re-points it at this server
        for conn in proxy_conns:
            self.server.send_raw(conn, int(MsgID.REQ_SWITCH_SERVER),
                                 wrap(req, clients=[req.client_id]))
        ack = AckSwitchServer(
            selfid=req.selfid,
            self_serverid=req.self_serverid,
            target_serverid=req.target_serverid,
            gate_serverid=req.gate_serverid,
        )
        self.world_link.send_to_all(int(MsgID.ACK_SWITCH_SERVER), wrap(ack))

    def _switch_refuse(self, req, result: int) -> None:
        from ..wire import SwitchRefused

        self.world_link.send_to_all(
            int(MsgID.ACK_SWITCH_REFUSED),
            wrap(SwitchRefused(
                selfid=req.selfid,
                self_serverid=int(req.self_serverid),
                target_serverid=int(req.target_serverid),
                result=int(result),
            )),
        )

    def _on_switch_ack(self, _sid: int, _msg_id: int, body: bytes) -> None:
        """Origin side (OnAckSwichServer): the target owns the player
        now — drop the session binding and the local object."""
        _, ack = unwrap(body, AckSwitchServer)
        if int(ack.self_serverid) != self.config.server_id:
            return
        if ack.selfid is None:
            return
        guid = Guid(ack.selfid.svrid, ack.selfid.index)
        key = self._guid_session.pop(guid, None)
        if key is not None:
            sess = self.sessions.pop(key, None)
            if sess is not None:
                sess.guid = None
                self.reset_view(sess)
        if guid in self.kernel.store.guid_map:
            self.kernel.destroy_object(guid)
