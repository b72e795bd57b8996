"""Login role: account auth, world list, select-world handshake.

Reference: NFLoginLogicPlugin / NFLoginNet_ServerPlugin /
NFLoginNet_ClientPlugin — client-facing auth (`OnLoginProcess`
`NFCLoginNet_ServerModule.cpp:128-167`, permissive by default), world-list
view fed by Master, and the select-world relay toward Master
(`OnSelectWorldProcess` `:169-196`).  The auth decision is a pluggable
callback so deployments can attach a real account backend.

A copy of ``noahgameframe_tpu/net/roles/login.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..defines import EventCode, MsgID, ServerType
from ..transport import EV_DISCONNECTED
from ..wire import (
    AckConnectWorldResult,
    AckEventResult,
    AckServerList,
    Ident,
    ReqAccountLogin,
    ReqConnectWorld,
    ServerInfo,
    ServerInfoReport,
    unwrap,
    wrap,
)
from .base import RoleConfig, ServerRole, decode_reports

# (account, password) -> EventCode
AuthFn = Callable[[str, str], int]


def permissive_auth(_account: str, _password: str) -> int:
    """The reference default: any non-empty account logs in."""
    return int(EventCode.ACCOUNT_SUCCESS) if _account else int(
        EventCode.ACCOUNTPWD_INVALID
    )


class LoginRole(ServerRole):
    server_type = int(ServerType.LOGIN)

    def __init__(self, config: RoleConfig, backend: str = "auto",
                 auth: AuthFn = permissive_auth) -> None:
        self.auth = auth
        self.worlds: List[ServerInfoReport] = []
        # account -> client conn awaiting a world ack
        self._account_conn: Dict[str, int] = {}
        super().__init__(config, backend=backend)
        self.master = self.add_upstream(
            "master",
            [t for t in config.targets if t.server_type == int(ServerType.MASTER)],
            register_msg=MsgID.LTM_LOGIN_REGISTERED,
            refresh_msg=MsgID.LTM_LOGIN_REFRESH,
        )
        self.master.on(MsgID.STS_NET_INFO, self._on_world_list)
        self.master.on(MsgID.ACK_CONNECT_WORLD, self._on_ack_connect_world)

    def _install(self) -> None:
        s = self.server
        s.on(MsgID.REQ_LOGIN, self._on_login)
        s.on(MsgID.REQ_WORLD_LIST, self._on_world_list_req)
        s.on(MsgID.REQ_CONNECT_WORLD, self._on_connect_world)
        s.on_socket_event(self._on_socket)

    def _on_socket(self, conn_id: int, kind: int) -> None:
        if kind == EV_DISCONNECTED:
            self._account_conn = {
                a: c for a, c in self._account_conn.items() if c != conn_id
            }

    # ------------------------------------------------------ client side
    def _on_login(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        _, req = unwrap(body, ReqAccountLogin)
        account = req.account.decode("utf-8", "replace")
        code = self.auth(account, req.password.decode("utf-8", "replace"))
        tags = self.server.conn_tags.setdefault(conn_id, {})
        if code == int(EventCode.ACCOUNT_SUCCESS):
            tags["account"] = account
        ack = AckEventResult(event_code=code, event_object=Ident())
        self.server.send_pb(conn_id, int(MsgID.ACK_LOGIN), ack)

    def _on_world_list_req(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        infos = [
            ServerInfo(
                server_id=r.server_id,
                name=r.server_name,
                wait_count=r.server_cur_count,
                status=int(r.server_state),
            )
            for r in self.worlds
        ]
        ack = AckServerList(type=int(ServerType.WORLD), info=infos)
        self.server.send_pb(conn_id, int(MsgID.ACK_WORLD_LIST), ack)

    def _on_connect_world(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """Client picked a world → ask Master, remember who asked
        (routing key = account, `NFCLoginNet_ServerModule.cpp:169-196`)."""
        tags = self.server.conn_tags.get(conn_id, {})
        account = tags.get("account")
        if not account:
            return  # not authed; the reference silently drops too
        _, req = unwrap(body, ReqConnectWorld)
        self._account_conn[account] = conn_id
        fwd = ReqConnectWorld(
            world_id=req.world_id,
            account=account.encode(),
            sender=Ident(svrid=self.config.server_id, index=conn_id),
            login_id=self.config.server_id,
        )
        self.master.send_to_all(int(MsgID.REQ_CONNECT_WORLD), wrap(fwd))

    # ------------------------------------------------------ master side
    def _on_world_list(self, _sid: int, _msg_id: int, body: bytes) -> None:
        self.worlds = decode_reports(body)

    def _on_ack_connect_world(self, _sid: int, _msg_id: int, body: bytes) -> None:
        _, ack = unwrap(body, AckConnectWorldResult)
        account = ack.account.decode("utf-8", "replace")
        conn_id = self._account_conn.pop(account, None)
        if conn_id is not None:
            self.server.send_pb(conn_id, int(MsgID.ACK_CONNECT_WORLD), ack)
