"""The host edge of the framework: NF framing and the MsgBase envelope
(``framing``, ``wire``), the pure-Python and native (``native/nfnet.cc``
over ctypes) transports, the net modules with their dispatch tables
(``module``), the metrics HTTP server (``http``), the SLG and shop wire
families, the batched serving edge's session table (``serving``),
deterministic fault injection (``chaos``), supervised session failover
(``failover``) and the five server roles with the localhost cluster
(``roles``).  Counterpart of ``noahgameframe_tpu/net`` with its exports;
the roles, chaos and failover are imported by path."""

from . import defines, framing, wire
from .defines import MsgID, ServerState, ServerType
from .framing import FrameDecoder, ProtocolError, pack_frame, unpack_head
from .module import NetClientModule, NetServerModule
from .transport import (
    EV_CONNECTED,
    EV_DISCONNECTED,
    EV_MSG,
    NetEvent,
    PyNetClient,
    PyNetServer,
    create_client,
    create_server,
)
from .wire import Ident, Message, MsgBase, unwrap, wrap

__all__ = [
    "defines",
    "framing",
    "wire",
    "MsgID",
    "ServerState",
    "ServerType",
    "FrameDecoder",
    "ProtocolError",
    "pack_frame",
    "unpack_head",
    "NetClientModule",
    "NetServerModule",
    "EV_CONNECTED",
    "EV_DISCONNECTED",
    "EV_MSG",
    "NetEvent",
    "PyNetClient",
    "PyNetServer",
    "create_client",
    "create_server",
    "Ident",
    "Message",
    "MsgBase",
    "unwrap",
    "wrap",
]
