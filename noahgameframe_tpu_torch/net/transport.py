"""Non-blocking TCP transport with the NF pump model.

The reference pumps libevent once per main-loop tick
(`NFCNet.cpp:165-180`: ``event_base_loop(EVLOOP_ONCE|EVLOOP_NONBLOCK)``).
Here the same contract is ``poll()``: call it each tick, it performs all
ready I/O and returns the framed events since the last call.  No
threads touch game state — identical to the reference's single-threaded
discipline (SURVEY §5 race-avoidance-by-structure).

Two interchangeable backends implement this contract:

- this module: pure-Python ``selectors`` (always available; tests, CI);
- :mod:`noahgameframe_tpu_torch.net.native`: the C++ epoll runtime in
  ``native/nfnet.cc`` (production path), same event tuples.

Use :func:`create_server` / :func:`create_client` to pick a backend.

A copy of ``noahgameframe_tpu/net/transport.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import errno
import selectors
import socket
from typing import Dict, List, Optional, Tuple

from .framing import FrameDecoder, ProtocolError, pack_frame

# event kinds
EV_CONNECTED = 1
EV_DISCONNECTED = 2
EV_MSG = 3


@dataclasses.dataclass
class NetEvent:
    kind: int
    conn_id: int
    msg_id: int = 0
    body: bytes = b""


class _Conn:
    __slots__ = ("sock", "decoder", "outbuf", "connecting")

    def __init__(self, sock: socket.socket, connecting: bool = False) -> None:
        self.sock = sock
        self.decoder = FrameDecoder()
        self.outbuf = bytearray()
        self.connecting = connecting


class _Endpoint:
    """Shared server/client machinery: registered socket set + pump."""

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._conns: Dict[int, _Conn] = {}
        self._events: List[NetEvent] = []
        self._next_id = 1

    # ------------------------------------------------------------- io
    def _register(self, sock: socket.socket, connecting: bool = False) -> int:
        cid = self._next_id
        self._next_id += 1
        conn = _Conn(sock, connecting)
        self._conns[cid] = conn
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if connecting else 0)
        self._sel.register(sock, mask, cid)
        return cid

    def _close(self, cid: int, notify: bool = True) -> None:
        conn = self._conns.pop(cid, None)
        if conn is None:
            return
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if notify:
            self._events.append(NetEvent(EV_DISCONNECTED, cid))

    def send(self, conn_id: int, msg_id: int, body: bytes) -> bool:
        conn = self._conns.get(conn_id)
        if conn is None:
            return False
        conn.outbuf.extend(pack_frame(msg_id, body))
        self._want_write(conn_id, True)
        return True

    def _want_write(self, cid: int, on: bool) -> None:
        conn = self._conns.get(cid)
        if conn is None or conn.connecting:
            return
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        try:
            self._sel.modify(conn.sock, mask, cid)
        except (KeyError, ValueError):
            pass

    def _pump_conn(self, cid: int, mask: int) -> None:
        conn = self._conns.get(cid)
        if conn is None:
            return
        if conn.connecting and mask & selectors.EVENT_WRITE:
            err = conn.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._close(cid)
                return
            conn.connecting = False
            self._events.append(NetEvent(EV_CONNECTED, cid))
            self._want_write(cid, bool(conn.outbuf))
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(256 * 1024)
            except BlockingIOError:
                data = None
            except OSError:
                self._close(cid)
                return
            if data == b"":
                self._close(cid)
                return
            if data:
                try:
                    frames = conn.decoder.feed(data)
                except ProtocolError:
                    self._close(cid)
                    return
                for msg_id, body in frames:
                    self._events.append(NetEvent(EV_MSG, cid, msg_id, body))
        if mask & selectors.EVENT_WRITE and not conn.connecting and conn.outbuf:
            try:
                n = conn.sock.send(conn.outbuf)
            except BlockingIOError:
                n = 0
            except OSError:
                self._close(cid)
                return
            if n:
                del conn.outbuf[:n]
            if not conn.outbuf:
                self._want_write(cid, False)

    def _pump(self) -> None:
        while True:
            ready = self._sel.select(timeout=0)
            if not ready:
                return
            for key, mask in ready:
                self._on_ready(key, mask)
            # one pass is enough per tick; loop only drains accept bursts
            return

    def _on_ready(self, key: selectors.SelectorKey, mask: int) -> None:
        self._pump_conn(key.data, mask)

    def poll(self) -> List[NetEvent]:
        """One main-loop tick: perform ready I/O, return framed events."""
        self._pump()
        out = self._events
        self._events = []
        return out

    def close(self) -> None:
        for cid in list(self._conns):
            self._close(cid, notify=False)
        self._sel.close()

    @property
    def num_connections(self) -> int:
        return len(self._conns)


class PyNetServer(_Endpoint):
    """Listening endpoint; `conn_id`s identify accepted peers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(512)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self._sel.register(self._listener, selectors.EVENT_READ, 0)  # 0 = listener

    def _on_ready(self, key: selectors.SelectorKey, mask: int) -> None:
        if key.data == 0:
            while True:
                try:
                    sock, _ = self._listener.accept()
                except (BlockingIOError, OSError):
                    break
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                cid = self._register(sock)
                self._events.append(NetEvent(EV_CONNECTED, cid))
        else:
            self._pump_conn(key.data, mask)

    def close_conn(self, conn_id: int) -> None:
        self._close(conn_id)

    def close(self) -> None:
        super().close()
        try:
            self._listener.close()
        except OSError:
            pass


class PyNetClient(_Endpoint):
    """Single outbound connection (one per pooled link)."""

    def __init__(self, host: str, port: int) -> None:
        super().__init__()
        self.host, self.port = host, port
        self._cid: Optional[int] = None
        self.connected = False

    def connect(self) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rc = sock.connect_ex((self.host, self.port))
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            self._events.append(NetEvent(EV_DISCONNECTED, 0))
            return
        self._cid = self._register(sock, connecting=True)

    def poll(self) -> List[NetEvent]:
        evs = super().poll()
        for ev in evs:
            if ev.kind == EV_CONNECTED:
                self.connected = True
            elif ev.kind == EV_DISCONNECTED and ev.conn_id == self._cid:
                self.connected = False
                self._cid = None
        return evs

    def send_msg(self, msg_id: int, body: bytes) -> bool:
        if self._cid is None:
            return False
        return self.send(self._cid, msg_id, body)

    def disconnect(self) -> None:
        if self._cid is not None:
            self._close(self._cid)
            self.connected = False
            self._cid = None


def create_server(host: str = "127.0.0.1", port: int = 0, backend: str = "auto"):
    """backend: 'py', 'native', or 'auto' (native if the C++ lib builds)."""
    if backend in ("native", "auto"):
        try:
            from .native import NativeNetServer

            return NativeNetServer(host, port)
        except Exception:
            if backend == "native":
                raise
    return PyNetServer(host, port)


def create_client(host: str, port: int, backend: str = "auto"):
    if backend in ("native", "auto"):
        try:
            from .native import NativeNetClient

            return NativeNetClient(host, port)
        except Exception:
            if backend == "native":
                raise
    return PyNetClient(host, port)
