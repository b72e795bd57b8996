"""Minimal non-blocking HTTP server, pumped from the main loop.

Reference equivalent: NFCHttpNet — an evhttp server the Master role uses
to expose cluster status (`NFComm/NFNet/NFCHttpNet.{h,cpp}`, pumped from
`Execute` `:38-45`).  Like everything else in the stack it is poll-driven:
``execute()`` accepts, reads, dispatches and writes without blocking, so
it composes with the 1 ms main loop.

Only what the monitor needs is implemented: GET routing by path with
string/bytes/JSON responses.  Handlers run synchronously on the main
thread (the reference dispatches on its event loop the same way).

A copy of ``noahgameframe_tpu/net/http.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import selectors
import socket
from typing import Callable, Dict, Optional, Tuple, Union

Response = Union[str, bytes, dict, list, Tuple[int, str, bytes]]
Handler = Callable[[str, Dict[str, str]], Response]

_MAX_HEADER = 64 * 1024


class _HttpConn:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.inbuf = b""
        self.outbuf = b""
        self.done_reading = False


class HttpServer:
    """GET-only HTTP endpoint (the Master monitor API)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._sel = selectors.DefaultSelector()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._listener.setblocking(False)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._conns: Dict[socket.socket, _HttpConn] = {}
        self._routes: Dict[str, Handler] = {}
        self._fallback: Optional[Handler] = None

    # ------------------------------------------------------------ routes
    def route(self, path: str, fn: Handler) -> None:
        self._routes[path] = fn

    def route_default(self, fn: Handler) -> None:
        self._fallback = fn

    # ------------------------------------------------------------ pump
    def execute(self) -> None:
        for key, mask in self._sel.select(timeout=0):
            if key.data is None:
                self._accept()
            else:
                self._pump(key.data, mask)

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            conn = _HttpConn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _pump(self, conn: _HttpConn, mask: int) -> None:
        if mask & selectors.EVENT_READ and not conn.done_reading:
            try:
                chunk = conn.sock.recv(8192)
            except (BlockingIOError, InterruptedError):
                chunk = None
            except OSError:
                self._drop(conn)
                return
            if chunk == b"":
                self._drop(conn)
                return
            if chunk:
                conn.inbuf += chunk
                if len(conn.inbuf) > _MAX_HEADER:
                    self._drop(conn)
                    return
                if b"\r\n\r\n" in conn.inbuf:
                    conn.done_reading = True
                    conn.outbuf = self._respond(conn.inbuf)
                    self._sel.modify(conn.sock, selectors.EVENT_WRITE, conn)
        if mask & selectors.EVENT_WRITE and conn.outbuf:
            try:
                n = conn.sock.send(conn.outbuf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._drop(conn)
                return
            conn.outbuf = conn.outbuf[n:]
            if not conn.outbuf:
                self._drop(conn)  # HTTP/1.0 close-after-response

    def _drop(self, conn: _HttpConn) -> None:
        self._sel.unregister(conn.sock)
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ dispatch
    def _respond(self, raw: bytes) -> bytes:
        try:
            request_line = raw.split(b"\r\n", 1)[0].decode("latin-1")
            method, target, _ = request_line.split(" ", 2)
        except ValueError:
            return _http(400, "text/plain", b"bad request")
        if method != "GET":
            return _http(405, "text/plain", b"method not allowed")
        path, _, query = target.partition("?")
        params: Dict[str, str] = {}
        for part in query.split("&"):
            if "=" in part:
                k, _, v = part.partition("=")
                params[k] = v
        fn = self._routes.get(path) or self._fallback
        if fn is None:
            return _http(404, "text/plain", b"not found")
        try:
            result = fn(path, params)
        except Exception as e:  # handler bug must not kill the server
            return _http(500, "text/plain", f"error: {e}".encode())
        if isinstance(result, tuple):
            status, ctype, body = result
            return _http(status, ctype, body)
        if isinstance(result, (dict, list)):
            return _http(200, "application/json", json.dumps(result).encode())
        if isinstance(result, str):
            result = result.encode("utf-8")
        return _http(200, "text/html", result)

    def close(self) -> None:
        for conn in list(self._conns.values()):
            self._drop(conn)
        self._sel.unregister(self._listener)
        self._listener.close()
        self._sel.close()


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 500: "Internal Server Error"}


def _http(status: int, ctype: str, body: bytes) -> bytes:
    head = (
        f"HTTP/1.0 {status} {_STATUS.get(status, 'Unknown')}\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\n"
        # a read-only status API; allow the web-monitor page to poll it
        # when opened from disk or another host
        "Access-Control-Allow-Origin: *\r\n"
        "Connection: close\r\n\r\n"
    )
    return head.encode("latin-1") + body
