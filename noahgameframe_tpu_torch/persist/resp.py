"""RESP (Redis serialization protocol) client + a miniature server.

Reference: NFNoSqlPlugin drives a real Redis through a vendored C++
client (`NFComm/NFNoSqlPlugin/`, wrapping redis-cplusplus-client).  Here
:class:`RespKV` is a from-scratch RESP2 client implementing the same op
set over a blocking socket (persistence is control-plane, not tick-path),
and :class:`MiniRedisServer` is an in-process RESP server implementing
just enough of the command set (GET/SET/DEL/EXISTS/KEYS/HSET/HGET/
HGETALL/HDEL/PING) to stand in for Redis in tests and single-box
deployments — the localhost analogue of the reference's "start redis
first" deployment step.

A copy of ``noahgameframe_tpu/persist/resp.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Dict, List, Optional

from .kv import KVStore, MemoryKV

# ---------------------------------------------------------------- protocol


def encode_command(*parts: bytes) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        out.append(b"$%d\r\n%s\r\n" % (len(p), p))
    return b"".join(out)


class _RespReader:
    """Incremental RESP value reader over a readable file object."""

    def __init__(self, rfile) -> None:
        self.rfile = rfile

    def read_value(self):
        line = self.rfile.readline()
        if not line:
            raise ConnectionError("connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self.rfile.read(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_value() for _ in range(n)]
        raise ValueError(f"bad RESP type byte {kind!r}")


# ---------------------------------------------------------------- client


class RespKV(KVStore):
    """KVStore over a live RESP endpoint (Redis or MiniRedisServer)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 5.0) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._reader = _RespReader(self._rfile)
        self._lock = threading.Lock()

    def _cmd(self, *parts):
        enc = [p.encode() if isinstance(p, str) else bytes(p) for p in parts]
        with self._lock:
            self._sock.sendall(encode_command(*enc))
            return self._reader.read_value()

    def ping(self) -> bool:
        return self._cmd("PING") == "PONG"

    def get(self, key: str) -> Optional[bytes]:
        return self._cmd("GET", key)

    def set(self, key: str, value: bytes) -> None:
        self._cmd("SET", key, value)

    def delete(self, key: str) -> bool:
        return int(self._cmd("DEL", key)) > 0

    def exists(self, key: str) -> bool:
        return int(self._cmd("EXISTS", key)) > 0

    def keys(self, pattern: str = "*") -> List[str]:
        return sorted(k.decode() for k in self._cmd("KEYS", pattern))

    def hset(self, key: str, field: str, value: bytes) -> None:
        self._cmd("HSET", key, field, value)

    def hget(self, key: str, field: str) -> Optional[bytes]:
        return self._cmd("HGET", key, field)

    def hgetall(self, key: str) -> Dict[str, bytes]:
        flat = self._cmd("HGETALL", key)
        return {
            flat[i].decode(): flat[i + 1] for i in range(0, len(flat), 2)
        }

    def hdel(self, key: str, field: str) -> bool:
        return int(self._cmd("HDEL", key, field)) > 0

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------- server


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        reader = _RespReader(self.rfile)
        store: MemoryKV = self.server.store  # type: ignore[attr-defined]
        lock: threading.Lock = self.server.lock  # type: ignore[attr-defined]
        while True:
            try:
                parts = reader.read_value()
            except (ConnectionError, ValueError):
                return
            if not isinstance(parts, list) or not parts:
                return
            cmd = parts[0].decode().upper()
            args = parts[1:]
            with lock:
                self.wfile.write(self._run(store, cmd, args))
            self.wfile.flush()

    def _run(self, store: MemoryKV, cmd: str, args: List[bytes]) -> bytes:
        def s(i: int) -> str:
            return args[i].decode()

        if cmd == "PING":
            return b"+PONG\r\n"
        if cmd == "SET":
            store.set(s(0), args[1])
            return b"+OK\r\n"
        if cmd == "GET":
            v = store.get(s(0))
            return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
        if cmd == "DEL":
            n = sum(1 for a in args if store.delete(a.decode()))
            return b":%d\r\n" % n
        if cmd == "EXISTS":
            return b":%d\r\n" % (1 if store.exists(s(0)) else 0)
        if cmd == "KEYS":
            ks = store.keys(s(0))
            return b"*%d\r\n" % len(ks) + b"".join(
                b"$%d\r\n%s\r\n" % (len(k.encode()), k.encode()) for k in ks
            )
        if cmd == "HSET":
            store.hset(s(0), s(1), args[2])
            return b":1\r\n"
        if cmd == "HGET":
            v = store.hget(s(0), s(1))
            return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
        if cmd == "HGETALL":
            h = store.hgetall(s(0))
            out = [b"*%d\r\n" % (2 * len(h))]
            for f, v in h.items():
                fb = f.encode()
                out.append(b"$%d\r\n%s\r\n" % (len(fb), fb))
                out.append(b"$%d\r\n%s\r\n" % (len(v), v))
            return b"".join(out)
        if cmd == "HDEL":
            return b":%d\r\n" % (1 if store.hdel(s(0), s(1)) else 0)
        return b"-ERR unknown command '%s'\r\n" % cmd.encode()


class MiniRedisServer:
    """Threaded in-process RESP server over a MemoryKV."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.store = MemoryKV()
        self.lock = threading.Lock()
        self._srv = socketserver.ThreadingTCPServer((host, port), _Handler,
                                                    bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.store = self.store  # type: ignore[attr-defined]
        self._srv.lock = self.lock  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2)
