"""ctypes binding for the native C++ epoll transport (native/nfnet.cc).

Builds ``libnfnet.so`` on demand with g++ (the image has no pybind11;
the flat C API + ctypes keeps the binding dependency-free).  The
classes expose the exact poll/send contract of the pure-Python backend
in :mod:`noahgameframe_tpu_torch.net.transport`, so the two are drop-in
interchangeable via ``create_server/create_client``.

A copy of ``noahgameframe_tpu/net/native.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.  It binds the
same source, ``native/nfnet.cc``, but builds the library with ``g++`` into
``noahgameframe_tpu_torch/csrc/build/`` (gitignored), not into
``native/build/``: the build is written to a temporary name and renamed,
so concurrent first uses (test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from .transport import EV_CONNECTED, EV_DISCONNECTED, NetEvent

# the source: the repo's native/ by default; NF_NATIVE_DIR points at any
# directory holding nfnet.cc.  create_server/create_client fall back to
# the pure-Python transport under backend="auto" when the build fails
import os as _os

_NATIVE_DIR = Path(
    _os.environ.get("NF_NATIVE_DIR")
    or Path(__file__).resolve().parents[2] / "native"
)
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
_LIB_PATH = _BUILD_DIR / "libnfnet.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """``g++ -O2 -std=c++17 -fPIC -shared`` (native/Makefile's flags) into
    a per-process temporary file, renamed into place."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".libnfnet.{_os.getpid()}.so"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
         "-o", str(tmp), str(_NATIVE_DIR / "nfnet.cc")],
        check=True,
        capture_output=True,
    )
    _os.replace(tmp, _LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.nfnet_server_create.restype = ctypes.c_void_p
        lib.nfnet_server_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.nfnet_client_create.restype = ctypes.c_void_p
        lib.nfnet_client_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.nfnet_client_connect.restype = ctypes.c_int
        lib.nfnet_client_connect.argtypes = [ctypes.c_void_p]
        lib.nfnet_server_port.restype = ctypes.c_int
        lib.nfnet_server_port.argtypes = [ctypes.c_void_p]
        lib.nfnet_num_conns.restype = ctypes.c_int
        lib.nfnet_num_conns.argtypes = [ctypes.c_void_p]
        lib.nfnet_poll.restype = ctypes.c_int
        lib.nfnet_poll.argtypes = [ctypes.c_void_p]
        for fn in ("nfnet_event_kind", "nfnet_event_conn", "nfnet_event_msgid"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nfnet_event_body.restype = ctypes.POINTER(ctypes.c_char)
        lib.nfnet_event_body.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.nfnet_send.restype = ctypes.c_int
        lib.nfnet_send.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.nfnet_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nfnet_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class _NativeEndpoint:
    def __init__(self, handle: int) -> None:
        self._lib = _load()
        self._h = handle
        if not self._h:
            raise OSError("nfnet endpoint creation failed")

    def poll(self) -> List[NetEvent]:
        lib, h = self._lib, self._h
        n = lib.nfnet_poll(h)
        out: List[NetEvent] = []
        ln = ctypes.c_uint32()
        for i in range(n):
            kind = lib.nfnet_event_kind(h, i)
            cid = lib.nfnet_event_conn(h, i)
            if kind == 3:
                ptr = lib.nfnet_event_body(h, i, ctypes.byref(ln))
                body = ctypes.string_at(ptr, ln.value)
                out.append(NetEvent(kind, cid, lib.nfnet_event_msgid(h, i), body))
            else:
                out.append(NetEvent(kind, cid))
        return out

    def send(self, conn_id: int, msg_id: int, body: bytes) -> bool:
        return bool(self._lib.nfnet_send(self._h, conn_id, msg_id, body, len(body)))

    @property
    def num_connections(self) -> int:
        return self._lib.nfnet_num_conns(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.nfnet_destroy(self._h)
            self._h = 0

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


class NativeNetServer(_NativeEndpoint):
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        lib = _load()
        super().__init__(lib.nfnet_server_create(host.encode(), port))
        self.port = lib.nfnet_server_port(self._h)

    def close_conn(self, conn_id: int) -> None:
        self._lib.nfnet_close_conn(self._h, conn_id)


class NativeNetClient(_NativeEndpoint):
    def __init__(self, host: str, port: int) -> None:
        lib = _load()
        super().__init__(lib.nfnet_client_create(host.encode(), port))
        self.host, self.port = host, port
        self._cid: Optional[int] = None
        self.connected = False

    def connect(self) -> None:
        cid = self._lib.nfnet_client_connect(self._h)
        self._cid = cid if cid > 0 else None
        if cid <= 0:
            # surface as a disconnect on next poll, matching the py backend
            self.connected = False

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
            self._lib.nfnet_close_conn(self._h, self._cid)
            self._cid = None
            self.connected = False
