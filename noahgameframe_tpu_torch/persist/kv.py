"""Pluggable key-value backends for the persistence agents.

Reference: NFNoSqlPlugin wraps a Redis client with KV/Hash ops behind
`NFINoSqlModule` (`NFCNoSqlDriver.h:29-120`), and the data agents store
player blobs under string keys.  The same seam here: agents speak
:class:`KVStore`; deployments pick memory (tests), file (single-node
durability) or the RESP client in resp.py (real Redis).

A copy of ``noahgameframe_tpu/persist/kv.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional


class KVStore:
    """The minimal contract the agents need (subset of NFINoSqlModule)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return self.get(key) is not None

    def keys(self, pattern: str = "*") -> List[str]:
        raise NotImplementedError

    # hash ops (HSET/HGET/HGETALL family)
    def hset(self, key: str, field: str, value: bytes) -> None:
        raise NotImplementedError

    def hget(self, key: str, field: str) -> Optional[bytes]:
        raise NotImplementedError

    def hgetall(self, key: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def hdel(self, key: str, field: str) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryKV(KVStore):
    """In-process dict backend (tests, single-process worlds)."""

    def __init__(self) -> None:
        self._kv: Dict[str, bytes] = {}
        self._hashes: Dict[str, Dict[str, bytes]] = {}

    def get(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)

    def set(self, key: str, value: bytes) -> None:
        self._kv[key] = bytes(value)

    def delete(self, key: str) -> bool:
        had = key in self._kv or key in self._hashes
        self._kv.pop(key, None)
        self._hashes.pop(key, None)
        return had

    def keys(self, pattern: str = "*") -> List[str]:
        names = set(self._kv) | set(self._hashes)
        return sorted(k for k in names if fnmatch.fnmatchcase(k, pattern))

    def hset(self, key: str, field: str, value: bytes) -> None:
        self._hashes.setdefault(key, {})[field] = bytes(value)

    def hget(self, key: str, field: str) -> Optional[bytes]:
        return self._hashes.get(key, {}).get(field)

    def hgetall(self, key: str) -> Dict[str, bytes]:
        return dict(self._hashes.get(key, {}))

    def hdel(self, key: str, field: str) -> bool:
        h = self._hashes.get(key)
        if h and field in h:
            del h[field]
            return True
        return False


class FileKV(KVStore):
    """One file per key under a directory; atomic writes via rename.

    Keys are hashed into the filename (keys may contain '/' etc.); the
    original key is stored alongside for `keys()` listing."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str, kind: str = "v") -> Path:
        h = hashlib.sha1(key.encode()).hexdigest()
        return self.root / f"{h}.{kind}"

    def _write_atomic(self, path: Path, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=str(self.root))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, str(path))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str) -> Optional[bytes]:
        p = self._path(key)
        return p.read_bytes() if p.exists() else None

    def set(self, key: str, value: bytes) -> None:
        self._write_atomic(self._path(key, "k"), key.encode())
        self._write_atomic(self._path(key), value)

    def delete(self, key: str) -> bool:
        had = False
        for kind in ("v", "k", "h"):
            p = self._path(key, kind)
            if p.exists():
                p.unlink()
                had = True
        return had

    def keys(self, pattern: str = "*") -> List[str]:
        out = []
        for kp in self.root.glob("*.k"):
            key = kp.read_bytes().decode()
            if fnmatch.fnmatchcase(key, pattern):
                out.append(key)
        return sorted(out)

    # hashes: stored as one file of length-prefixed field/value pairs
    def _read_hash(self, key: str) -> Dict[str, bytes]:
        p = self._path(key, "h")
        if not p.exists():
            return {}
        data = p.read_bytes()
        out: Dict[str, bytes] = {}
        off = 0
        while off < len(data):
            fl = int.from_bytes(data[off : off + 4], "big")
            field = data[off + 4 : off + 4 + fl].decode()
            off += 4 + fl
            vl = int.from_bytes(data[off : off + 4], "big")
            out[field] = data[off + 4 : off + 4 + vl]
            off += 4 + vl
        return out

    def _write_hash(self, key: str, h: Dict[str, bytes]) -> None:
        self._write_atomic(self._path(key, "k"), key.encode())
        buf = bytearray()
        for field, value in h.items():
            fb = field.encode()
            buf += len(fb).to_bytes(4, "big") + fb
            buf += len(value).to_bytes(4, "big") + value
        self._write_atomic(self._path(key, "h"), bytes(buf))

    def hset(self, key: str, field: str, value: bytes) -> None:
        h = self._read_hash(key)
        h[field] = bytes(value)
        self._write_hash(key, h)

    def hget(self, key: str, field: str) -> Optional[bytes]:
        return self._read_hash(key).get(field)

    def hgetall(self, key: str) -> Dict[str, bytes]:
        return self._read_hash(key)

    def hdel(self, key: str, field: str) -> bool:
        h = self._read_hash(key)
        if field not in h:
            return False
        del h[field]
        self._write_hash(key, h)
        return True
