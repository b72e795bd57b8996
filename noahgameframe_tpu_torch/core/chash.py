"""Consistent hash ring for server selection.

Behavioral equivalent of the reference's `NFCConsistentHash.hpp:21-50`:
each real node contributes V virtual nodes hashed as
``crc32("{data}-{vindex}")`` onto a sorted ring; a key routes to the
first virtual node clockwise from ``crc32(key)``.  Used by the network
client pool to pick a game server per player GUID and by the proxy to
route clients.

A copy of ``noahgameframe_tpu/core/chash.py``, which imports no jax: the port
keeps its own, since it imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import zlib
from typing import Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")

VIRTUAL_NODES = 500


def _crc(data: str) -> int:
    return zlib.crc32(data.encode("utf-8")) & 0xFFFFFFFF


class ConsistentHash(Generic[T]):
    def __init__(self, virtual_nodes: int = VIRTUAL_NODES) -> None:
        self._v = virtual_nodes
        self._ring: Dict[int, T] = {}
        self._keys: List[int] = []

    def add(self, name: str, node: T) -> None:
        for i in range(self._v):
            h = _crc(f"{name}-{i}")
            if h not in self._ring:
                bisect.insort(self._keys, h)
            self._ring[h] = node

    def remove(self, name: str) -> None:
        for i in range(self._v):
            h = _crc(f"{name}-{i}")
            if h in self._ring:
                del self._ring[h]
                idx = bisect.bisect_left(self._keys, h)
                if idx < len(self._keys) and self._keys[idx] == h:
                    del self._keys[idx]

    def get(self, key: str) -> Optional[T]:
        if not self._keys:
            return None
        h = _crc(key)
        idx = bisect.bisect_left(self._keys, h)
        if idx == len(self._keys):
            idx = 0
        return self._ring[self._keys[idx]]

    def __len__(self) -> int:
        return len(self._ring)

    def __bool__(self) -> bool:
        return bool(self._keys)
