"""Data agents: event-driven per-entity persistence + role lists.

Reference: NFDataAgent_NosqlPlugin — player save/load rides the object
lifecycle: on COE_CREATE_LOADDATA the saved protobuf blob is attached to
the fresh object, on destroy/offline the live managers are converted
back and written (`NFCPlayerRedisModule.cpp:226-321`); account role
lists live under their own keys.  Here the same hooks bind to the
kernel's class-event chain, and blobs are the codec.py packs.

Counterpart of ``noahgameframe_tpu/persist/agent.py`` over the port's
kernel; with ``pipeline`` set (persist/writebehind.py) saves stage
through its write-ahead log.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.datatypes import Guid
from ..kernel.kernel import Kernel, ObjectEvent
from ..net.wire import AckRoleLiteInfoList, RoleLiteInfo
from .codec import apply_snapshot, resolve_pending, snapshot_object
from .kv import KVStore

KeyFn = Callable[[Guid], Optional[str]]


class PlayerDataAgent:
    """Save-on-destroy / load-on-create for one class (default Player).

    The storage key is derived per object by `key_fn`.  The default is
    "account:name" — one slot per character, so two roles on one account
    never share a blob (the reference likewise keys role blobs by role,
    not account).  Only Save-flagged (optionally Cache) columns persist."""

    def __init__(
        self,
        kv: KVStore,
        class_name: str = "Player",
        key_prefix: str = "obj:",
        flags: tuple = ("save",),
        key_fn: Optional[KeyFn] = None,
    ) -> None:
        self.kv = kv
        self.class_name = class_name
        self.key_prefix = key_prefix
        self.flags = flags
        self.kernel: Optional[Kernel] = None
        self._key_fn = key_fn
        # optional write-behind pipeline (persist.writebehind): when
        # set, saves stage through its WAL-backed queue instead of
        # calling the store inline — a destroy during a store outage is
        # durable in the WAL instead of silently lost
        self.pipeline = None
        # OBJECT refs whose targets weren't loaded yet (e.g. a player's
        # GuildID applied before the guild entity exists); re-resolved on
        # every subsequent load and via resolve_refs()
        self._pending: list = []

    def bind(self, kernel: Kernel) -> "PlayerDataAgent":
        self.kernel = kernel
        kernel.register_class_event(self._on_event, self.class_name)
        return self

    def _key_of(self, guid: Guid) -> Optional[str]:
        if self._key_fn is not None:
            k = self._key_fn(guid)
            return None if not k else self.key_prefix + k
        spec = self.kernel.store.spec(self.class_name)
        if spec.has_property("Account") and spec.has_property("Name"):
            account = str(self.kernel.get_property(guid, "Account"))
            name = str(self.kernel.get_property(guid, "Name"))
            if account and name:
                return f"{self.key_prefix}{account}:{name}"
        return None

    # -- lifecycle hooks ------------------------------------------------
    def _on_event(self, guid: Guid, cname: str, ev: ObjectEvent) -> None:
        if ev == ObjectEvent.CREATE_LOADDATA:
            self.load(guid)
        elif ev == ObjectEvent.BEFORE_DESTROY:
            self.save(guid)

    def load(self, guid: Guid) -> bool:
        key = self._key_of(guid)
        if key is None:
            return False
        blob = None
        if self.pipeline is not None:
            # read-your-writes: a save still queued (store down, or the
            # flusher simply hasn't reached it) must win over the
            # store's stale copy; a queued tombstone means "no blob"
            queued, pend = self.pipeline.pending(key)
            if queued:
                blob = pend
                if blob is None:
                    return False
        if blob is None:
            blob = self.kv.get(key)
        if blob is None:
            return False
        k = self.kernel
        k.state = apply_snapshot(k.store, k.state, guid, blob, self._pending)
        self.resolve_refs()
        return True

    def resolve_refs(self) -> int:
        """Re-apply deferred OBJECT references whose targets exist now;
        returns how many remain unresolved (load-order independence)."""
        if not self._pending:
            return 0
        k = self.kernel
        k.state, self._pending = resolve_pending(k.store, k.state, self._pending)
        return len(self._pending)

    def save(self, guid: Guid) -> bool:
        key = self._key_of(guid)
        if key is None:
            return False
        k = self.kernel
        blob = snapshot_object(k.store, k.state, guid, self.flags)
        if self.pipeline is not None:
            self.pipeline.enqueue_one(key, blob)
        else:
            self.kv.set(key, blob)
        return True

    def exists(self, key: str) -> bool:
        """key is the suffix after the prefix, e.g. "account:RoleName"."""
        full = self.key_prefix + key
        if self.pipeline is not None:
            queued, pend = self.pipeline.pending(full)
            if queued:
                return pend is not None
        return self.kv.exists(full)

    def delete(self, key: str) -> bool:
        """Drop a character's blob (role deletion).  With a pipeline the
        delete is a queued tombstone: it supersedes any older queued
        save (no resurrection) and reaches the store durably."""
        full = self.key_prefix + key
        if self.pipeline is not None:
            self.pipeline.discard(full)
            self.pipeline.enqueue_one(full, None)
            return True
        return self.kv.delete(full)


class RoleListStore:
    """Account → role-list persistence (the pre-enter-game role CRUD data;
    reference NFCAccountRedisModule keeps these under account keys)."""

    def __init__(self, kv: KVStore, key_prefix: str = "roles:") -> None:
        self.kv = kv
        self.key_prefix = key_prefix

    def load(self, account: str) -> List[RoleLiteInfo]:
        blob = self.kv.get(self.key_prefix + account)
        if blob is None:
            return []
        return list(AckRoleLiteInfoList.decode(blob).char_data)

    def save(self, account: str, roles: List[RoleLiteInfo]) -> None:
        self.kv.set(
            self.key_prefix + account,
            AckRoleLiteInfoList(char_data=list(roles)).encode(),
        )
