"""Actor module: thread-pool offload with main-loop result marshalling.

Reference: NFActorPlugin — a Theron framework with N worker threads;
`RequireActor()` spawns an actor, `SendMsgToActor` posts
`NFIActorMessage{nMsgID, self, data}` to its mailbox, the actor's
component processes it on a pool thread, and the result returns through a
spin-locked `NFQueue` drained on the main thread, which invokes the
registered end-functor (`NFCActorModule.cpp:18-119`).  The pattern is
*offload → compute on pool → marshal back to the single-threaded main
loop* — game state is only ever touched from the main thread.

Here actors are mailbox wrappers over a shared `ThreadPoolExecutor`
(messages to ONE actor stay ordered; different actors run concurrently),
and `execute()` drains the finished-work queue exactly like the
reference.  The device tick doesn't need this for compute, but the host
control plane does: async persistence, blocking IO, codegen — anything
that must not stall the 1 ms main loop.

A copy of ``noahgameframe_tpu/kernel/actor.py``, which imports no jax: the
port keeps its own.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from .module import Module

# component handler: (msg_id, payload) -> result payload
HandlerFn = Callable[[int, Any], Any]
# end functor invoked on the main thread: (actor_id, msg_id, result)
EndFn = Callable[[int, int, Any], None]


class ActorComponent:
    """Per-actor logic unit (reference NFIComponent / NFCMysqlComponent):
    register handlers per message id; runs on pool threads, so it must
    not touch world state — results flow back via the end functor."""

    def __init__(self) -> None:
        self._handlers: Dict[int, HandlerFn] = {}
        self._default: Optional[HandlerFn] = None

    def on(self, msg_id: int, fn: HandlerFn) -> None:
        self._handlers[int(msg_id)] = fn

    def on_any(self, fn: HandlerFn) -> None:
        self._default = fn

    def handle(self, msg_id: int, data: Any) -> Any:
        fn = self._handlers.get(int(msg_id), self._default)
        if fn is None:
            raise KeyError(f"component has no handler for msg {msg_id}")
        return fn(msg_id, data)


class _Actor:
    """One mailbox: messages execute in order on the shared pool."""

    def __init__(self, actor_id: int, component: ActorComponent,
                 pool: ThreadPoolExecutor, done: "queue.Queue") -> None:
        self.actor_id = actor_id
        self.component = component
        self._pool = pool
        self._done = done
        self._mailbox: "queue.Queue" = queue.Queue()
        self._running = False
        self._lock = threading.Lock()

    def post(self, msg_id: int, data: Any, end_fn: Optional[EndFn]) -> None:
        self._mailbox.put((msg_id, data, end_fn))
        with self._lock:
            if not self._running:
                self._running = True
                self._pool.submit(self._drain)

    def _drain(self) -> None:
        while True:
            try:
                msg_id, data, end_fn = self._mailbox.get_nowait()
            except queue.Empty:
                with self._lock:
                    if self._mailbox.empty():
                        self._running = False
                        return
                continue
            try:
                result = self.component.handle(msg_id, data)
                err = None
            except Exception as e:  # marshal errors back too
                result, err = None, e
            self._done.put((self.actor_id, msg_id, result, err, end_fn))


class ActorModule(Module):
    """RequireActor / SendMsgToActor / main-loop drain."""

    name = "ActorModule"

    def __init__(self, threads: int = 4) -> None:
        super().__init__()
        self._pool = ThreadPoolExecutor(max_workers=threads,
                                        thread_name_prefix="nf-actor")
        self._done: "queue.Queue" = queue.Queue()
        self._actors: Dict[int, _Actor] = {}
        self._next_id = 1
        self._default_end: List[EndFn] = []
        self._errors: List[Exception] = []

    # -- reference-parity API -------------------------------------------
    def require_actor(self, component: Optional[ActorComponent] = None) -> int:
        """Spawn an actor around `component` and return its id."""
        actor_id = self._next_id
        self._next_id += 1
        self._actors[actor_id] = _Actor(
            actor_id, component or ActorComponent(), self._pool, self._done
        )
        return actor_id

    def component(self, actor_id: int) -> ActorComponent:
        return self._actors[actor_id].component

    def send_to_actor(self, actor_id: int, msg_id: int, data: Any,
                      end_fn: Optional[EndFn] = None) -> bool:
        actor = self._actors.get(actor_id)
        if actor is None:
            return False
        actor.post(int(msg_id), data, end_fn)
        return True

    def release_actor(self, actor_id: int) -> None:
        self._actors.pop(actor_id, None)

    def on_result(self, fn: EndFn) -> None:
        """Fallback end functor for posts that didn't carry one."""
        self._default_end.append(fn)

    # -- main-loop drain -------------------------------------------------
    def execute(self) -> int:
        """Deliver finished work to end functors on the caller's thread
        (the ExecuteEvent drain, `NFCActorModule.cpp:77-101`)."""
        delivered = 0
        while True:
            try:
                actor_id, msg_id, result, err, end_fn = self._done.get_nowait()
            except queue.Empty:
                return delivered
            if err is not None:
                # record, but still deliver (result=None) so waiters make
                # progress — a failed op must not strand its callback
                self._errors.append(err)
            if end_fn is not None:
                end_fn(actor_id, msg_id, result)
            else:
                for fn in self._default_end:
                    fn(actor_id, msg_id, result)
            delivered += 1

    def drain_until(self, n: int, timeout: float = 5.0) -> int:
        """Testing/shutdown aid: pump until n results delivered."""
        import time as _t

        end = _t.monotonic() + timeout
        total = 0
        while total < n and _t.monotonic() < end:
            total += self.execute()
            _t.sleep(0.001)
        return total

    def pop_errors(self) -> List[Exception]:
        out, self._errors = self._errors, []
        return out

    def shut(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._actors.clear()


class AsyncSqlComponent(ActorComponent):
    """Async relational persistence: each request runs on the actor,
    mirroring NFCAsyMysqlModule shipping serialized args to a
    NFCMysqlComponent on a pool actor (`NFCAsyMysqlModule.cpp:558-599`)."""

    OP_UPDATA, OP_QUERY, OP_SELECT, OP_DELETE, OP_EXISTS, OP_KEYS = range(6)

    def __init__(self, sql) -> None:
        super().__init__()
        self.sql = sql
        self.on(self.OP_UPDATA,
                lambda _m, a: self.sql.updata(a["table"], a["key"],
                                              a["fields"], a["values"]))
        self.on(self.OP_QUERY,
                lambda _m, a: self.sql.query(a["table"], a["key"], a["fields"]))
        self.on(self.OP_SELECT,
                lambda _m, a: self.sql.select(a["table"], a["key"]))
        self.on(self.OP_DELETE,
                lambda _m, a: self.sql.delete(a["table"], a["key"]))
        self.on(self.OP_EXISTS,
                lambda _m, a: self.sql.exists(a["table"], a["key"]))
        self.on(self.OP_KEYS,
                lambda _m, a: self.sql.keys(a["table"], a.get("like", "%")))


class AsyncSqlModule(Module):
    """The NFCAsyMysqlModule shape: fire-and-callback DB ops that never
    block the main loop; results arrive during ActorModule.execute()."""

    name = "AsyncSqlModule"

    def __init__(self, actors: ActorModule, sql) -> None:
        super().__init__()
        self.actors = actors
        self.actor_id = actors.require_actor(AsyncSqlComponent(sql))

    def _post(self, op: int, args: dict,
              cb: Optional[Callable[[Any], None]]) -> bool:
        end = (lambda _a, _m, result: cb(result)) if cb is not None else None
        return self.actors.send_to_actor(self.actor_id, op, args, end)

    def updata(self, table: str, key: str, fields, values,
               cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_UPDATA,
                          {"table": table, "key": key, "fields": fields,
                           "values": values}, cb)

    def query(self, table: str, key: str, fields,
              cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_QUERY,
                          {"table": table, "key": key, "fields": fields}, cb)

    def select(self, table: str, key: str,
               cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_SELECT,
                          {"table": table, "key": key}, cb)

    def delete(self, table: str, key: str,
               cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_DELETE,
                          {"table": table, "key": key}, cb)

    def exists(self, table: str, key: str,
               cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_EXISTS,
                          {"table": table, "key": key}, cb)

    def keys(self, table: str, like: str = "%",
             cb: Optional[Callable[[Any], None]] = None) -> bool:
        return self._post(AsyncSqlComponent.OP_KEYS,
                          {"table": table, "like": like}, cb)
