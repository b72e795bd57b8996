"""The port's actor offload and async SQL (kernel/actor.py over the port's
persist/sql.py) against the JAX package: tests/test_infra.py's four actor
and async-SQL cases, each run on both packages with the same messages;
the end functors' results (and the errors collected) must be equal."""

from __future__ import annotations

import threading
import time

import pytest

from test_torch_middleware import PKGS


def actor_offload_and_marshal_back(P):
    am = P.kernel.ActorModule(threads=2)
    comp = P.kernel.ActorComponent()
    comp.on(1, lambda _m, x: x * 2)
    aid = am.require_actor(comp)
    results = []
    main_thread = threading.get_ident()
    worker_threads = set()
    comp.on(2, lambda _m, x: worker_threads.add(threading.get_ident()) or x)

    def end(actor_id, msg_id, result):
        assert threading.get_ident() == main_thread
        results.append((actor_id, msg_id, result))

    am.send_to_actor(aid, 1, 21, end)
    am.send_to_actor(aid, 2, "t", end)
    assert am.drain_until(2) == 2
    assert (aid, 1, 42) in results
    assert worker_threads and main_thread not in worker_threads
    am.shut()
    return sorted(results, key=repr)


def actor_message_ordering_per_mailbox(P):
    am = P.kernel.ActorModule(threads=4)
    seen = []
    comp = P.kernel.ActorComponent()
    comp.on_any(lambda _m, x: (time.sleep(0.001), seen.append(x))[1] or x)
    aid = am.require_actor(comp)
    for i in range(20):
        am.send_to_actor(aid, 1, i, None)
    am.drain_until(0, timeout=0.1)
    deadline = time.monotonic() + 5
    while len(seen) < 20 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert seen == list(range(20))
    am.shut()
    return seen


def actor_errors_are_collected_not_raised(P):
    am = P.kernel.ActorModule(threads=1)
    comp = P.kernel.ActorComponent()
    comp.on(1, lambda _m, _x: 1 / 0)
    aid = am.require_actor(comp)
    am.send_to_actor(aid, 1, None, lambda *a: None)
    am.drain_until(1, timeout=2.0)
    errs = am.pop_errors()
    assert len(errs) == 1 and isinstance(errs[0], ZeroDivisionError)
    am.shut()
    return [type(e).__name__ for e in errs]


def async_sql_module(P):
    am = P.kernel.ActorModule(threads=2)
    db = P.kernel.AsyncSqlModule(am, P.sql.SqlModule())
    got = []
    db.updata("Player", "p1", ["Gold"], [7], cb=lambda ok: got.append(ok))
    am.drain_until(1)
    db.query("Player", "p1", ["Gold"], cb=lambda row: got.append(row))
    am.drain_until(1)
    assert got == [True, [7]]
    db.select("Player", "p1", cb=lambda row: got.append(row))
    db.exists("Player", "p1", cb=lambda ok: got.append(ok))
    db.keys("Player", cb=lambda keys: got.append(keys))
    am.drain_until(3)
    db.delete("Player", "p1", cb=lambda ok: got.append(ok))
    am.drain_until(1)
    db.exists("Player", "p1", cb=lambda ok: got.append(ok))
    am.drain_until(1)
    am.shut()
    return got


@pytest.mark.parametrize("case", [actor_offload_and_marshal_back,
                                  actor_message_ordering_per_mailbox,
                                  actor_errors_are_collected_not_raised, async_sql_module],
                         ids=lambda c: c.__name__)
def test_actor_case(case):
    """Each case on both packages: the same results reach the end
    functors on the draining thread, in mailbox order."""
    a = case(PKGS["noahgameframe_tpu"])
    b = case(PKGS["noahgameframe_tpu_torch"])
    assert a == b
