"""Supervised session failover and fault injection: the port against the
JAX package.

tests/test_failover.py's stack, bottom up, each case run through both
packages with the results held equal: the proxy's ``ParkingBuffer``
(overflow and deadline drops, partial replay, disconnect discard, its
counters); the world's ``FailoverDriver`` under a fake clock and fake
roles (the staged DATA and REQ frames byte-equal to JAX's, BUSY, refusal
re-placement, a duplicate ack, the deadline); the game's switch-in
refusals (a torn blob, capacity, a duplicate REQ and ack) on offline
roles; the ``ChaosDirector``'s decisions on seeds 0-2 over one fixed
event trace (every link and store fault kind), equal event for event;
the heal flip; and, on the port alone, scripts/failover_smoke.run's
scenario at its own size with its checks (``chip_smoke.failover_kill``).
"""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import pytest

import chip_smoke as cs
import noahgameframe_tpu.net.chaos as jchaos
import noahgameframe_tpu.net.defines as jdefines
import noahgameframe_tpu.net.failover as jfo
import noahgameframe_tpu.net.transport as jtr
import noahgameframe_tpu.net.wire as jwire
import noahgameframe_tpu.telemetry.registry as jreg
import noahgameframe_tpu_torch.net.chaos as tchaos
import noahgameframe_tpu_torch.net.defines as tdefines
import noahgameframe_tpu_torch.net.failover as tfo
import noahgameframe_tpu_torch.net.transport as ttr
import noahgameframe_tpu_torch.net.wire as twire
import noahgameframe_tpu_torch.telemetry.registry as treg

PKGS = {
    "jax": SimpleNamespace(name="noahgameframe_tpu", fo=jfo, chaos=jchaos, defines=jdefines,
                           tr=jtr, wire=jwire, reg=jreg),
    "port": SimpleNamespace(name="noahgameframe_tpu_torch", fo=tfo, chaos=tchaos,
                            defines=tdefines, tr=ttr, wire=twire, reg=treg),
}


def both(fn):
    """``fn(pkg)`` for each package; the port's result must equal JAX's."""
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# --------------------------------------------------------------- parking


def test_parking_overflow_drops_oldest():
    def run(p):
        pb = p.fo.ParkingBuffer(max_frames=3, deadline_s=60.0)
        dropped = sum(pb.park("c1", 100 + i, bytes([i]), now=float(i)) for i in range(5))
        out = []
        pb.replay("c1", lambda mid, body: out.append((mid, body)) or True)
        return dropped, pb.dropped_overflow, out

    dropped, overflow, out = both(run)
    assert (dropped, overflow) == (2, 2)
    assert out == [(102, b"\x02"), (103, b"\x03"), (104, b"\x04")]


def test_parking_deadline_drop_is_per_frame_age():
    def run(p):
        pb = p.fo.ParkingBuffer(max_frames=16, deadline_s=10.0)
        pb.park("c1", 1, b"a", now=0.0)
        pb.park("c1", 2, b"b", now=5.0)
        seq = [pb.expire(now=9.9), pb.expire(now=10.0), pb.depth("c1"), pb.expire(now=15.0)]
        return seq, pb.dropped_deadline, pb.depth(), pb.keys()

    assert both(run) == ([0, 1, 1, 1], 2, 0, [])


def test_parking_replay_stops_at_failed_send_then_resumes():
    def run(p):
        pb = p.fo.ParkingBuffer(max_frames=16, deadline_s=60.0)
        for i in range(4):
            pb.park("c1", 200 + i, bytes([i]), now=0.0)
        sent = []

        def flaky(mid, _body):
            if len(sent) >= 2:
                return False
            sent.append(mid)
            return True

        first = pb.replay("c1", flaky)
        depth = pb.depth("c1")
        second = pb.replay("c1", lambda mid, _b: sent.append(mid) or True)
        return first, depth, second, sent, pb.replayed_total, pb.dropped_total, pb.order_violations

    assert both(run) == ((2, False), 2, (2, True), [200, 201, 202, 203], 4, 0, 0)


def test_parking_discard_and_counters():
    def run(p):
        reg = p.reg.MetricsRegistry()
        pb = p.fo.ParkingBuffer(max_frames=2, deadline_s=10.0, registry=reg)
        for _ in range(4):
            pb.park("c1", 0, b"x", now=0.0)
        pb.park("c2", 9, b"y", now=0.0)
        disc = pb.discard("c1")
        pb.expire(now=10.0)
        return (disc, pb.dropped_overflow, pb.dropped_disconnect, pb.dropped_deadline,
                pb.dropped_total, reg.value("nf_failover_parked_frames_total"),
                [reg.value("nf_failover_dropped_total", reason=r)
                 for r in ("overflow", "disconnect", "deadline")],
                [ln for ln in reg.exposition().splitlines() if "failover" in ln])

    out = both(run)
    assert out[:6] == (2, 2, 2, 1, 5, 5.0) and out[6] == [2.0, 2.0, 1.0]


def test_parking_knobs_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("NF_PARK_MAX_FRAMES", "7")
    monkeypatch.setenv("NF_FAILOVER_DEADLINE_S", "2.5")

    def run(p):
        pb = p.fo.ParkingBuffer()
        world = _FakeWorld(p, {})
        return pb.max_frames, pb.deadline_s, p.fo.FailoverDriver(world).deadline_s

    assert both(run) == (7, 2.5, 2.5)
    monkeypatch.setenv("NF_PARK_MAX_FRAMES", "lots")
    monkeypatch.setenv("NF_FAILOVER_DEADLINE_S", "soon")
    assert both(lambda p: (p.fo.ParkingBuffer().max_frames,
                           p.fo.ParkingBuffer().deadline_s)) == (256, 10.0)


# ---------------------------------------------------------------- driver


def _fake_game(p, conn_id, cur=0, cap=8, state=None):
    state = p.defines.ServerState.NORMAL if state is None else state
    return SimpleNamespace(conn_id=conn_id, report=SimpleNamespace(
        server_state=int(state), server_cur_count=int(cur), server_max_online=int(cap)))


class _FakeWorld:
    def __init__(self, p, games):
        self.games = games
        self.telemetry = SimpleNamespace(registry=p.reg.MetricsRegistry())
        self.sent = []
        self.server = SimpleNamespace(
            send_raw=lambda conn, mid, body: (self.sent.append((conn, mid, bytes(body))), True)[1])


def _info(p, selfid=(1, 100), game_id=6, save_key=""):
    return p.fo.SessionInfo(selfid=selfid, account="ada", name="Ada", client_id=(5, 7),
                            scene_id=1, group_id=1, save_key=save_key, game_id=game_id)


def test_driver_stages_data_then_req_and_consumes_ack_once():
    def run(p):
        world = _FakeWorld(p, {16: _fake_game(p, conn_id=42)})
        drv = p.fo.FailoverDriver(world)
        drv.game_died(6, [_info(p)], None, None, now=0.0)
        pending = drv.pending_count()
        ack = p.wire.AckSwitchServer(selfid=p.wire.Ident(svrid=1, index=100),
                                     self_serverid=6, target_serverid=16)
        first, second = drv.on_ack(ack), drv.on_ack(ack)
        reg = world.telemetry.registry
        return (world.sent, pending, first, second, drv.completed,
                reg.value("nf_failover_initiated_total"),
                reg.value("nf_failover_completed_total"))

    sent, pending, first, second, completed, init, comp = both(run)
    MsgID = tdefines.MsgID
    assert [(c, m) for c, m, _ in sent] == [(42, int(MsgID.SWITCH_SERVER_DATA)),
                                            (42, int(MsgID.REQ_SWITCH_SERVER))]
    assert (pending, first, second, init, comp) == (1, True, False, 1.0, 1.0)
    assert completed[-1]["to"] == 16


def test_driver_blob_basis_falls_back_to_the_store():
    """With no WAL, a session's blob comes from the recovery store (basis
    "store", framed by the row-blob CRC); a key the store lacks, or no
    key, re-homes with an empty blob (basis "none")."""
    def run(p):
        from noahgameframe_tpu_torch.persist.kv import MemoryKV

        store = MemoryKV()
        store.set("k:store", b"from-the-store")
        world = _FakeWorld(p, {16: _fake_game(p, conn_id=42)})
        drv = p.fo.FailoverDriver(world, recover_store=store)
        infos = [_info(p, (1, 100 + i), save_key=k)
                 for i, k in enumerate(("k:store", "k:none", ""))]
        drv.game_died(6, infos, None, None, now=0.0)
        return world.sent, sorted((k, v.basis) for k, v in drv._pending.items()), drv.last_basis

    sent, bases, last = both(run)
    assert bases == [((1, 100), "store"), ((1, 101), "none"), ((1, 102), "none")]
    assert len(sent) == 6 and last["sessions"] == 3


def test_driver_busy_when_no_survivor_then_places_on_free_capacity():
    def run(p):
        world = _FakeWorld(p, {16: _fake_game(p, conn_id=42, cur=8, cap=8)})
        drv = p.fo.FailoverDriver(world, retry_s=0.5)
        drv.game_died(6, [_info(p)], None, None, now=0.0)
        before = list(world.sent)
        busy = world.telemetry.registry.value("nf_failover_busy_total")
        world.games[16].report.server_cur_count = 7
        drv.execute(now=1.0)
        return before, busy, [m for _, m, _ in world.sent], drv.pending_count()

    before, busy, mids, pending = both(run)
    assert before == [] and busy >= 1.0 and pending == 1
    assert mids == [int(tdefines.MsgID.SWITCH_SERVER_DATA), int(tdefines.MsgID.REQ_SWITCH_SERVER)]


def test_driver_refusal_excludes_target_and_retries_elsewhere():
    def run(p):
        world = _FakeWorld(p, {16: _fake_game(p, conn_id=42, cur=0),
                               26: _fake_game(p, conn_id=43, cur=5)})
        drv = p.fo.FailoverDriver(world, deadline_s=3600.0)
        drv.game_died(6, [_info(p)], None, None, now=time.monotonic())
        first = world.sent[0][0]
        world.sent.clear()
        refused = p.wire.SwitchRefused(selfid=p.wire.Ident(svrid=1, index=100),
                                       self_serverid=6, target_serverid=16,
                                       result=p.fo.REFUSE_BUSY)
        took = drv.on_refused(refused)
        drv.execute(now=time.monotonic() + 0.01)
        return first, took, drv.pending_count(), world.sent

    first, took, pending, sent = both(run)
    assert (first, took, pending) == (42, True, 1) and sent and sent[0][0] == 43


def test_driver_gives_up_at_deadline():
    def run(p):
        world = _FakeWorld(p, {16: _fake_game(p, conn_id=42, cur=8, cap=8)})
        drv = p.fo.FailoverDriver(world, deadline_s=1.0)
        drv.game_died(6, [_info(p)], None, None, now=0.0)
        lag = drv.lag(0.5)
        drv.execute(now=2.0)
        reg = world.telemetry.registry
        return (lag, drv.pending_count(), reg.value("nf_failover_deadline_exceeded_total"),
                reg.value("nf_failover_pending"))

    assert both(run) == (0.5, 0, 1.0, 0.0)


def test_ext_map_reads_report_ext():
    def run(p):
        ext = p.wire.ServerInfoExt(key=[b"wal_dir", b"n"], value=[b"/w", b"3"])
        return (p.fo.ext_map(SimpleNamespace(server_info_list_ext=ext)),
                p.fo.ext_map(SimpleNamespace(server_info_list_ext=None)), p.fo.ext_map(object()))

    assert both(run) == ({"wal_dir": "/w", "n": "3"}, {}, {})


# ----------------------------------------------------- game switch-in


def _offline_role(name):
    P = cs.cluster_package(name)
    kw = {"device": "cpu"} if name.endswith("torch") else {}
    w = P.world.GameWorld(P.world.WorldConfig(combat=False, movement=False, regen=True,
                                              middleware=False), **kw).start()
    w.kernel.store.guids.pin(3_000_000)
    rep = importlib.import_module(f"{name}.replay.replayer")
    role = rep.make_offline_role(w, backend="py", **kw)
    sent = []
    role.world_link.send_to_all = lambda mid, body: sent.append((int(mid), bytes(body))) or True
    return role, sent


@pytest.fixture(scope="module")
def offline_roles():
    roles = {"jax": _offline_role("noahgameframe_tpu"),
             "port": _offline_role("noahgameframe_tpu_torch")}
    yield roles
    for role, _sent in roles.values():
        role.shut()


def _switch_msgs(p, selfid, target, client=None):
    w = p.wire
    data = w.SwitchServerData(selfid=selfid, account=b"ada", name=b"Ada", blob=b"",
                              target_serverid=int(target))
    req = w.ReqSwitchServer(selfid=selfid, self_serverid=99, target_serverid=int(target),
                            gate_serverid=0, scene_id=1,
                            client_id=client or w.Ident(svrid=5, index=7), group_id=1)
    return data, req


def test_switch_in_refuses_torn_blob(offline_roles):
    out = {}
    for name, (role, sent) in offline_roles.items():
        p = PKGS[name]
        sent.clear()
        data, req = _switch_msgs(p, p.wire.Ident(svrid=9, index=1111), role.config.server_id)
        data.blob = b"\xff\xfe\xfd not a snapshot \x00\x01"
        before = role.kernel.store.live_count("Player")
        role._on_switch_data(0, int(p.defines.MsgID.SWITCH_SERVER_DATA), p.wire.wrap(data))
        role._on_switch_in(0, int(p.defines.MsgID.REQ_SWITCH_SERVER), p.wire.wrap(req))
        out[name] = (list(sent), role.kernel.store.live_count("Player") - before)
    assert out["port"] == out["jax"]
    sent, grown = out["port"]
    refusals = [b for m, b in sent if m == int(tdefines.MsgID.ACK_SWITCH_REFUSED)]
    assert len(refusals) == 1 and grown == 0
    _, msg = twire.unwrap(refusals[0], twire.SwitchRefused)
    assert int(msg.result) == tfo.REFUSE_BAD_BLOB


def test_switch_in_refuses_at_capacity(offline_roles):
    out = {}
    for name, (role, sent) in offline_roles.items():
        p = PKGS[name]
        sent.clear()
        store = role.kernel.store
        cap = store.capacity("Player")
        store.live_count = lambda cname, cap=cap: cap  # the store reads full
        try:
            data, req = _switch_msgs(p, p.wire.Ident(svrid=9, index=2222), role.config.server_id,
                                     client=p.wire.Ident(svrid=5, index=8))
            role._on_switch_data(0, int(p.defines.MsgID.SWITCH_SERVER_DATA), p.wire.wrap(data))
            role._on_switch_in(0, int(p.defines.MsgID.REQ_SWITCH_SERVER), p.wire.wrap(req))
        finally:
            del store.live_count
        out[name] = list(sent)
    assert out["port"] == out["jax"]
    refusals = [b for m, b in out["port"] if m == int(tdefines.MsgID.ACK_SWITCH_REFUSED)]
    assert len(refusals) == 1
    assert int(twire.unwrap(refusals[0], twire.SwitchRefused)[1].result) == tfo.REFUSE_BUSY


def test_switch_in_admits_then_tolerates_duplicate_req_and_ack(offline_roles):
    out = {}
    for name, (role, sent) in offline_roles.items():
        p = PKGS[name]
        MsgID, w = p.defines.MsgID, p.wire
        sent.clear()
        client = w.Ident(svrid=5, index=9)
        data, req = _switch_msgs(p, w.Ident(svrid=9, index=3333), role.config.server_id,
                                 client=client)
        before = role.kernel.store.live_count("Player")
        role._on_switch_data(0, int(MsgID.SWITCH_SERVER_DATA), w.wrap(data))
        role._on_switch_in(0, int(MsgID.REQ_SWITCH_SERVER), w.wrap(req))
        trace = [len(sent), role.kernel.store.live_count("Player") - before]
        guid = role.sessions[w.ident_key(client)].guid
        role._on_switch_in(0, int(MsgID.REQ_SWITCH_SERVER), w.wrap(req))
        trace += [len(sent), role.kernel.store.live_count("Player") - before]
        ack = w.AckSwitchServer(selfid=w.Ident(svrid=guid.head, index=guid.data),
                                self_serverid=role.config.server_id, target_serverid=77)
        role._on_switch_ack(0, int(MsgID.ACK_SWITCH_SERVER), w.wrap(ack))
        trace += [guid in role.kernel.store.guid_map,
                  role.sessions.get(w.ident_key(client)) is None]
        role._on_switch_ack(0, int(MsgID.ACK_SWITCH_SERVER), w.wrap(ack))
        trace += [guid in role.kernel.store.guid_map, (guid.head, guid.data)]
        out[name] = (trace, list(sent))
    assert out["port"] == out["jax"]
    trace, sent = out["port"]
    assert trace[1] == 1 and trace[3] == 1 and trace[4:7] == [False, True, False]
    assert [m for m, _ in sent].count(int(tdefines.MsgID.ACK_SWITCH_SERVER)) == 2


# ----------------------------------------------------------------- chaos


class _Inner:
    """A transport that delivers whatever the wrapper hands it and polls a
    scripted event list, one batch a poll."""

    def __init__(self, tr, batches):
        self.tr, self.batches, self.out = tr, list(batches), []

    def send_msg(self, mid, body):
        self.out.append(("msg", mid, bytes(body)))
        return True

    def send(self, conn, mid, body):
        self.out.append(("send", conn, mid, bytes(body)))
        return True

    def disconnect(self):
        self.out.append(("disconnect",))

    def poll(self):
        batch = self.batches.pop(0) if self.batches else []
        tr = self.tr
        return [tr.NetEvent(k, c, m, b) if k == tr.EV_MSG else tr.NetEvent(k, c)
                for k, c, m, b in batch]


def _trace(tr, polls=60):
    """A fixed event trace: connects, messages of varied lengths."""
    batches = []
    for t in range(polls):
        batch = []
        if t % 17 == 0:
            batch.append((tr.EV_CONNECTED, t, 0, b""))
        for j in range(t % 4):
            batch.append((tr.EV_MSG, 3, 100 + j, bytes((t * 7 + j * 13 + i) % 256
                                                      for i in range(1 + (t + j) % 9))))
        batches.append(batch)
    return batches


def _plan(p, seed):
    ch = p.chaos
    return ch.FaultPlan(seed=seed, links={
        "proxy5.games": ch.LinkFaults(drop=0.1, dup=0.1, delay=0.15, delay_polls=3,
                                      truncate=0.1, corrupt=0.1,
                                      partitions=((20, 26, "in"), (40, 44, "both"))),
        "game6.world": ch.LinkFaults(refuse=0.3, refuse_first=1, drop=0.05),
    }, stores={"game6.store": ch.StoreFaults(fail=0.3, fail_first=2, down=((6, 9),))})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_decisions_equal_jax(seed):
    def run(p):
        director = p.chaos.ChaosDirector(_plan(p, seed))
        results = {}
        for link in ("proxy5.games->6", "game6.world->7", "login4.master->1"):
            inner = _Inner(p.tr, _trace(p.tr))
            w = director.wrap(inner, link)
            polled = []
            for t in range(60):
                if t % 3 == 0:
                    w.send_msg(200 + t, bytes(range(t % 11 + 1)))
                if t % 5 == 0:
                    w.send(9, 300 + t, b"ab" * (t % 6 + 1))
                polled += [(ev.kind, ev.conn_id, ev.msg_id, bytes(ev.body)) for ev in w.poll()]
            results[link] = (polled, inner.out)
        store_ops = []
        backend = SimpleNamespace(write=lambda k, b: store_ops.append(("w", k, b)),
                                  delete=lambda k: store_ops.append(("d", k)), ping=lambda: True)
        s = director.wrap_store(backend, "game6.store")
        outcomes = []
        for i in range(16):
            try:
                (s.write if i % 3 else s.delete)(*((f"k{i}", b"v") if i % 3 else (f"k{i}",)))
                outcomes.append("ok")
            except p.chaos.StoreFaultError:
                outcomes.append("fault")
        status = director.status()
        return results, store_ops, outcomes, director.logs, director.counts, status

    out = both(run)
    counts = out[4]
    kinds = {k for c in counts.values() for k in c}
    assert {"drop_out", "dup_out", "delay_out", "corrupt", "refuse", "partition_in",
            "store_fail", "store_down"} <= kinds


def test_chaos_heal_flips_live_wrappers_and_future_dials():
    def run(p):
        ch = p.chaos
        director = ch.ChaosDirector(ch.FaultPlan(
            seed=3, links={"proxy5.games": ch.LinkFaults(drop=1.0)},
            stores={"game6.store": ch.StoreFaults(fail_first=3)}))
        w = director.wrap(SimpleNamespace(), "proxy5.games->6")
        s = director.wrap_store(SimpleNamespace(), "game6.store")
        again = director.wrap_store(s, "game6.store")  # re-wrap unnests
        seq = [w.faults.drop, again.inner is s.inner, director.heal("proxy5.games"),
               w.faults.drop, director.heal("proxy5.games")]
        w2 = director.wrap(SimpleNamespace(), "proxy5.games->6")
        seq += [w2.faults.drop, "proxy5.games->6" in director.counts, director.heal(),
                s.faults.any(), director.total()]
        armed = director.set_link_faults("proxy5", ch.LinkFaults(dup=0.5))
        stores = director.set_store_faults("game6", ch.StoreFaults(latency=0.5))
        seq += [armed, stores, w.faults.dup, director.store_phase()]
        return seq

    seq = both(run)
    assert seq[:9] == [1.0, True, 1, 0.0, 0, 0.0, True, 1, False]
    assert seq[10:13] == [1, 1, 0.5]


def test_chaos_samples_equal_jax():
    """``TelemetryModule.add_chaos_source``: the ``nf_chaos_faults_total``
    samples of a role's links, in order and with JAX's labels."""
    import noahgameframe_tpu.telemetry.module as jtm
    import noahgameframe_tpu_torch.telemetry.module as ttm

    def run(p, tm):
        director = p.chaos.ChaosDirector(_plan(p, 1))
        for link in ("game6.world->7", "proxy5.games->6", "game6.store"):
            w = director.wrap(_Inner(p.tr, _trace(p.tr, 30)), link)
            for t in range(30):
                w.send_msg(1, b"xyz" * (t % 5 + 1))
                w.poll()
        tel = tm.TelemetryModule()
        tel.add_chaos_source(director, prefix="game6.")
        lines = [ln for ln in tel.registry.exposition().splitlines()
                 if ln.startswith("nf_chaos_faults_total")]
        return lines, list(tel._chaos_samples())

    port = run(PKGS["port"], ttm)
    ref = run(PKGS["jax"], jtm)
    assert port == ref
    assert port[0] and all('link="game6.' in ln for ln in port[0])


# ------------------------------------------------------------------ e2e


def test_failover_smoke_scenario(tmp_path):
    """scripts/failover_smoke.run on a port cluster (CPU worlds): two
    clients on Game1 under the fault plan, a wedged store, a hard kill
    mid-combat, and every check of the smoke."""
    P = cs.cluster_package()
    kv = P.persist.MemoryKV()
    per_game = {name: {"data_agent": P.persist.PlayerDataAgent(kv), "persist_store": kv,
                       "persist_wal_dir": tmp_path / f"wal{i}",
                       "checkpoint_dir": tmp_path / f"ckpt{i}"}
                for i, name in ((1, "Game1"), (2, "Game2"))}
    # the kill is seen by the dropped socket; leases wider than the smoke's
    # 1 s / 2 s keep a loaded test machine's pump stalls from expiring
    # a healthy role
    c = P.roles.LocalCluster(backend="py", http_port=0, n_games=2, lease_suspect_seconds=3.0,
                             lease_down_seconds=6.0, device="cpu",
                             game_kwargs={"autosave_seconds": 3600.0,
                                          "checkpoint_seconds": 3600.0,
                                          "persist_drain_timeout": 0.3},
                             game_kwargs_by_name=per_game, world_kwargs={"recover_store": kv})
    try:
        c.start(timeout=60.0)
        c.apply_chaos(cs.failover_plan(P, 7))
        game1, game2 = c.games
        d = cs.ClusterDriver(P, c, timeout=60.0)
        d.login_all([("ada", "Ada", 6), ("bob", "Bob", 6)])
        ada, bob = d.clients["ada"], d.clients["bob"]
        ada.move_to(40.0, 50.0)
        bob.move_to(45.0, 80.0)
        ada.chat("warm-a")
        bob.chat("warm-b")
        d.wait(lambda: any(t == "warm-a" for _w, t in ada.chat_log)
               and any(t == "warm-b" for _w, t in bob.chat_log), "the pre-kill chats")
        checks, info = cs.failover_kill(d, game1, game2, [ada, bob], kv, tmp_path / "wal1")
    finally:
        c.shut()
    failed = [k for k, ok in checks.items() if not ok]
    assert not failed, f"failover checks failed: {failed} ({info})"
    assert info["sessions"] == 2 and info["bases"] == ["wal"] and info["blip_ms"] > 0


def test_world_rehomes_a_switched_players_stale_bind_like_jax():
    """A fault of the reference, kept by the port: the origin of a switch
    destroys the player's object without an offline notice, so the
    world keeps its bind info under the old guid with the origin's id.
    When the origin then dies, the world re-homes that stale session (a
    ghost) beside the real orphans, onto the game the player already
    lives on.  Both packages stage the same frames."""
    def run(p):
        from noahgameframe_tpu_torch.net.defines import ServerType

        roles = importlib.import_module(f"{p.name}.net.roles.world")
        base = importlib.import_module(f"{p.name}.net.roles.base")
        w, M = p.wire, p.defines.MsgID
        world = roles.WorldRole(base.RoleConfig(7, int(ServerType.WORLD), "World1",
                                                "127.0.0.1", 0, targets=[]), backend="py")
        sent = []
        world.server.send_raw = lambda conn, mid, body: sent.append((conn, mid, bytes(body))) or True
        try:
            for conn, sid in ((1, 6), (2, 16)):
                rep = w.ServerInfoReport(server_id=sid, server_type=int(ServerType.GAME),
                                         server_max_online=8, server_state=1)
                world._on_game_register(conn, int(M.GTW_GAME_REGISTERED),
                                        w.wrap(w.ServerInfoReportList(server_list=[rep])))

            def online(conn, ident, game):
                world._on_cross_sync(conn, int(M.ACK_ONLINE_NOTIFY),
                                     w.wrap(w.RoleOfflineNotify(), player_id=ident))
                world._on_session_bind(conn, int(M.SESSION_BIND_NOTIFY), w.wrap(
                    w.SessionBindNotify(selfid=ident, account=b"mover", name=b"Mover",
                                        client_id=w.Ident(svrid=5, index=9), scene_id=1,
                                        group_id=1, save_key=b"", game_id=game)))

            x, y, z = (w.Ident(svrid=1, index=i) for i in (100, 200, 300))
            online(1, x, 6)      # the mover, on game 6
            online(1, z, 6)      # a player who stays on game 6
            ack = w.AckSwitchServer(selfid=x, self_serverid=6, target_serverid=16)
            world._on_switch_relay(2, int(M.ACK_SWITCH_SERVER), w.wrap(ack))
            online(2, y, 16)     # the mover again, under its new guid on game 16
            world._on_socket(1, p.tr.EV_DISCONNECTED)  # game 6 dies
            return (sorted(world.failover._pending), sorted(world.sessions), sent,
                    world.failover.last_basis)
        finally:
            world.shut()

    pending, bound, sent, basis = both(run)
    assert pending == [(1, 100), (1, 300)]  # the ghost (1, 100) and the orphan
    assert bound == [(1, 200)]
    assert basis["sessions"] == 2
