"""The port's net layer against the JAX package's: framing, the frame
decoder on torn and oversized input, the pure-Python transport over a
loopback socket, the dispatch table with its journal ``tap``, consistent
hashing, the SLG/shop wire families and the frame-trace codec.  Every
encoded byte must equal the JAX package's.
"""

from __future__ import annotations

import inspect
import time

import pytest

import noahgameframe_tpu.core.chash as jchash
import noahgameframe_tpu.net.framing as jframing
import noahgameframe_tpu.net.wire_families as jfam
import noahgameframe_tpu.telemetry.pipeline as jpipe
import noahgameframe_tpu_torch.core.chash as tchash
import noahgameframe_tpu_torch.net.framing as tframing
import noahgameframe_tpu_torch.net.module as tmodule
import noahgameframe_tpu_torch.net.transport as ttransport
import noahgameframe_tpu_torch.net.wire_families as tfam
import noahgameframe_tpu_torch.telemetry.pipeline as tpipe
from test_torch_parity import one_intra_op_thread  # noqa: F401


def test_framing_bytes_and_torn_stream_equal_jax():
    frames = [(7, b""), (300, b"x" * 5), (65535, bytes(range(256)) * 3)]
    blob = b"".join(tframing.pack_frame(m, b) for m, b in frames)
    assert blob == b"".join(jframing.pack_frame(m, b) for m, b in frames)
    assert tframing.unpack_head(blob) == jframing.unpack_head(blob)
    assert list(tframing.iter_frames(blob)) == frames
    # torn: the stream arrives in odd-sized pieces, both decoders agree
    dt, dj = tframing.FrameDecoder(), jframing.FrameDecoder()
    got_t, got_j = [], []
    for i in range(0, len(blob), 5):
        got_t += dt.feed(blob[i:i + 5])
        got_j += dj.feed(blob[i:i + 5])
        assert dt.pending() == dj.pending()
    assert got_t == got_j == frames
    with pytest.raises(tframing.ProtocolError):
        list(tframing.iter_frames(blob[:-1]))            # trailing bytes
    oversized = tframing._HEAD.pack(1, tframing.MAX_FRAME_SIZE + 1)
    with pytest.raises(tframing.ProtocolError):
        tframing.FrameDecoder().feed(oversized)
    with pytest.raises(tframing.ProtocolError):
        tframing.FrameDecoder().feed(tframing._HEAD.pack(1, 3))   # under a header
    with pytest.raises(jframing.ProtocolError):
        jframing.FrameDecoder().feed(oversized)


def test_py_transport_loopback_and_dispatch_tap():
    """A server and a client of the port's pure-Python transport over
    localhost: connect, one frame each way, and a dispatch table whose tap
    sees every event before its handler."""
    srv = tmodule.NetServerModule("127.0.0.1", 0, backend="py")
    cli = ttransport.create_client("127.0.0.1", srv.port, backend="py")
    got, tapped = [], []
    srv.dispatch.tap = lambda ev: tapped.append((ev.kind, ev.msg_id, ev.body))
    srv.on(42, lambda conn, mid, body: (got.append(body), srv.send_raw(conn, 43, body[::-1])))
    try:
        cli.connect()
        deadline = time.monotonic() + 5.0
        sent = False
        back = []
        while time.monotonic() < deadline and not back:
            srv.execute()
            for ev in cli.poll():
                if ev.kind == ttransport.EV_CONNECTED and not sent:
                    sent = cli.send_msg(42, b"hello")
                elif ev.kind == ttransport.EV_MSG:
                    back.append((ev.msg_id, ev.body))
            if not sent and cli.connected:
                sent = cli.send_msg(42, b"hello")
            time.sleep(0.005)
    finally:
        cli.disconnect()
        srv.shut()
    assert got == [b"hello"] and back == [(43, b"olleh")]
    assert (ttransport.EV_MSG, 42, b"hello") in tapped
    assert tapped.index((ttransport.EV_MSG, 42, b"hello")) >= 1   # after the connect
    assert srv.counters.in_msgs[42] == 1 and srv.counters.out_msgs[43] == 1


def test_dispatch_isolates_a_failing_handler():
    d = tmodule._Dispatch(tmodule.NetCounters())
    seen = []
    d.on(5, lambda c, m, b: 1 / 0)
    d.on(5, lambda c, m, b: seen.append(b))
    d.feed([ttransport.NetEvent(ttransport.EV_MSG, 1, 5, b"ok")])
    assert seen == [b"ok"]


def test_consistent_hash_placement_equals_jax():
    rj, rt = jchash.ConsistentHash(), tchash.ConsistentHash()
    for name in ("game6", "game7", "game8", "game9"):
        rj.add(name, name)
        rt.add(name, name)
    keys = [f"acct{i}" for i in range(500)]
    assert [rt.get(k) for k in keys] == [rj.get(k) for k in keys]
    rj.remove("game7")
    rt.remove("game7")
    assert [rt.get(k) for k in keys] == [rj.get(k) for k in keys]
    assert len(rt) == len(rj) and rt.get("acct0") in ("game6", "game8", "game9")


def _fill(cls, mod, depth=0):
    """An instance of a wire Message with every field set."""
    kw = {}
    for tag, name, ftype, _default in cls.FIELDS:
        rep = isinstance(ftype, tuple)
        inner = ftype[1] if rep else ftype
        if isinstance(inner, str):
            v = {"int32": -3 - tag, "int64": 1 << 40, "uint64": 7, "bool": True,
                 "enum": 2, "float": 1.5 + tag, "double": 2.25,
                 "bytes": b"b%d" % tag, "string": b"s%d" % tag}[inner]
        else:
            if depth > 2:
                continue
            v = _fill(getattr(mod, inner.__name__) if hasattr(mod, inner.__name__)
                      else inner, mod, depth + 1)
        kw[name] = [v, v] if rep else v
    return cls(**kw)


def _messages(mod):
    return sorted(n for n, c in inspect.getmembers(mod, inspect.isclass)
                  if c.__module__ == mod.__name__ and hasattr(c, "FIELDS"))


def test_wire_families_round_trip_equal_jax():
    names = _messages(tfam)
    assert names == _messages(jfam) and len(names) >= 15
    for n in names:
        msg_t = _fill(getattr(tfam, n), tfam)
        msg_j = _fill(getattr(jfam, n), jfam)
        bt, bj = msg_t.encode(), msg_j.encode()
        assert bt == bj, n
        assert getattr(tfam, n).decode(bt).encode() == bt, n
    assert [int(x) for x in tfam.SLGFuncType] == [int(x) for x in jfam.SLGFuncType]


def test_trace_codec_equals_jax():
    ctx = dict(tick=123456789012, game_id=6, seq=0xFFFFFFFF, t_encode_ns=(1 << 63) + 5,
               proxy_in_ns=11, proxy_out_ns=22, client_recv_ns=33, flags=1)
    bt = tpipe.encode_trace(tpipe.TraceContext(**ctx))
    assert bt == jpipe.encode_trace(jpipe.TraceContext(**ctx))
    assert len(bt) == tpipe.TRACE_SIZE == 52
    assert tpipe.decode_trace(bt) == tpipe.TraceContext(**ctx)
    for bad in (bt[:-1], bt + b"\0", b"\x09" + bt[1:]):
        with pytest.raises(tpipe.TraceError):
            tpipe.decode_trace(bad)
