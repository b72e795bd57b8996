"""The port's frame observatory (noahgameframe_tpu_torch.telemetry.pipeline)
after tests/test_trace_codec.py, case for case: the trace codec fuzz (a
torn, oversized or version-skewed header raises TraceError), the stage
clock, clock-offset estimation and the multi-process trace merge."""

import random

import pytest

from noahgameframe_tpu_torch.telemetry.pipeline import (
    TRACE_SIZE,
    TRACE_VERSION,
    ClockSync,
    StageClock,
    TraceContext,
    TraceError,
    decode_trace,
    encode_trace,
    merge_chrome_traces,
)
from noahgameframe_tpu_torch.telemetry.registry import MetricsRegistry
from test_torch_parity import one_intra_op_thread  # noqa: F401


# ----------------------------------------------------------------- codec
class TestTraceCodec:
    def test_round_trip_all_fields(self):
        ctx = TraceContext(
            tick=(1 << 63) + 5, game_id=6, seq=0xFFFFFFFF,
            t_encode_ns=123456789, proxy_in_ns=1, proxy_out_ns=2,
            client_recv_ns=3, flags=0x7F,
        )
        buf = encode_trace(ctx)
        assert len(buf) == TRACE_SIZE
        assert decode_trace(buf) == ctx

    def test_every_truncation_fails_closed(self):
        buf = encode_trace(TraceContext(tick=1, game_id=2, seq=3,
                                        t_encode_ns=4))
        for n in range(TRACE_SIZE):
            with pytest.raises(TraceError):
                decode_trace(buf[:n])

    def test_oversize_fails_closed(self):
        buf = encode_trace(TraceContext(tick=1, game_id=2, seq=3,
                                        t_encode_ns=4))
        for extra in (1, 7, 64):
            with pytest.raises(TraceError):
                decode_trace(buf + bytes(extra))

    def test_unknown_version_fails_closed(self):
        buf = bytearray(encode_trace(
            TraceContext(tick=1, game_id=2, seq=3, t_encode_ns=4)))
        for v in range(256):
            if v == TRACE_VERSION:
                continue
            buf[0] = v
            with pytest.raises(TraceError):
                decode_trace(bytes(buf))

    def test_random_garbage_never_crashes(self):
        rng = random.Random(11)
        for _ in range(200):
            blob = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 2 * TRACE_SIZE)))
            try:
                decode_trace(blob)
            except TraceError:
                pass  # the only acceptable failure mode

    def test_body_bitflips_round_trip_or_fail_closed(self):
        # past the version byte every value is opaque payload: a flip
        # must still decode (to different stamps) or raise — no crash
        clean = encode_trace(TraceContext(tick=9, game_id=8, seq=7,
                                          t_encode_ns=6))
        rng = random.Random(5)
        for _ in range(64):
            buf = bytearray(clean)
            buf[rng.randrange(1, TRACE_SIZE)] ^= 1 << rng.randrange(8)
            try:
                decode_trace(bytes(buf))
            except TraceError:
                pass


# ------------------------------------------------------------ stage clock
class TestStageClock:
    def test_waterfall_sums_to_wall_exactly(self):
        sc = StageClock()
        sc.frame_begin(7)
        with sc.stage("tick"):
            pass
        with sc.stage("encode"):
            with sc.stage("send"):
                pass
        last = sc.frame_end()
        assert sc.last_tick == 7
        assert sum(last.values()) == sc.last_wall_ns
        assert "other" in last and last["other"] >= 0

    def test_nested_child_time_is_exclusive(self):
        import time

        sc = StageClock()
        sc.frame_begin(1)
        with sc.stage("encode"):
            with sc.stage("send"):
                time.sleep(0.02)
        sc.frame_end()
        # "send" held the sleep; "encode" keeps only its own bookkeeping
        assert sc.last["send"] >= 15_000_000
        assert sc.last["encode"] < sc.last["send"]

    def test_add_ns_charges_innermost_parent(self):
        sc = StageClock()
        sc.frame_begin(1)
        with sc.stage("encode"):
            sc.add_ns("send", 5_000_000)
        sc.frame_end()
        assert sc.last["send"] == 5_000_000
        # the manual charge was subtracted from the enclosing stage
        assert sc.last["encode"] < 5_000_000
        assert sum(sc.last.values()) == sc.last_wall_ns

    def test_histograms_and_stats(self):
        reg = MetricsRegistry()
        sc = StageClock(reg)
        for t in range(4):
            sc.frame_begin(t)
            with sc.stage("tick"):
                pass
            sc.frame_end()
        assert sc.frames == 4
        stats = sc.stats()
        assert "tick" in stats and "other" in stats
        assert set(stats["tick"]) == {"p50_ms", "p95_ms", "mean_ms"}
        assert "nf_stage_tick_seconds" in reg.exposition()


# ------------------------------------------------------------- clock sync
class TestClockSync:
    def test_min_filter_converges_on_offset_plus_min_delay(self):
        rng = random.Random(3)
        cs = ClockSync(window=64)
        offset, min_delay, max_delay = 5_000_000, 1_000, 900_000
        for i in range(64):
            sent = i * 10_000_000
            delay = rng.randrange(min_delay, max_delay)
            cs.update("game6", sent, sent + offset + delay)
        est = cs.offset_ns("game6")
        assert offset + min_delay <= est <= offset + max_delay
        # with enough samples the min filter sheds most of the jitter
        assert est < offset + max_delay // 2

    def test_negative_offsets_survive(self):
        cs = ClockSync()
        cs.update("proxy5", 1_000_000, 200_000)  # receiver clock behind
        assert cs.offset_ns("proxy5") == -800_000
        assert cs.offsets() == {"proxy5": -800_000}

    def test_window_slides(self):
        cs = ClockSync(window=4)
        for d in (50, 40, 30, 20, 10):
            cs.update("k", 0, d)
        assert cs.offset_ns("k") == 10
        for d in (100, 100, 100, 100):
            cs.update("k", 0, d)
        # the old minimum aged out of the 4-sample window
        assert cs.offset_ns("k") == 100

    def test_unknown_key(self):
        assert ClockSync().offset_ns("nope") is None


# ------------------------------------------------------------- trace merge
class TestChromeTraceMerge:
    @staticmethod
    def _doc(pid, ts):
        return {"traceEvents": [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"role{pid}"}},
            {"ph": "X", "pid": pid, "tid": 1, "name": "tick",
             "ts": ts, "dur": 5.0},
        ]}

    def test_merge_applies_offsets_and_keeps_pids(self):
        merged = merge_chrome_traces(
            [self._doc(1, 100.0), self._doc(2, 100.0)],
            offsets_us=[0.0, 250.0],
        )
        evs = merged["traceEvents"]
        assert merged["displayTimeUnit"] == "ms"
        assert {e["pid"] for e in evs} == {1, 2}
        xs = {e["pid"]: e["ts"] for e in evs if e["ph"] == "X"}
        assert xs == {1: 100.0, 2: 350.0}

    def test_metadata_events_never_shift(self):
        merged = merge_chrome_traces([self._doc(3, 10.0)],
                                     offsets_us=[999.0])
        meta = [e for e in merged["traceEvents"] if e["ph"] == "M"]
        assert meta and all("ts" not in e for e in meta)

    def test_merge_without_offsets(self):
        merged = merge_chrome_traces([self._doc(1, 7.0), self._doc(2, 8.0)])
        xs = sorted(e["ts"] for e in merged["traceEvents"]
                    if e["ph"] == "X")
        assert xs == [7.0, 8.0]

    def test_input_docs_not_mutated(self):
        doc = self._doc(1, 50.0)
        merge_chrome_traces([doc], offsets_us=[100.0])
        assert doc["traceEvents"][1]["ts"] == 50.0

    def test_span_tracer_round_trip_merge(self):
        from noahgameframe_tpu_torch.telemetry.tracing import SpanTracer

        a, b = SpanTracer(enabled=True), SpanTracer(enabled=True)
        with a.span("game.tick"):
            pass
        with b.span("proxy.relay"):
            pass
        off = (b.epoch_ns - a.epoch_ns) / 1e3  # same-clock alignment
        merged = merge_chrome_traces(
            [a.chrome_trace(pid=1), b.chrome_trace(pid=2)],
            offsets_us=[0.0, off],
        )
        names = {e["name"] for e in merged["traceEvents"]}
        assert {"game.tick", "proxy.relay"} <= names
        assert {e["pid"] for e in merged["traceEvents"]} == {1, 2}
