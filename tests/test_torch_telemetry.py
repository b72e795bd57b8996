"""The port's telemetry (noahgameframe_tpu_torch/telemetry, utils/metrics)
against the JAX package's: the same updates give byte-equal exposition
text and equal percentiles; the span tracer exports a valid Chrome trace
and the tick's phases run under profiler ranges; a world's counter-bank
lines equal the JAX world's after the same ticks; and the cost book
records its entries and attributes every re-capture to a sanctioned
generation bump.  ``cost_samples`` and ``roofline_fold`` equal JAX's on
forged entries; the cost gauges and ``nf_pallas_fallback_total`` are on
``/metrics``; ``profiler_trace`` writes a Chrome trace."""

import json

import numpy as np
import pytest

from noahgameframe_tpu.game.world import build_benchmark_world as jax_world
from noahgameframe_tpu.telemetry import registry as jreg
from noahgameframe_tpu_torch.game.world import build_benchmark_world as torch_world
from noahgameframe_tpu_torch.telemetry import registry as treg
from noahgameframe_tpu_torch.telemetry.tracing import SpanTracer
from noahgameframe_tpu_torch.utils.metrics import MemoryCensus, TickMetrics
from test_torch_parity import one_intra_op_thread  # noqa: F401


def _drive(mod):
    """The same updates on a registry of either package."""
    reg = mod.MetricsRegistry()
    c = reg.counter("t_msgs_total", "messages", ("op", "dir"))
    c.inc(op="1", dir="in")
    c.inc(2.5, op="2", dir='o"u\nt\\')
    reg.counter("t_plain_total", "no labels")
    g = reg.gauge("t_depth", "a gauge")
    g.set(7)
    g.inc(-2.25)
    reg.gauge("t_fn", "callback gauge").set_function(lambda: 3)
    h = reg.histogram("t_lat_seconds", "latency", buckets=(0.001, 0.01, 0.1), window=16)
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.02, 40):
        h.observe(float(v))
    h.observe(50.0)  # beyond every bucket
    reg.register_callback("t_cb", lambda: [({"k": "a"}, 1.5), ({"k": "b"}, 2)],
                          kind="counter", help="callback")
    reg.register_callback("t_dead", lambda: 1 / 0, help="a dead source")
    return reg, h


def test_exposition_byte_equal_to_jax():
    (a, ha), (b, hb) = _drive(jreg), _drive(treg)
    assert b.exposition() == a.exposition()
    for p in (0, 12.5, 50, 95, 99, 100):
        assert hb.percentile(p) == ha.percentile(p)
    assert hb.window_mean() == ha.window_mean()
    assert b.value("t_cb", k="b") == a.value("t_cb", k="b") == 2.0
    assert treg.escape_label_value('a\\b\n"c"') == jreg.escape_label_value('a\\b\n"c"')


def test_chrome_trace_export(tmp_path):
    tr = SpanTracer(capacity=64, enabled=True)
    with tr.span("outer", tick=1):
        with tr.span("inner"):
            pass
    tr.instant("marker")
    assert tr.export(tmp_path / "trace.json") == 3
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner"}
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)
    assert any(e["ph"] == "i" and e["name"] == "marker" for e in evs)
    off = SpanTracer(enabled=False)
    with off.span("x"):
        pass
    assert len(off) == 0


def test_tick_spans_and_profiler_ranges():
    """With the world's tracer on, a tick records its host spans; under
    torch.profiler every phase of the step shows as a named range."""
    from torch.profiler import ProfilerActivity, profile

    w = torch_world(128, seed=2, device="cpu")
    w.telemetry.tracer.enabled = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w.tick()
    names = {e[0] for e in w.telemetry.tracer.events()}
    assert {"kernel.dispatch", "kernel.summary_fetch", "kernel.post_tick"} <= names
    keys = {e.key for e in prof.key_averages()}
    assert {"nf.schedule", "nf.phase.CombatModule.aoe", "nf.diff"} <= keys


def test_counter_bank_lines_equal_jax():
    """After 12 observed ticks, the TelemetryModule's counter-bank lines
    (cumulative and last-tick) are the JAX world's, byte for byte."""
    a, b = jax_world(256, seed=6), torch_world(256, seed=6, device="cpu")
    for _ in range(12):
        a.tick()
        b.tick()

    def bank(text):
        return [ln for ln in text.splitlines() if ln.startswith("nf_tick_counters")]

    got, want = bank(b.telemetry.exposition()), bank(a.telemetry.exposition())
    assert got == want and len(got) > 10
    assert b.kernel.counter_totals == a.kernel.counter_totals


def test_costbook_attributes_every_recapture():
    """Entries are recorded per entry point; invalidate() and a new train
    length are generation bumps, so the re-captures they cause are
    explained; causes are diffed against the previous signature."""
    w = torch_world(128, seed=3, device="cpu")
    k = w.kernel
    book = k.costbook
    k.tick()
    k.configure_train(2)
    k.train(2)
    mark = book.mark()
    k.configure_train(3)
    k.train(3)
    k.invalidate()
    k.tick()
    k.enable_digest()
    k.tick()
    assert book.unexplained_since(mark) == []
    assert [g["cause"] for g in book.gen_events if g["seq"] >= mark["seq"]] == \
        ["train_k:3", "invalidate", "invalidate"]
    assert book.entries["kernel.step"].causes == {"rewrap": 1, "static:digest": 1}
    assert book.entries["kernel.train"].causes == {"static:train_k": 1}
    assert book.entries["kernel.train"].replays == 2
    snap = book.snapshot()
    assert snap["compiles"] == 5 and snap["recompiles"] == 3
    assert set(snap["entries"]) == {"kernel.step", "kernel.train"}
    text = w.telemetry.exposition()
    assert 'nf_recompiles_total{cause="rewrap",entry="kernel.step"} 1' in text
    assert 'nf_compiles_total{entry="kernel.train"} 2' in text
    assert book.summary()["entries"]["kernel.step"]["c"] == 3
    # an unsanctioned miss: the signature changes with no bump
    mark = book.mark()
    k.state = k.state.replace(aux={**k.state.aux, "extra": k.state.tick.clone()})
    k.tick()
    assert [r["cause"] for r in book.unexplained_since(mark)] == ["tree-structure"]


def test_tick_metrics_and_census():
    m = TickMetrics(window=8)
    for _ in range(3):
        with m.frame():
            pass
    p = m.percentiles()
    assert p["p50_ms"] == pytest.approx(m.hist.percentile(50) * 1e3)
    assert p["mean_ms"] == pytest.approx(m.hist.window_mean() * 1e3)
    w = torch_world(128, seed=3, device="cpu")
    c = MemoryCensus()
    c.kernel = w.kernel
    c.register_probe("bad", lambda: 1 / 0)
    assert c.census()["entity:NPC"] == 128 and c.census()["bad"] == -1
    state_bytes = sum(cs.i32.nbytes + cs.f32.nbytes + cs.vec.nbytes
                      for cs in w.kernel.state.classes.values())
    assert c.device_bytes() > state_bytes
    text = w.telemetry.exposition()
    # without a card the census reads the world's state tensors (source
    # state_tensors), the counterpart of the JAX package's live_arrays
    for name in ("nf_train_dispatches_total 0", 'nf_entities_live{class="NPC"} 128',
                 f"nf_hbm_bytes_in_use {c.device_bytes()}"):
        assert name in text
    assert w.kernel.costbook.hbm["source"] == "state_tensors"


def _forged_books():
    """One JAX and one port cost book holding the same forged entries:
    the same stages, dispatch counts and ``last`` cost records."""
    from noahgameframe_tpu.telemetry.costbook import CostBook as JCostBook
    from noahgameframe_tpu_torch.telemetry.costbook import CostBook

    entries = [
        ("kernel.step", "tick", 30, {"flops": 4.0e9, "bytes_accessed": 2.5e9,
                                      "temp_bytes": 1 << 20}),
        ("kernel.train", "tick", 2, {"flops": 3.2e10, "bytes_accessed": 2.0e10}),
        ("serve.scan/NPC", "serve", 30, {"flops": 0.0, "bytes_accessed": 6.4e7,
                                          "temp_bytes": 4096}),
        ("interest.step/NPC", "interest", 30, {"bytes_accessed": 1.0e6}),
        ("no.cost", "serve", 5, {}),
        ("no.stage", None, 9, {"flops": 1.0, "bytes_accessed": 1.0}),
    ]
    books = []
    for book in (JCostBook(), CostBook()):
        for name, stage, calls, last in entries:
            e = book.entry(name, stage=stage)
            e.calls, e.last = calls, dict(last)
        books.append(book)
    return books


def test_cost_samples_and_roofline_fold_equal_jax():
    from noahgameframe_tpu.telemetry.costbook import roofline_fold as jax_fold
    from noahgameframe_tpu_torch.telemetry import roofline_fold
    from noahgameframe_tpu_torch.telemetry.costbook import PEAKS

    jbook, book = _forged_books()
    for key in ("flops", "bytes_accessed", "temp_bytes", "argument_bytes"):
        assert list(book.cost_samples(key)) == list(jbook.cost_samples(key)), key
    stats = {"frames": 30, "stages": {"tick": {"mean_ms": 8.0}, "serve": {"mean_ms": 2.5},
                                      "interest": {"mean_ms": 0.0}}}
    got = roofline_fold(book, stats, platform="cpu")
    assert got == jax_fold(jbook, stats, platform="cpu")
    assert set(got["stages"]) == {"tick", "serve", "interest"} and got["provisional"]
    assert got["stages"]["tick"]["entries"] == ["kernel.step", "kernel.train"]
    # the port's GPU row is the H100's published spec at 700 W, not JAX's
    gpu = roofline_fold(book, stats, platform="gpu")
    assert gpu["peaks"] == PEAKS["gpu"] and not gpu["provisional"]
    assert PEAKS["gpu"]["bytes_per_s"] == 3.35e12 and PEAKS["gpu"]["flops_per_s"] == 6.7e13
    assert "tpu" not in PEAKS


def test_cost_gauges_and_fallback_counter_on_metrics():
    """The port's cost count fills each entry's ``last`` with flops, bytes
    accessed and temp bytes on its first run: the entry gauges carry a
    sample for ``kernel.step`` (equal to its record) and the fold of a
    ticked world has the ``tick`` stage; the fused engine never falls
    back, so the counter reads 0."""
    from noahgameframe_tpu_torch.telemetry import roofline_fold

    w = torch_world(128, seed=3, device="cpu")
    w.kernel.tick()
    last = w.kernel.costbook.entries["kernel.step"].last
    assert last["flops"] > 0 and last["bytes_accessed"] > 0 and last["temp_bytes"] > 0
    _status, _ctype, body = w.telemetry.registry.handler("/metrics")
    text = body.decode() if isinstance(body, bytes) else body
    for name, key in (("nf_entry_flops", "flops"), ("nf_entry_bytes_accessed", "bytes_accessed"),
                      ("nf_entry_temp_bytes", "temp_bytes")):
        assert f"# TYPE {name} gauge" in text
        lines = [ln for ln in text.splitlines() if ln.startswith(name + "{")]
        assert [ln.split()[0] for ln in lines] == [f'{name}{{entry="kernel.step"}}']
        assert float(lines[0].split()[-1]) == pytest.approx(float(last[key]))
    assert "# TYPE nf_pallas_fallback_total counter" in text
    assert "\nnf_pallas_fallback_total 0\n" in text
    fold = roofline_fold(w.kernel.costbook, {"frames": 1, "stages": {"tick": {"mean_ms": 2.0}}},
                         platform="cpu")
    assert list(fold["stages"]) == ["tick"]
    assert fold["stages"]["tick"]["entries"] == ["kernel.step"]
    assert fold["stages"]["tick"]["flops_per_frame"] == last["flops"]


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from noahgameframe_tpu_torch.utils import profiler_trace

    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
