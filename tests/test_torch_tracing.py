"""The port's span tracer (noahgameframe_tpu_torch/telemetry/tracing.py)
and the spans the cost book and the world build record with it: the
span tree (parent ids, frame ids, self time), the mapping of its clock
onto a ``torch.profiler`` trace's, the ``costbook.*`` spans of a CPU
world's dispatches and first run, the copy-in count of a graph's
``run``, and the device marks a captured step would record at each
outermost ``device_annotation`` range.  The captured graph's event nodes
and device spans are checked on the card (tests/test_torch_cuda.py)."""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from noahgameframe_tpu_torch.game.world import build_benchmark_world
from noahgameframe_tpu_torch.telemetry import tracing
from noahgameframe_tpu_torch.telemetry.costbook import CostBook, CostEntry, _Graph
from noahgameframe_tpu_torch.telemetry.tracing import DeviceMarks, SpanTracer

from test_torch_parity import one_intra_op_thread  # noqa: F401


def _spin(us: float) -> None:
    end = time.perf_counter_ns() + int(us * 1e3)
    while time.perf_counter_ns() < end:
        pass


def test_span_tree_parents_frames_and_self_time():
    assert bool(SpanTracer()) and bool(SpanTracer(enabled=True))
    off = SpanTracer()
    assert off.span("x") is tracing._NULL_CTX and off.span("y") is tracing._NULL_CTX
    with off.span("x") as sp:
        sp.set(n=1)
    assert len(off) == 0

    tr = SpanTracer(enabled=True)
    frame = [7]
    tr.frame_source = lambda: frame[0]
    with tr.span("frame"):
        with tr.span("dispatch"):
            with tr.span("key"):
                _spin(300)
            with tr.span("replay") as sp:
                _spin(500)
                sp.set(times=1)
        _spin(200)
    frame[0] = 8
    with tr.span("frame"):
        tr.instant("mark")
    by = {}
    for e in tr.events():
        by.setdefault(e.name, []).append(e)
    f7, f8 = by["frame"]
    d, k, r = by["dispatch"][0], by["key"][0], by["replay"][0]
    assert (f7.parent, d.parent, k.parent, r.parent) == (0, f7.id, d.id, d.id)
    assert {f7.frame, d.frame, k.frame, r.frame} == {7}
    assert f8.frame == 8 and f8.parent == 0
    assert by["mark"][0].parent == f8.id and by["mark"][0].dur_ns == -1
    assert r.args == {"times": 1}
    # a parent is recorded after its children, and its self time is what
    # they leave uncovered
    names = [e.name for e in tr.events()]
    assert names.index("key") < names.index("dispatch") < names.index("frame")
    assert tr.self_ns(d) == d.dur_ns - k.dur_ns - r.dur_ns
    assert 0 <= tr.self_ns(d) < d.dur_ns
    assert tr.self_ns(f7) == f7.dur_ns - d.dur_ns >= 200_000
    assert tr.self_ns(k) == k.dur_ns >= 300_000
    # each thread has its own stack of open spans
    seen = {}

    def worker():
        with tr.span("thread.outer"):
            with tr.span("thread.inner"):
                pass
        seen["ok"] = True

    with tr.span("main.outer"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen["ok"]
    ev = {e.name: e for e in tr.events()}
    assert ev["thread.outer"].parent == 0
    assert ev["thread.inner"].parent == ev["thread.outer"].id
    assert ev["thread.outer"].tid != ev["main.outer"].tid
    # the export carries the tree in each span's args
    doc = tr.chrome_trace()
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["key"]["args"]["parent"] == xs["dispatch"]["args"]["id"]
    assert xs["key"]["args"]["frame"] == 7


def test_ring_overwrite_and_clear_keep_the_tree():
    tr = SpanTracer(capacity=3, enabled=True)
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [e.name for e in tr.events()] == ["s2", "s3", "s4"]
    tr.clear()
    assert len(tr) == 0
    with tr.span("after"):
        pass
    assert tr.events()[0].parent == 0


def test_spans_land_on_the_profiler_clock(tmp_path):
    """A ``record_function`` range inside a span lies inside that span once
    the span is mapped onto the profiler trace's clock (its
    ``baseTimeNanoseconds`` and the tracer's clock pair), within 0.5 ms."""
    with record_function("warm"):
        pass
    tr = SpanTracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):
            with tr.span("outer", i=i):
                _spin(1500)
                with record_function("inner"):
                    _spin(1500)
                _spin(1500)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    inner = sorted((e for e in doc["traceEvents"] if e.get("name") == "inner"),
                   key=lambda e: e["ts"])
    mapped = tr.chrome_trace(base_time_ns=int(doc["baseTimeNanoseconds"]))
    outer = sorted((e for e in mapped["traceEvents"] if e["ph"] == "X"),
                   key=lambda e: e["ts"])
    assert len(inner) == len(outer) == 8
    for i, (o, r) in enumerate(zip(outer, inner)):
        assert o["args"]["i"] == i
        # the inner range begins at least 1.5 ms after the span and ends at
        # least 1.5 ms before it (a preempted thread only adds to both)
        assert r["ts"] - o["ts"] >= 1500.0 - 500.0
        assert (o["ts"] + o["dur"]) - (r["ts"] + r["dur"]) >= 1500.0 - 500.0
    # the default export stays on the tracer's own epoch
    plain = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert min(e["ts"] for e in plain) >= 0


def test_world_build_and_cpu_dispatch_spans():
    """``build_benchmark_world(tracer=...)`` records the build's spans and
    the world adopts the tracer; an observed CPU tick records
    ``costbook.key`` inside ``kernel.dispatch`` and, on its first run, the
    cost count; ``run_device(graph=False)`` runs under
    ``kernel.dispatch``.  Frames are the kernel's tick count."""
    tr = SpanTracer(enabled=True)
    w = build_benchmark_world(256, seed=4, device="cpu", tracer=tr)
    assert w.telemetry.tracer is tr and w.kernel.tracer is tr
    assert w.kernel.costbook.tracer is tr
    ev = {e.name: e for e in tr.events()}
    assert ev["world.build"].parent == 0
    assert ev["world.start"].parent == ev["world.build"].id
    assert ev["world.seed_npcs"].parent == ev["world.build"].id
    assert ev["world.build"].args == {"npcs": 256}
    assert tr.self_ns(ev["world.build"]) >= 0
    tr.clear()
    w.kernel.tick()
    w.kernel.tick()
    w.kernel.run_device(2, graph=False, reconcile=False)
    spans = tr.events()
    disp = [e for e in spans if e.name == "kernel.dispatch"]
    keys = [e for e in spans if e.name == "costbook.key"]
    counts = [e for e in spans if e.name == "costbook.cost_count"]
    assert [e.frame for e in disp] == [0, 1, 2]
    assert [k.parent for k in keys] == [disp[0].id, disp[1].id]
    assert len(counts) == 1 and counts[0].parent == disp[0].id
    assert {e.name for e in spans if e.parent == disp[2].id} == set()
    # a CPU entry's key has no phase events, whatever the tracer says
    entry = w.kernel.costbook.entries["kernel.step"]
    assert entry.compiles == 1 and "phase_events" not in entry.last["statics"]
    assert w.kernel.device_spans("kernel.step") is None
    assert entry.to_dict()["copy_ins"] == 0


def test_tracing_never_recaptures_a_cpu_entry():
    """Turning the book's tracer on keys ``phase_events`` only for a graph
    on a CUDA device: a CPU entry (even one asked for as a graph) keeps
    its one capture."""
    book = CostBook()
    for graph in (False, True):
        fn = book.wrap(f"e{int(graph)}", lambda s: (s * 2, None), graph=graph)
        x = torch.ones(4)
        fn(x)
        book.tracer.enabled = True
        fn(x)
        book.tracer.enabled = False
        fn(x)
        assert book.entries[f"e{int(graph)}"].compiles == 1


class _Replays:
    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def _cpu_graph(inputs):
    """A :class:`_Graph` around a stand-in for its CUDA graph, so that its
    ``run`` (the copy-in and the replays) runs on the CPU."""
    g = _Graph.__new__(_Graph)
    g.inputs = list(inputs)
    g.state = tuple(inputs)
    g.outs = None
    g.counters, g.per_replay = {}, {}
    g.cuda_graph = _Replays()
    return g


@pytest.mark.parametrize("replaced", [0, 1, 2])
def test_graph_run_copies_in_replaced_leaves(replaced):
    """``run`` copies into the graph's inputs the leaves a caller replaced
    (and only those), counts them on the entry and in its
    ``costbook.copy_in`` span, then replays under ``graph.replay``."""
    a, b = torch.zeros(3), torch.zeros(2, dtype=torch.int32)
    g = _cpu_graph([a, b, "py"])
    leaves = [a, b, "py"]
    new = [torch.full((3,), 5.0), torch.full((2,), 9, dtype=torch.int32)]
    for i in range(replaced):
        leaves[i] = new[i]
    tr = SpanTracer(enabled=True)
    entry = CostEntry("kernel.run")
    entry.copy_ins = 4
    state, outs = g.run(tuple(leaves), leaves, 3, tr, entry)
    assert outs is None and state == g.state and g.cuda_graph.n == 3
    assert entry.copy_ins == 4 + replaced
    for i in range(2):
        assert torch.equal(g.inputs[i], new[i] if i < replaced else torch.zeros_like(new[i]))
    ev = {e.name: e for e in tr.events()}
    assert ev["costbook.copy_in"].args == {"leaves": replaced}
    assert ev["graph.replay"].dur_ns >= 0
    # off, the same run records nothing and still counts
    off = SpanTracer()
    g.run(tuple(leaves), leaves, 1, off, entry)
    assert len(off) == 0 and entry.copy_ins == 4 + 2 * replaced


class _NamesOnly(DeviceMarks):
    """The marks a capture would record, without a CUDA device."""

    def mark(self, name):
        self.names.append(name)


def test_device_marks_at_each_outermost_range():
    """Under ``device_marks``, each outermost ``device_annotation`` range
    marks at its end, nested ones do not, and nothing is marked outside
    the block; a CPU world's step marks ``nf.schedule`` and every phase
    in order."""
    marks = _NamesOnly()
    with tracing.device_marks(marks):
        with tracing.device_annotation("a"):
            with tracing.device_annotation("a.inner"):
                pass
        with tracing.device_annotation("b"):
            pass
    with tracing.device_annotation("outside"):
        pass
    assert marks.names == ["a", "b"]

    w = build_benchmark_world(128, seed=2, device="cpu")
    k = w.kernel
    marks = _NamesOnly()
    with tracing.device_marks(marks):
        k._step(k.state, observe=False)
    assert marks.names == ["nf.schedule"] + [f"nf.phase.{p.name}" for p in k._composed]
    assert len(marks.names) >= 4
    with tracing.device_marks(None):
        with tracing.device_annotation("x"):
            pass
