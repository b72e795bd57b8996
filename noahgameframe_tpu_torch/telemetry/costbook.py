"""CostBook: the capture and launch ledger of the tick's entry points.

Counterpart of ``noahgameframe_tpu/telemetry/costbook.py``.  There, every
jit entry compiles through :meth:`CostBook.wrap` and the book records
compile time, XLA's cost analysis and the cause of every retrace.  Here
the tick runs eagerly, and on a CUDA device an entry is replayed as a
CUDA graph: :meth:`CostBook.wrap` keys each call on the signature of its
state (tree structure, each leaf's shape, dtype and device) plus the
static knobs the step closes over (bucket, train K, engine, binning,
skin, ...), and on a miss captures the step anew.  Per entry it records:

- the wall seconds of warm-up plus capture (``capture_ms``);
- every re-capture with its cause, diffed against the previous
  signature (``static:bucket``, ``shape:.classes.NPC.i32``,
  ``tree-structure``, or ``rewrap`` when only a sanctioned drop, such as
  ``Kernel.invalidate``, made it capture again);
- the device launches of one replay: the kernel, copy and fill nodes of
  the captured graph, counted with ``cuGraphGetNodes``;
- the graph pool's bytes (``torch.cuda.memory_reserved`` grown by the
  capture) and ``torch.cuda.max_memory_allocated`` after it.

XLA's FLOPs and bytes have no counterpart and are not recorded.  On the
CPU nothing is captured: the entry runs the eager step, and every
signature miss is still recorded with its cause (``graph: false``).

Sanctioned re-captures call :meth:`generation_bump`; ``mark()`` /
``unexplained_since(mark)`` is the soak gate that finds the others.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from ..core.tree import flatten, unflatten

__all__ = ["CostBook", "CostEntry"]

#: re-capture events kept in the book's ring
_EVENT_RING = 128
# GameRole samples the device-memory census every this many ticks
HBM_SAMPLE_FRAMES = 64
#: capture records kept per book (a runaway backstop)
_COMPILE_LOG_CAP = 4096
#: eager runs on a side stream before a capture (allocator and lazy
#: attribute set-up, such as a kernel's shared-memory opt-in, happen there)
WARMUP_RUNS = 2


def _leaf_sig(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    return ("py", type(x).__name__, repr(x))


class CostEntry:
    """One named entry point's ledger."""

    def __init__(self, name: str, stage: Optional[str] = None) -> None:
        self.name = name
        self.stage = stage
        self.calls = 0  # dispatches
        self.replays = 0  # steps run by those dispatches
        self.compiles = 0  # signature misses (captures on a CUDA device)
        self.capture_s_total = 0.0
        self.causes: Dict[str, int] = {}
        self.last: Dict[str, Any] = {}
        self._last_sig = None
        self._last_paths: List[str] = []
        self.runner: Optional["_Graph"] = None  # the current graph, if any

    @property
    def recompiles(self) -> int:
        return max(0, self.compiles - 1)

    def attribute(self, sig, paths: List[str]) -> str:
        """Why did this signature miss?  Diffed against the previous
        miss's: statics first, then the tree, then leaf by leaf."""
        prev = self._last_sig
        if prev is None:
            return "first"
        ps, ns = dict(prev[2]), dict(sig[2])
        for k in sorted(set(ps) | set(ns)):
            if ps.get(k) != ns.get(k):
                return f"static:{k}"
        if prev[0] != sig[0]:
            return "tree-structure"
        for p, a, b in zip(paths, prev[1], sig[1]):
            if a == b:
                continue
            if a[0] == "py" or b[0] == "py":
                return f"pytype:{p}"
            if a[0] != b[0]:
                return f"shape:{p}"
            if a[1] != b[1]:
                return f"dtype:{p}"
            return f"device:{p}"
        return "rewrap"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "stage": self.stage,
            "calls": self.calls,
            "replays": self.replays,
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "capture_ms_total": round(self.capture_s_total * 1e3, 3),
            "causes": dict(self.causes),
            "last": dict(self.last),
        }


class _Eager:
    """An entry's step run as it is (the CPU, or a graph-less entry)."""

    graph = False

    def __init__(self, fn: Callable):
        self.fn = fn

    def run(self, state, leaves, times: int):
        out = None
        for _ in range(times):
            state, out = self.fn(state)
        return state, out


class _Graph:
    """One CUDA graph of ``fn(state) -> (state', outs)``.

    The graph's inputs are the state's own tensors; the tensors the step
    writes are copied back into them at the end of the graph, the ones it
    passes through are left alone (a bank that is only read costs
    nothing).  ``run`` first copies into the inputs any leaf the caller
    replaced since (an eager tick, a host write), then replays.  The
    outputs it returns are copies of the graph's own buffers, which the
    next replay overwrites: a caller may hold one dispatch's outputs (a
    train's ``[K, ...]`` lanes) across the next dispatch.

    ``launch_counters``: objects with a ``launches`` count (the hand
    kernels' wrappers).  A capture records launches without running them,
    so the counts made during capture are taken back and added again, per
    kernel, at every replay."""

    graph = True

    # CUgraphNodeType: kernel, memcpy, memset (the device launches)
    _LAUNCH_NODE_TYPES = (0, 1, 2)

    def __init__(self, fn: Callable, state, launch_counters: Mapping[str, Any]):
        leaves, spec, _paths = flatten(state)
        dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        # one buffer per leaf: a leaf sharing storage with an earlier one
        # (an alias or a view) gets its own copy
        seen = set()
        inputs = []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                key = x.untyped_storage().data_ptr()
                if key in seen:
                    x = x.clone()
                seen.add(key)
            inputs.append(x)
        self.inputs = inputs
        self.state = unflatten(spec, inputs)
        self.counters = launch_counters
        self.device = dev
        with torch.cuda.device(dev):
            self._capture(fn, spec, inputs, launch_counters)

    def _capture(self, fn, spec, inputs, launch_counters) -> None:
        dev = self.device
        torch.cuda.synchronize(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn(self.state)  # functional: the results are dropped
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        # a dropped graph that only a reference cycle still holds must not
        # be destroyed while this one captures (a destroy is refused under
        # capture and invalidates it): collect now, and not during
        # (torch.cuda.graph collects only under force_cudagraph_gc)
        gc.collect()
        # the capture empties the allocator's cache first; so does this,
        # so the reserved bytes it adds are the graph's own pool
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        before = {k: c.launches for k, c in launch_counters.items()}
        self.cuda_graph = torch.cuda.CUDAGraph(keep_graph=True)
        gc.disable()
        try:
            self._record(fn, spec, inputs)
        finally:
            gc.enable()
        self.cuda_graph.instantiate()
        self.per_replay = {}
        for k, c in launch_counters.items():
            self.per_replay[k] = c.launches - before[k]
            c.launches = before[k]
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.max_allocated = torch.cuda.max_memory_allocated(dev)
        self.launches_per_replay = self._count_launches()

    def _record(self, fn, spec, inputs) -> None:
        """Capture ``fn`` on the state, then the copies of its written
        leaves back into the inputs."""
        with torch.cuda.graph(self.cuda_graph):
            new_state, self.outs = fn(self.state)
            new_leaves, new_spec, _ = flatten(new_state)
            if new_spec != spec:
                raise RuntimeError("a captured step must return the state's own structure")
            pos = {id(x): i for i, x in enumerate(inputs) if isinstance(x, torch.Tensor)}
            writes = []
            for i, (dst, src) in enumerate(zip(inputs, new_leaves)):
                if src is dst or not isinstance(dst, torch.Tensor):
                    continue
                if pos.get(id(src), i) != i:
                    src = src.clone()  # an input moved to another leaf
                writes.append((dst, src))
            for dst, src in writes:
                dst.copy_(src)
        self.copy_backs = len(writes)

    def _count_launches(self) -> int:
        """Kernel, copy and fill nodes of the captured graph."""
        lib = ctypes.CDLL("libcuda.so.1")
        graph = ctypes.c_void_p(self.cuda_graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        kind = ctypes.c_int()
        count = 0
        for node in nodes:
            if lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            count += kind.value in self._LAUNCH_NODE_TYPES
        return count

    def run(self, state, leaves, times: int):
        for dst, src in zip(self.inputs, leaves):
            if src is not dst and isinstance(dst, torch.Tensor):
                dst.copy_(src)
        for _ in range(times):
            self.cuda_graph.replay()
        self._add_launches(times)
        if self.outs is None:
            return self.state, None
        leaves, spec, _ = flatten(self.outs)
        return self.state, unflatten(spec, [x.clone() if isinstance(x, torch.Tensor) else x
                                            for x in leaves])

    def _add_launches(self, times: int) -> None:
        for k, n in self.per_replay.items():
            self.counters[k].launches += n * times


class CostBook:
    """Registry of :class:`CostEntry` ledgers, the device memory census
    and the sanctioned re-capture generation counter."""

    def __init__(self) -> None:
        self.entries: Dict[str, CostEntry] = {}
        self.generation = 0
        self.gen_events: List[Dict[str, Any]] = []
        self.compile_log: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self._seq = 0
        self.hbm: Dict[str, Any] = {}
        self._hbm_samples = 0

    def entry(self, name: str, stage: Optional[str] = None) -> CostEntry:
        e = self.entries.get(name)
        if e is None:
            e = self.entries[name] = CostEntry(name, stage=stage)
        elif stage is not None and e.stage is None:
            e.stage = stage
        return e

    def wrap(self, name: str, fn: Callable, *, stage: Optional[str] = None,
             statics: Optional[Callable[[], Dict[str, Any]]] = None, graph: bool = False,
             launch_counters: Optional[Mapping[str, Any]] = None) -> Callable:
        """A dispatcher for ``fn(state) -> (state', outs)``: called as
        ``dispatch(state, times=1)`` it runs the step ``times`` times and
        returns the last ``(state', outs)``.  With ``graph`` and a state on
        a CUDA device, each signature is captured once as a CUDA graph and
        replayed; otherwise the step runs eagerly.  ``statics`` returns the
        host-side knobs the step closes over; they are part of the key."""
        entry = self.entry(name, stage=stage)
        cache: Dict[Any, Any] = {}
        counters = dict(launch_counters or {})
        book = self

        def dispatch(state, times: int = 1):
            leaves, spec, paths = flatten(state)
            st = tuple(sorted((statics() if statics else {}).items()))
            sig = (spec, tuple(_leaf_sig(x) for x in leaves), st)
            runner = cache.get(sig)
            if runner is None:
                # one capture per entry: a graph's pool holds the step's
                # intermediates, so a superseded one is dropped first
                cache.clear()
                entry.runner = None
                runner = book._capture(entry, fn, state, sig, paths, graph, counters)
                cache[sig] = runner
            entry.calls += 1
            entry.replays += int(times)
            return runner.run(state, leaves, int(times))

        dispatch.costbook_entry = entry
        return dispatch

    def _capture(self, entry: CostEntry, fn, state, sig, paths, graph: bool, counters):
        cause = entry.attribute(sig, paths)
        on_cuda = any(isinstance(x, torch.Tensor) and x.is_cuda for x in flatten(state)[0])
        t0 = time.perf_counter()
        if graph and on_cuda:
            runner = _Graph(fn, state, counters)
        else:
            runner = _Eager(fn)
        capture_s = time.perf_counter() - t0
        entry._last_sig = sig
        entry._last_paths = paths
        entry.compiles += 1
        entry.capture_s_total += capture_s
        if cause != "first":
            entry.causes[cause] = entry.causes.get(cause, 0) + 1
        rec: Dict[str, Any] = {
            "entry": entry.name, "cause": cause, "generation": self.generation,
            "seq": self._seq, "graph": runner.graph,
            "capture_ms": round(capture_s * 1e3, 3), "statics": dict(sig[2]),
        }
        if runner.graph:
            rec.update(pool_bytes=runner.pool_bytes, max_allocated_bytes=runner.max_allocated,
                       copy_backs=runner.copy_backs,
                       launches_per_replay=runner.launches_per_replay,
                       kernel_launches_per_replay=dict(runner.per_replay))
        entry.runner = runner if runner.graph else None
        self._seq += 1
        entry.last = rec
        if len(self.compile_log) < _COMPILE_LOG_CAP:
            self.compile_log.append(rec)
        if cause != "first":
            self.events.append(rec)
            del self.events[:-_EVENT_RING]
        return runner

    # -- sanctioned re-captures -------------------------------------------

    def generation_bump(self, cause: str) -> int:
        """A legitimate re-capture is coming (a kernel invalidate, a new
        train length); captures after this carry the new generation."""
        self.generation += 1
        self.gen_events.append({"generation": self.generation, "cause": str(cause),
                                "seq": self._seq})
        return self.generation

    def mark(self) -> Dict[str, int]:
        return {"seq": self._seq, "generation": self.generation}

    def compiles_since(self, mark: Dict[str, int]) -> List[Dict[str, Any]]:
        return [r for r in self.compile_log if r["seq"] >= mark["seq"]]

    def unexplained_since(self, mark: Dict[str, int]) -> List[Dict[str, Any]]:
        """Captures after ``mark`` not covered by a generation bump."""
        return [r for r in self.compiles_since(mark) if r["generation"] <= mark["generation"]]

    # -- device memory census ------------------------------------------------

    def hbm_sample(self, device=None) -> Dict[str, Any]:
        """The allocator's live, peak and total bytes of a CUDA device;
        on a machine without one, zeros with source ``none``."""
        self._hbm_samples += 1
        if torch.cuda.is_available():
            dev = torch.device("cuda" if device is None else device)
            _free, total = torch.cuda.mem_get_info(dev)
            self.hbm = {"live_bytes": torch.cuda.memory_allocated(dev),
                        "peak_bytes": torch.cuda.max_memory_allocated(dev),
                        "limit_bytes": total, "source": "torch.cuda",
                        "samples": self._hbm_samples}
        else:
            self.hbm = {"live_bytes": 0, "peak_bytes": 0, "limit_bytes": 0,
                        "source": "none", "samples": self._hbm_samples}
        return self.hbm

    # -- exposure ----------------------------------------------------------

    @property
    def total_compiles(self) -> int:
        return sum(e.compiles for e in self.entries.values())

    @property
    def total_recompiles(self) -> int:
        return sum(e.recompiles for e in self.entries.values())

    @property
    def capture_s_total(self) -> float:
        return sum(e.capture_s_total for e in self.entries.values())

    def launches_per_replay(self, name: str) -> Optional[int]:
        """Device launches of one replay of ``name``'s current graph (None
        without a graph)."""
        runner = getattr(self.entries.get(name), "runner", None)
        return None if runner is None else runner.launches_per_replay

    def snapshot(self) -> Dict[str, Any]:
        entries = {}
        for n, e in sorted(self.entries.items()):
            d = e.to_dict()
            d["launches_per_replay"] = self.launches_per_replay(n)
            entries[n] = d
        return {
            "generation": self.generation,
            "gen_events": list(self.gen_events[-_EVENT_RING:]),
            "compiles": self.total_compiles,
            "recompiles": self.total_recompiles,
            "capture_ms": round(self.capture_s_total * 1e3, 3),
            "hbm": dict(self.hbm),
            "entries": entries,
            "events": list(self.events),
        }

    def summary(self) -> Dict[str, Any]:
        """Compact blob: per-entry captures, re-captures, launches per
        replay and pool bytes, plus the memory totals."""
        return {
            "compiles": self.total_compiles,
            "recompiles": self.total_recompiles,
            "capture_ms": round(self.capture_s_total * 1e3, 1),
            "generation": self.generation,
            "hbm_live": int(self.hbm.get("live_bytes", 0)),
            "hbm_peak": int(self.hbm.get("peak_bytes", 0)),
            "hbm_source": self.hbm.get("source", ""),
            "entries": {
                n: {"c": e.compiles, "r": e.recompiles,
                    "l": self.launches_per_replay(n),
                    "p": e.last.get("pool_bytes", 0)}
                for n, e in sorted(self.entries.items())
            },
        }

    # -- registry sample feeds -------------------------------------------

    def recompile_samples(self) -> Iterable[Tuple[dict, float]]:
        for name, e in sorted(self.entries.items()):
            for cause, n in sorted(e.causes.items()):
                yield ({"entry": name, "cause": cause}, float(n))

    def compile_samples(self, which: int) -> Iterable[Tuple[dict, float]]:
        """which: 0 = captures, 1 = capture seconds (warm-up included)."""
        for name, e in sorted(self.entries.items()):
            yield ({"entry": name}, float(e.compiles) if which == 0 else e.capture_s_total)

    def launch_samples(self) -> Iterable[Tuple[dict, float]]:
        for name in sorted(self.entries):
            n = self.launches_per_replay(name)
            if n is not None:
                yield ({"entry": name}, float(n))
