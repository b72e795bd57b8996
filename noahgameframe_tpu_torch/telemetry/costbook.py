"""CostBook: the capture, launch and cost ledger of the tick's entry points.

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
  capture) and ``torch.cuda.max_memory_allocated`` after it;
- the copy-backs the graph ends with (``copy_backs``) and the bytes they
  copy (``copy_back_bytes``, clones included), and a running total of
  the leaves each dispatch copied into the graph's inputs first
  (``CostEntry.copy_ins``: 0 while nothing replaces a leaf);
- the step's cost, under the JAX package's key names: ``flops``,
  ``bytes_accessed`` and ``temp_bytes`` (see below).

On the CPU nothing is captured: the entry runs the eager step, and every
signature miss is still recorded with its cause (``graph: false``).

**The cost count** is the port's counterpart of XLA's
``cost_analysis()``.  On every signature miss one run of the step goes
through :class:`CostCounter`, a ``TorchDispatchMode`` that sees each
aten (and ``nf::``) op the step dispatches: on a CUDA device it is the
first warm-up run before the capture, on the CPU the first eager run,
so the count adds no run of its own.  It follows ``HloCostAnalysis`` as
far as a count per aten op allows:

- ``flops``: one per output element for elementwise arithmetic (ops
  tagged ``pointwise``, comparisons and selects included); one per
  input element for a reduction (ops tagged ``reduction``, cumulative
  sums, and the accumulating scatters ``scatter_add``,
  ``scatter_reduce`` and ``index_add``, one per source element); the
  formulas of ``torch.utils.flop_counter`` for matmuls (``2 m n k``, per
  batch for ``bmm``); ``n * ceil(log2 n)`` comparisons for a sort along an
  axis of ``n``; 0 for pure data movement (copies, casts, gathers,
  scatters, concatenation, fills, factories, views).
- ``bytes_accessed``: the bytes of every tensor operand plus the bytes
  of every output, per op.  A view (an output that aliases an operand
  without writing it) and an uninitialised factory (``empty``) move
  none.  The custom ops ``nf::combat_fold``, ``nf::fused_neighborhood``,
  ``nf::slot_rows``, ``nf::wander``, ``nf::fold_in`` and
  ``nf::buff_fold`` are counted by the same rule; their flops have no
  rule.  The ``profiler::`` range markers (the ``nf.*`` ranges) count
  nothing.  Under ``torch.func.vmap`` (the rooms engine) a custom op's
  batching rule launches the kernel without dispatching the op, so on
  a CUDA device a vmapped fold's bytes are not seen.
- ``temp_bytes``: the peak allocated during the counted run, less its
  inputs and outputs.  On a CUDA device that is
  ``torch.cuda.max_memory_allocated`` around the run (its peak
  statistic is reset first, so a caller that wants a peak across a
  capture reads it afterwards); on the CPU, the counter's running total
  of live intermediates (each new storage an op returns, held until the
  last tensor the step got from an op on it is freed).

An op with no rule is counted as data movement (0 flops, its bytes
counted) and listed by name in ``last["uncounted_ops"]``; nothing is
dropped.  The CPU runs a fold's plain version where a CUDA device
launches the hand kernel, so the two devices' counts of one step
differ by design.

:func:`roofline_fold` joins an entry's FLOPs and bytes with the stage
clock's device seconds, as in the JAX package.  An entry folds when its
``last`` record carries a cost (``flops`` or ``bytes_accessed``).

Sanctioned re-captures call :meth:`generation_bump`; ``mark()`` /
``unexplained_since(mark)`` is the soak gate that finds the others.

**Spans.**  With :attr:`CostBook.tracer` on (``TelemetryModule`` sets the
world's tracer there and on the kernel), a dispatch records
``costbook.key`` (statics, flatten, the leaf signature and the lookup),
``costbook.copy_in`` (with the count of leaves it copied) and
``graph.replay``; a capture records ``costbook.capture`` with
``costbook.cost_count``, ``costbook.warmup``, ``costbook.record``,
``costbook.instantiate`` and ``costbook.count_launches`` inside.  A
graph entry captured while the tracer is on also times its phases on
the device: ``phase_events`` joins its key, and the graph records a
timing event at its start, at the end of each outermost
``device_annotation`` range, after the step and after the copy-backs
(event-record nodes, which the launch count leaves out);
:meth:`CostBook.device_spans` reads the last replay's.
"""

from __future__ import annotations

import ctypes
import gc
import math
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.tree import flatten, unflatten
from .tracing import DeviceMarks, SpanTracer, device_marks

__all__ = ["CostBook", "CostEntry", "CostCounter", "count_cost", "roofline_fold", "PEAKS",
           "HBM_SAMPLE_FRAMES"]

#: re-capture events kept in the book's ring
_EVENT_RING = 128
# GameRole samples the device-memory census every this many ticks
HBM_SAMPLE_FRAMES = 64
#: capture records kept per book (a runaway backstop)
_COMPILE_LOG_CAP = 4096
#: peak FLOPs/s and bytes/s per platform for the roofline fold.  The CPU
#: row is the JAX package's provisional placeholder; the GPU row is the
#: published spec of one H100 SXM at its 700 W power limit (float32
#: outside the tensor cores, HBM3), the card this port is measured on.
PEAKS: Dict[str, Dict[str, Any]] = {
    "cpu": {"flops_per_s": 5.0e10, "bytes_per_s": 2.0e10,
            "source": "provisional-nominal-cpu"},
    "gpu": {"flops_per_s": 6.7e13, "bytes_per_s": 3.35e12,
            "source": "h100-sxm-spec-f32 (NVIDIA H100 80GB HBM3, 700 W)"},
}
#: the keys of a cost record in a ``CostEntry.last``
_COST_KEYS = ("flops", "bytes_accessed")
#: eager runs on a side stream before a capture (allocator and lazy
#: attribute set-up, such as a kernel's shared-memory opt-in, happen there)
WARMUP_RUNS = 2


def _leaf_sig(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    return ("py", type(x).__name__, repr(x))


# -- the cost count -------------------------------------------------------------

_aten = torch.ops.aten
#: ops that move or make data and compute nothing (0 flops), beyond views
_MOVES = frozenset({
    "clone", "_to_copy", "copy", "copy_", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "scatter", "index_put", "index_put_", "_index_put_impl_",
    "masked_select", "take", "fill", "fill_", "zero_", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "repeat", "flip", "roll", "constant_pad_nd", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "nonzero", "resize_", "set_", "randperm", "bernoulli_",
    "_unsafe_index", "index_copy", "index_copy_", "slice_scatter", "select_scatter",
    "diagonal_scatter", "tril", "triu", "unique_dim", "_unique2", "unique_consecutive",
    "bucketize", "searchsorted", "_pin_memory", "to", "record_stream", "split_with_sizes_copy",
})
#: reductions by name (``Tag.reduction`` is the rule; these are its others)
_REDUCES = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "var", "std", "norm",
    "count_nonzero", "aminmax", "nansum", "logcumsumexp", "_cummax_helper", "_cummin_helper",
})
#: accumulating scatters: one flop per source element
_ACCUMULATES = frozenset({"scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
                          "index_add", "index_add_", "index_reduce", "index_reduce_"})
_SORTS = frozenset({"sort", "argsort", "topk", "kthvalue", "msort"})
_EMPTY = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                    "empty_permuted"})
_POINTWISE = torch.Tag.pointwise
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _tensors(tree, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (tuples, lists and
    dicts of them)."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


def _mm_flops(a, b, *_rest, **_kw) -> float:
    """``2 m n k`` for ``[m, k] @ [k, n]``."""
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm_flops(a, b, *_rest, **_kw) -> float:
    """``2 b m n k`` for ``[b, m, k] @ [b, k, n]``."""
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


#: the matmul formulas of ``torch.utils.flop_counter`` (written out here:
#: importing that module pulls in torch._dynamo and sympy, seconds of a
#: process's start); each takes the op's arguments
_MATMULS: Dict[str, Callable] = {
    "mm": _mm_flops,
    "addmm": lambda _bias, a, b, *_r, **_k: _mm_flops(a, b),
    "bmm": _bmm_flops,
    "baddbmm": lambda _bias, a, b, *_r, **_k: _bmm_flops(a, b),
}


#: each op's rule, worked out once: (qualified name, rule, moves bytes)
_RULES: Dict[Any, Tuple[str, Optional[str], bool]] = {}


def _rule(func) -> Tuple[str, Optional[str], bool]:
    """``func``'s qualified name, its flop rule (``"none"`` for 0 flops,
    ``"matmul"``, ``"accumulate"``, ``"pointwise"``, ``"reduce"``,
    ``"sort"``, or None where no rule applies) and whether it moves
    bytes (a view, an uninitialised factory and a profiler range move
    none)."""
    r = _RULES.get(func)
    if r is None:
        name = func.overloadpacket.__name__
        view = any(ret.alias_info is not None and not ret.alias_info.is_write
                   for ret in func._schema.returns)
        marker = func.namespace == "profiler"
        tags = func.tags
        if view or marker or name in _MOVES:
            kind = "none"
        elif name in _MATMULS:
            kind = "matmul"
        elif name in _ACCUMULATES:
            kind = "accumulate"
        elif _POINTWISE in tags:
            kind = "pointwise"
        elif (_REDUCTION is not None and _REDUCTION in tags) or name in _REDUCES:
            kind = "reduce"
        elif name in _SORTS:
            kind = "sort"
        else:
            kind = None
        r = _RULES[func] = (f"{func.namespace}::{name}", kind,
                            not (view or marker or name in _EMPTY))
    return r


def _flops(kind: str, qual: str, args, kwargs, ins, outs) -> float:
    """The flops of one op under its rule ``kind``."""
    if kind == "none":
        return 0.0
    if kind == "pointwise":
        return float(outs[0].numel()) if outs else 0.0
    if kind == "reduce":
        return float(ins[0].numel()) if ins else 0.0
    if kind == "accumulate":
        return float(ins[-1].numel())  # the source, the op's last tensor
    if kind == "matmul":
        return _MATMULS[qual.split("::")[1]](*args, **kwargs)
    # a sort along an axis of n: n * ceil(log2 n) comparisons
    if not ins:
        return 0.0
    x = ins[0]
    dim = args[1] if len(args) > 1 and isinstance(args[1], int) else kwargs.get("dim", -1)
    n = x.shape[dim] if x.dim() else 1
    return float(x.numel() * max(1, math.ceil(math.log2(max(n, 1)))))


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes accessed and live intermediates of the ops
    run under it, by the module's rules.  ``inputs``: the tensors the
    counted step was given (their storages are not intermediates).
    ``track_live``: follow the live intermediates (the CPU's
    ``temp_bytes``)."""

    def __init__(self, inputs: Iterable[torch.Tensor] = (), track_live: bool = True) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.ops = 0
        self.uncounted: Dict[str, int] = {}
        self.track_live = track_live
        self._base = {_storage_key(t) for t in inputs}
        self._live: Dict[Any, List[int]] = {}  # storage key -> [bytes, tensors held]
        self.live_bytes = 0
        self.peak_bytes = 0

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing under this mode is compiled: left to torch, the handler
        # is wrapped to skip dynamo, and its first op imports torch._dynamo
        # (seconds of a process's first capture)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        qual, kind, moves = _rule(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.ops += 1
        if moves:
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if kind is None:
            self.uncounted[qual] = self.uncounted.get(qual, 0) + 1
        else:
            self.flops += _flops(kind, qual, args, kwargs, ins, outs)
        if self.track_live:
            for t in outs:
                self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._base or key[2] == 0:
            return
        rec = self._live.get(key)
        if rec is None:
            rec = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += rec[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._live[key]


def count_cost(fn: Callable, state) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(state)`` once under a :class:`CostCounter`; returns its
    result and the cost record (``flops``, ``bytes_accessed``,
    ``temp_bytes``, ``cost_ops``, the counted run's wall ``cost_ms`` and
    ``uncounted_ops``), by the module's rules."""
    leaves = _tensors(flatten(state)[0])
    cuda = next((t.device for t in leaves if t.is_cuda), None)
    base_keys = {_storage_key(t) for t in leaves}
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        before = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    counter = CostCounter(leaves, track_live=cuda is None)
    t0 = time.perf_counter()
    with counter:
        result = fn(state)
    new_out, seen = 0, set(base_keys)
    for t in _tensors(flatten(result)[0]):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            new_out += t.untyped_storage().nbytes()
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        peak = torch.cuda.max_memory_allocated(cuda) - before
    else:
        peak = counter.peak_bytes
    cost = {"flops": counter.flops, "bytes_accessed": counter.bytes_accessed,
            "temp_bytes": max(0, int(peak) - new_out), "cost_ops": counter.ops,
            "cost_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "uncounted_ops": dict(sorted(counter.uncounted.items()))}
    return result, cost


class CostEntry:
    """One named entry point's ledger."""

    def __init__(self, name: str, stage: Optional[str] = None) -> None:
        self.name = name
        self.stage = stage
        self.calls = 0  # dispatches
        self.replays = 0  # steps run by those dispatches
        self.compiles = 0  # signature misses (captures on a CUDA device)
        self.capture_s_total = 0.0
        self.copy_ins = 0  # leaves copied into a graph's inputs, all dispatches
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
            "copy_ins": self.copy_ins,
            "causes": dict(self.causes),
            "last": dict(self.last),
        }


class _Eager:
    """An entry's step run as it is (the CPU, or a graph-less entry).  Its
    first run goes through :func:`count_cost`, and the cost lands in
    ``rec`` (the entry's ``last`` record)."""

    graph = False

    def __init__(self, fn: Callable, rec: Optional[Dict[str, Any]] = None):
        self.fn = fn
        self.rec = rec

    def run(self, state, leaves, times: int, tracer: SpanTracer, entry: CostEntry):
        out = None
        for _ in range(times):
            if self.rec is not None:
                with tracer.span("costbook.cost_count"):
                    (state, out), cost = count_cost(self.fn, state)
                self.rec.update(cost)
                self.rec = None
            else:
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
    kernel, at every replay.

    ``phase_events``: record :class:`DeviceMarks` in the graph (``start``,
    each outermost ``device_annotation`` range, ``nf.step`` after the
    step, ``nf.copy_back`` after the copy-backs); ``marks`` is then the
    graph's, else None.  ``tracer`` times the capture's parts."""

    graph = True

    # CUgraphNodeType: kernel, memcpy, memset (the device launches)
    _LAUNCH_NODE_TYPES = (0, 1, 2)

    def __init__(self, fn: Callable, state, launch_counters: Mapping[str, Any],
                 tracer: SpanTracer, phase_events: bool = False):
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
        self.marks = DeviceMarks() if phase_events else None
        with torch.cuda.device(dev):
            self._capture(fn, spec, inputs, launch_counters, tracer)

    def _capture(self, fn, spec, inputs, launch_counters, tracer: SpanTracer) -> None:
        dev = self.device
        torch.cuda.synchronize(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # functional: the results are dropped; the first is counted
            with tracer.span("costbook.cost_count"):
                _out, self.cost = count_cost(fn, self.state)
                del _out
            with tracer.span("costbook.warmup"):
                for _ in range(WARMUP_RUNS - 1):
                    fn(self.state)
                torch.cuda.synchronize(dev)
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
            with tracer.span("costbook.record"):
                self._record(fn, spec, inputs)
        finally:
            gc.enable()
        with tracer.span("costbook.instantiate"):
            self.cuda_graph.instantiate()
            torch.cuda.synchronize(dev)
        self.per_replay = {}
        for k, c in launch_counters.items():
            self.per_replay[k] = c.launches - before[k]
            c.launches = before[k]
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.max_allocated = torch.cuda.max_memory_allocated(dev)
        with tracer.span("costbook.count_launches"):
            self.launches_per_replay = self._count_launches()

    def _record(self, fn, spec, inputs) -> None:
        """Capture ``fn`` on the state, then the copies of its written
        leaves back into the inputs (``copy_backs`` of them, moving
        ``copy_back_bytes``, the clones of moved inputs included)."""
        marks = self.marks
        with torch.cuda.graph(self.cuda_graph):
            if marks is not None:
                marks.mark("start")
            with device_marks(marks):
                new_state, self.outs = fn(self.state)
            if marks is not None:
                marks.mark("nf.step")
            new_leaves, new_spec, _ = flatten(new_state)
            if new_spec != spec:
                raise RuntimeError("a captured step must return the state's own structure")
            pos = {id(x): i for i, x in enumerate(inputs) if isinstance(x, torch.Tensor)}
            writes = []
            nbytes = 0
            for i, (dst, src) in enumerate(zip(inputs, new_leaves)):
                if src is dst or not isinstance(dst, torch.Tensor):
                    continue
                if pos.get(id(src), i) != i:
                    src = src.clone()  # an input moved to another leaf
                    nbytes += src.nbytes
                writes.append((dst, src))
            for dst, src in writes:
                dst.copy_(src)
                nbytes += dst.nbytes
            if marks is not None:
                marks.mark("nf.copy_back")
        self.copy_backs = len(writes)
        self.copy_back_bytes = nbytes

    def _count_launches(self) -> int:
        """Kernel, copy and fill nodes of the captured graph."""
        types = self.node_types()
        return sum(types.get(t, 0) for t in self._LAUNCH_NODE_TYPES)

    def node_types(self) -> Dict[int, int]:
        """The captured graph's nodes by ``CUgraphNodeType`` (0 kernel, 1
        memcpy, 2 memset, 7 event record, ...)."""
        lib = ctypes.CDLL("libcuda.so.1")
        graph = ctypes.c_void_p(self.cuda_graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        kind = ctypes.c_int()
        types: Dict[int, int] = {}
        for node in nodes:
            if lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            types[kind.value] = types.get(kind.value, 0) + 1
        return types

    def run(self, state, leaves, times: int, tracer: SpanTracer, entry: CostEntry):
        with tracer.span("costbook.copy_in") as sp:
            copied = 0
            for dst, src in zip(self.inputs, leaves):
                if src is not dst and isinstance(dst, torch.Tensor):
                    dst.copy_(src)
                    copied += 1
            entry.copy_ins += copied
            sp.set(leaves=copied)
        with tracer.span("graph.replay"):
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
        #: host spans of dispatches and captures (off by default; the
        #: telemetry module sets the world's tracer here)
        self.tracer = SpanTracer()
        self.generation = 0
        self.gen_events: List[Dict[str, Any]] = []
        self.compile_log: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self._seq = 0
        self.hbm: Dict[str, Any] = {}
        self._hbm_samples = 0
        #: live bytes of what the book's entries run on, for the census
        #: without a CUDA device (set by the telemetry module)
        self.host_census: Optional[Callable[[], int]] = None
        self._host_peak = 0

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
        host-side knobs the step closes over; they are part of the key, and
        so, for a graph on a CUDA device, is ``phase_events`` while the
        book's tracer is on."""
        entry = self.entry(name, stage=stage)
        cache: Dict[Any, Any] = {}
        counters = dict(launch_counters or {})
        book = self

        def dispatch(state, times: int = 1):
            tracer = book.tracer
            with tracer.span("costbook.key"):
                leaves, spec, paths = flatten(state)
                st = statics() if statics else {}
                if graph and tracer.enabled and next(
                        (x.is_cuda for x in leaves if isinstance(x, torch.Tensor)), False):
                    st = {**st, "phase_events": True}
                sig = (spec, tuple(_leaf_sig(x) for x in leaves), tuple(sorted(st.items())))
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
            return runner.run(state, leaves, int(times), tracer, entry)

        dispatch.costbook_entry = entry
        return dispatch

    def _capture(self, entry: CostEntry, fn, state, sig, paths, graph: bool, counters):
        cause = entry.attribute(sig, paths)
        on_cuda = any(isinstance(x, torch.Tensor) and x.is_cuda for x in flatten(state)[0])
        t0 = time.perf_counter()
        rec: Dict[str, Any] = {}
        if graph and on_cuda:
            with self.tracer.span("costbook.capture", entry=entry.name, cause=cause):
                runner = _Graph(fn, state, counters, self.tracer,
                                phase_events=bool(dict(sig[2]).get("phase_events")))
            rec.update(runner.cost)
        else:
            runner = _Eager(fn, rec)
        capture_s = time.perf_counter() - t0
        entry._last_sig = sig
        entry._last_paths = paths
        entry.compiles += 1
        entry.capture_s_total += capture_s
        if cause != "first":
            entry.causes[cause] = entry.causes.get(cause, 0) + 1
        rec.update({
            "entry": entry.name, "cause": cause, "generation": self.generation,
            "seq": self._seq, "graph": runner.graph,
            "capture_ms": round(capture_s * 1e3, 3), "statics": dict(sig[2]),
        })
        if runner.graph:
            rec.update(pool_bytes=runner.pool_bytes, max_allocated_bytes=runner.max_allocated,
                       copy_backs=runner.copy_backs, copy_back_bytes=runner.copy_back_bytes,
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
        """The allocator's live, peak and total bytes of a CUDA device; on
        a machine without one, the live bytes :attr:`host_census` reports
        (the attached world's state tensors, source ``state_tensors``,
        the counterpart of the JAX package's ``live_arrays`` fallback)
        with the peak this book has seen, or zeros with source ``none``
        when nothing is attached."""
        self._hbm_samples += 1
        if torch.cuda.is_available():
            dev = torch.device("cuda" if device is None else device)
            _free, total = torch.cuda.mem_get_info(dev)
            self.hbm = {"live_bytes": torch.cuda.memory_allocated(dev),
                        "peak_bytes": torch.cuda.max_memory_allocated(dev),
                        "limit_bytes": total, "source": "torch.cuda",
                        "samples": self._hbm_samples}
        elif self.host_census is not None:
            live = int(self.host_census())
            self._host_peak = max(self._host_peak, live)
            self.hbm = {"live_bytes": live, "peak_bytes": self._host_peak, "limit_bytes": 0,
                        "source": "state_tensors", "samples": self._hbm_samples}
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

    def device_spans(self, name: str) -> Optional[List[Tuple[str, float]]]:
        """``(name, ms)`` of each span the last replay of ``name``'s graph
        timed on the device, from the graph's start to the end of its
        copy-backs (None unless the graph was captured with
        ``phase_events``).  Read after a device sync."""
        runner = getattr(self.entries.get(name), "runner", None)
        marks = getattr(runner, "marks", None)
        return None if marks is None else marks.spans()

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

    def cost_samples(self, key: str) -> Iterable[Tuple[dict, float]]:
        """Latest cost per entry (flops / bytes_accessed / temp_bytes /
        ...): entries whose ``last`` record lacks ``key`` yield nothing."""
        for name, e in sorted(self.entries.items()):
            if key in e.last:
                yield ({"entry": name}, float(e.last[key]))

    def launch_samples(self) -> Iterable[Tuple[dict, float]]:
        for name in sorted(self.entries):
            n = self.launches_per_replay(name)
            if n is not None:
                yield ({"entry": name}, float(n))


def roofline_fold(book: CostBook, pipeline_stats: Dict[str, Any],
                  platform: Optional[str] = None) -> Dict[str, Any]:
    """Join the book's FLOPs and bytes with the stage clock's device
    seconds into achieved-against-peak fractions per stage.

    ``pipeline_stats`` is ``GameRole.pipeline_stats()`` (frames and per-
    stage mean/p50/p95 ms).  A stage's cost per frame is the sum over its
    entries of (cost per dispatch x dispatches) / frames.  An entry
    without a stage or without a cost record is skipped.  ``platform``
    defaults to ``"gpu"`` when a CUDA device is present, else ``"cpu"``."""
    if platform is None:
        platform = "gpu" if torch.cuda.is_available() else "cpu"
    peaks = PEAKS.get(platform, PEAKS["cpu"])
    frames = max(1, int(pipeline_stats.get("frames", 0)))
    stage_ms = pipeline_stats.get("stages", {})
    per_stage: Dict[str, Dict[str, Any]] = {}
    for name, e in sorted(book.entries.items()):
        if e.stage is None or not any(k in e.last for k in _COST_KEYS):
            continue
        s = per_stage.setdefault(e.stage, {
            "entries": [], "flops_per_frame": 0.0, "bytes_per_frame": 0.0,
        })
        s["entries"].append(name)
        s["flops_per_frame"] += e.last.get("flops", 0.0) * e.calls / frames
        s["bytes_per_frame"] += e.last.get("bytes_accessed", 0.0) * e.calls / frames
    for stage, s in per_stage.items():
        dev_s = float(stage_ms.get(stage, {}).get("mean_ms", 0.0)) / 1e3
        s["device_s_per_frame"] = dev_s
        if dev_s > 0:
            s["achieved_flops_per_s"] = s["flops_per_frame"] / dev_s
            s["achieved_bytes_per_s"] = s["bytes_per_frame"] / dev_s
            s["frac_of_peak_flops"] = s["achieved_flops_per_s"] / peaks["flops_per_s"]
            s["frac_of_peak_bytes"] = s["achieved_bytes_per_s"] / peaks["bytes_per_s"]
        else:
            s["achieved_flops_per_s"] = 0.0
            s["achieved_bytes_per_s"] = 0.0
            s["frac_of_peak_flops"] = 0.0
            s["frac_of_peak_bytes"] = 0.0
    return {
        "platform": platform,
        "provisional": str(peaks.get("source", "")).startswith("provisional"),
        "peaks": dict(peaks),
        "frames": frames,
        "stages": per_stage,
    }
