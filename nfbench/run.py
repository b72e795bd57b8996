"""One run of one benchmark cell.

    python -m nfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration, whose
file holds the deployment, and a traffic mix, ``nfbench/traffic/<mix>.json``,
which holds the entry a frame calls and the loop's parameters.  Each part
of a cell is a module found by name (:func:`named`), so a new cell comes
as added files: the configuration's ``kind`` names its deployment,
``nfbench/deployments/<kind>.py``, and its check,
``nfbench/checks/<kind>.py``; the traffic's ``entry`` names
``nfbench/entries/<entry>.py`` (``.`` written ``_``); every metric is read
by ``nfbench/metrics/<quantity>.py`` (the metric's name up to its first
dot).  :mod:`nfbench.program` says what a deployment and an entry expose.
The run:

1. builds the deployment from the seed on the card and copies its start
   state (set-up; ``setup_s`` runs from the process's start to the first
   timed frame);
2. prepares the entry and warms it up with ``warmup_frames`` frames (the
   captures);
3. runs a closed loop of frames for ``--seconds``: one frame is one call
   of the entry, ended by a device sync, and the next starts when it
   returns.  The states before and after an early frame (below
   ``early_frames``) and a late one (in ``late_frames``), both drawn from
   the seed, are copied between frames; with ``--trace 1`` the profiler
   records ``trace_frames`` frames from frame ``trace_from``;
4. reads the program's peak memory (the process's peak less the check's
   copies), frees the program, and checks the copies against the plain
   reference (the kind's check);
5. prints the numbers compared and their limits on standard error, and
   one JSON line on standard output: the end-to-end metrics with
   ``--trace 0``, the per-layer metrics with ``--trace 1``.

It exits non-zero with no result when no card (or too few) is present,
when a share of a peak reads above 100 %, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from .guard import forbidden_modules

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
CACHE = ROOT / ".nfbench_cache"


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def pin_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout (the CUDA kernels build into the program's own
    ``noahgameframe_tpu_torch/csrc/build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


# -- discovery ------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def named(package: str, name: str) -> ModuleType:
    """``nfbench/<package>/<name>.py``; a missing one is refused with an
    error that names the file."""
    module = f"nfbench.{package}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(f"no module nfbench/{package}/{name}.py") from None


def parts(found: dict) -> Tuple[ModuleType, ModuleType, ModuleType]:
    """The cell's deployment kind, entry and check modules."""
    kind = found["config"]["kind"]
    entry = found["traffic"]["entry"]
    dep = named("deployments", kind)
    ent = named("entries", entry.replace(".", "_"))
    chk = named("checks", kind)
    if kind not in ent.KINDS:
        raise ValueError(f"the entry {entry!r} drives no deployment of kind {kind!r}")
    return dep, ent, chk


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration and traffic mix read from their
    files, and its metrics (name -> entry), by name; the modules they name
    must be there."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def mine(m):
        return workload in m.get("workloads", [workload])

    found = {"cell": cell, "config": config, "traffic": traffic,
             "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
             "per_layer": [m for m in bench["per_layer"] if mine(m)]}
    parts(found)
    return found


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``nfbench/metrics/<quantity>.py``'s ``read``, where ``<quantity>``
    is the metric's name up to its first dot: a metric named
    ``frame_ms_p95.served`` would be the quantity ``frame_ms_p95`` in the
    cells it lists, under a bound of its own."""
    return named("metrics", metric.split(".")[0]).read


def derived_seed(seed: int) -> int:
    """The seed the deployment is built from: 30 bits of the run's seed,
    hashed, so that the world's key stays a 31-bit integer."""
    import numpy as np

    return int(np.random.SeedSequence(seed % (1 << 64)).generate_state(1)[0]) & ((1 << 30) - 1)


def check_frame(seed: int, stream: int, lo: int, hi: int = None) -> int:
    """A frame index from the seed: in ``[0, lo)``, or ``[lo, hi)``."""
    import numpy as np

    if hi is None:
        lo, hi = 0, lo
    return int(np.random.default_rng([seed % (1 << 64), stream]).integers(lo, hi))


# -- the run ----------------------------------------------------------------------


def run_cell(found: dict, seed: int, seconds: float, trace: bool, device,
             t_process: Callable[[], float], log=print) -> dict:
    """Set up, warm up, measure, check and read; returns the result line
    as a dict (``checks`` last)."""
    import torch

    from . import program
    from .trace import Tracer

    cfg, traffic = found["config"], found["traffic"]
    kind, ent, chk = parts(found)
    on_cuda = device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    def allocated():
        return torch.cuda.memory_allocated(device) if on_cuda else 0

    wseed = derived_seed(seed)
    t0 = time.perf_counter()
    dep = kind.deploy(cfg, wseed, device)
    sync()
    build_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    # the check's copies are the harness's: their bytes are taken out of
    # the peak that the result reports
    before = allocated()
    leaves = dep.leaves()
    start = program.Snapshot(leaves)
    start.take(leaves)
    checked = [program.Snapshot(leaves) for _ in range(4)]
    sync()
    copies_bytes = allocated() - before
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ent.prepare(dep)
    for _ in range(int(traffic["warmup_frames"])):
        ent.frame(dep)
    sync()
    warm_s = time.perf_counter() - t0
    k = check_frame(seed, 1, int(traffic["early_frames"]))
    late = check_frame(seed, 2, *traffic["late_frames"])
    # the checked frames' copies: before and after frame k, then late
    copy_at = {k: 0, late: 2}
    trace_from = int(traffic["trace_from"])
    trace_to = trace_from + int(traffic["trace_frames"])
    tracer = Tracer() if trace else None
    traced = False
    frame_s: List[float] = []
    gc.collect()
    sync()

    setup_s = t_process()
    w0 = time.perf_counter()
    deadline = w0 + float(seconds)
    i = 0
    while True:
        if i in copy_at:
            checked[copy_at[i]].take(dep.leaves())
        if tracer is not None and i == trace_from:
            tracer.start()
        f0 = time.perf_counter()
        ent.frame(dep)
        f1 = time.perf_counter()
        frame_s.append(f1 - f0)
        if i in copy_at:
            checked[copy_at[i] + 1].take(dep.leaves())
        i += 1
        if tracer is not None and i == trace_to:
            tracer.stop(trace_to - trace_from)
            traced = True
        if f1 >= deadline and i > late and (tracer is None or traced):
            break
    window_s = time.perf_counter() - w0
    tr = tracer.result() if tracer is not None else None
    if tr is not None and on_cuda and tr["busy_s"] <= 0:
        raise RuntimeError("the profiler recorded no device activity in the traced frames")

    dep.after_window()
    sync()
    peak = (max(build_peak, torch.cuda.max_memory_allocated(device) - copies_bytes)
            if on_cuda else 0)
    launches = dep.launches_per_replay(ent.BOOK)
    lay = dep.layout()
    entities = dep.entities
    dep.close()
    del dep
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats: Dict[str, int] = {}
    snaps = [s.as_rooms() for s in checked]
    numbers = chk.run_check(cfg, lay, chk.reference_inputs(cfg, wseed, device),
                            start.as_rooms(), snaps[:2], snaps[2:], stats=stats,
                            max_ticks=int(traffic["warmup_frames"]) + int(traffic["early_frames"]))
    check_s = time.perf_counter() - t0
    log(f"nfbench: build {build_s:.3f} s, warm-up {warm_s:.3f} s, setup {setup_s:.3f} s, "
        f"window {window_s:.3f} s, {len(frame_s)} frames, check {check_s:.3f} s "
        f"(frames {k} and {late}; {numbers['cells']} cells; {chk.describe(stats)}); "
        f"program peak {peak} B, check's copies {copies_bytes} B")

    run = {"entities": entities, "frames": len(frame_s), "window_s": window_s,
           "frame_s": frame_s, "setup_s": setup_s, "trace": tr,
           "traced_frames": (trace_from, trace_to) if traced else None, "launches": launches,
           **chk.readings(stats), "config": cfg, "traffic": traffic}
    wanted = found["per_layer"] if trace else found["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is None:
            continue
        if m["unit"] == "%" and value > 100.0:
            raise RuntimeError(f"{m['name']} reads {value} %: above 100 %, so its count "
                               "or its time is wrong")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
    result = {"correct": chk.passed(numbers), "attempted": len(frame_s), "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {n: {"value": numbers[n], "limit": lim} for n, lim in chk.LIMITS.items()}
    return result


def card_line() -> Optional[str]:
    """The card's name, SM clock, power draw and power limit, by nvidia-smi."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


def main(argv=None) -> int:
    age = process_age_s()
    t_main = time.perf_counter()

    def t_process() -> float:
        return (age or 0.0) + time.perf_counter() - t_main

    p = argparse.ArgumentParser(prog="python -m nfbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_caches()
    found = find_cell(load_benchmark(), args.workload)

    import torch

    chips = int(found["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(found, args.seed, args.seconds, bool(args.trace), device, t_process,
                      log=log)
    card = card_line()
    if card:
        print(f"nfbench card: {card}", flush=True)
    bad = forbidden_modules()
    if bad:
        log(f"nfbench: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
