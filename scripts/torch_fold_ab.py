#!/usr/bin/env python3
"""Time the PyTorch port's two fold kernels on one CUDA card at the
1M-entity geometry: against another checkout's kernels, and under each
tile shape the planner could pick.

    python3 scripts/torch_fold_ab.py [--base DIR] [--reps 20]

``--base DIR`` names a checkout (for example a parent commit unpacked with
``git archive``) whose ``noahgameframe_tpu_torch`` kernels are timed in
turns with this checkout's on the same tables: base, this, this, base.
Every time is the mean of ``--reps`` launches by CUDA events after three
warm-up launches, as ``chip_smoke.py`` times them.  Then each kernel runs
under every tile shape of ``TILES`` that fits a block (outputs checked
equal to the planner's), the fused kernel's row tables and its fold are
timed apart, and the card's name and power limit are printed.  Prints one
JSON line; exits non-zero without a CUDA device.

``--variants`` builds copies of csrc/stencil.cu with one design choice
changed each (``VARIANTS``) and times both kernels under each at the
planned tiles, outputs checked equal to this checkout's.

``--probes`` also builds copies of csrc/stencil.cu cut short after each
phase of the tile kernels (staging; compaction; the fused kernel's
gathers) and times them at the planned tile: the time a phase adds is the
difference between successive probes.  Their outputs are not results.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from noahgameframe_tpu_torch.ops import stencil as sc  # noqa: E402
from noahgameframe_tpu_torch.ops import stencil_cuda as sck  # noqa: E402


def load_base(directory: Path):
    """The stencil_cuda module of another checkout, as package nf_base."""
    pkg = directory / "noahgameframe_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "nf_base", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["nf_base"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("nf_base.ops.stencil_cuda")


# phase markers of the tile kernels in csrc/stencil.cu: a probe returns
# right before the marked phase
PROBES = {
    "combat": ["  // 2. compact each halo cell's attackers",
               "  // 2b. each tile cell's shifts with live attackers",
               "  // 3. fold each victim slot of the tile over the live shifts' lists"],
    "fused": ["  // 2. compact the occupied slots, in slot order, into row lists",
              "  // 3. gather the listed bank rows",
              "  // 4. fold: lanes take the tile's occupied victims"],
}


# design choices of csrc/stencil.cu, each changed by source edits (old,
# new) and optionally launched under other plan fields; each edited
# library is timed beside this checkout's
_MAX_THREADS = "#define NF_MAX_THREADS 256"
_COMBAT_CAP = "#define NF_COMBAT_MIN_BLOCKS 4"
VARIANTS = {
    "combat_batch_2": ([("#define NF_VBATCH 4", "#define NF_VBATCH 2")], {}),
    "combat_batch_8": ([("#define NF_VBATCH 4", "#define NF_VBATCH 8")], {}),
    "combat_no_register_cap": ([(_COMBAT_CAP, "#define NF_COMBAT_MIN_BLOCKS 1")], {}),
    "threads_512": ([(_MAX_THREADS, "#define NF_MAX_THREADS 512"),
                     (_COMBAT_CAP, "#define NF_COMBAT_MIN_BLOCKS 2")], {"threads": 512}),
    "aoi_unroll_1": ([("#pragma unroll 4\n    for (int j = base + cs[cx];",
                       "#pragma unroll 1\n    for (int j = base + cs[cx];")], {}),
    "aoi_unroll_8": ([("#pragma unroll 4\n    for (int j = base + cs[cx];",
                       "#pragma unroll 8\n    for (int j = base + cs[cx];")], {}),
    "fused_register_cap_64": ([(
        "__global__ void __launch_bounds__(NF_MAX_THREADS)\n    fused_neighborhood_kernel(",
        "__global__ void __launch_bounds__(NF_MAX_THREADS, 4)\n    fused_neighborhood_kernel(")],
        {}),
}


def build_source(name: str, src: str):
    """Build ``src`` as a library named ``name`` with the same flags and
    bind it like :func:`sck.library`."""
    import ctypes

    sck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = sck.BUILD_DIR / f"{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([sck._nvcc(), *sck.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ref = sck.library()
    for fn in ("nf_combat_fold", "nf_fused_neighborhood"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_variant(name: str):
    src = sck.SOURCE.read_text()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise ValueError(f"variant {name}: source text not found: {old!r}")
        src = src.replace(old, new)
    return build_source(f"variant_{name}", src)


def build_probe(kind: str, stage: int):
    """A library whose ``kind`` tile kernel returns before phase ``stage``."""
    src = sck.SOURCE.read_text()
    start = src.index("combat_fold_kernel(" if kind == "combat" else
                      "fused_neighborhood_kernel(const float*")
    marker = PROBES[kind][stage]
    at = src.index(marker, start)
    src = src[:at] + "  return;\n" + src[at:]
    return build_source(f"probe_{kind}_{stage}", src)


def combat_only(lib, vt, at, w, kv, ka, r2, plan, out):
    """The combat fold launch through ``lib`` (one world: R = 1)."""
    err = lib.nf_combat_fold(
        vt.payload.data_ptr(), at.payload.data_ptr(), 1, w, w, kv, ka, r2,
        *sck._plan_args(plan), *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream)
    sck._raise_on(sck.library(), err, "combat_fold_kernel")


def fused_fold_only(bank, vtab, atab, w, kv, ka, r2, plan, out, lib=None):
    """The fused fold launch alone, on prebuilt row tables (R = 1)."""
    lib = lib or sck.library()
    err = lib.nf_fused_neighborhood(
        bank.data_ptr(), vtab.data_ptr(), atab.data_ptr(), 1, bank.shape[0], w, w, kv, ka, r2,
        *sck._plan_args(plan), *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream)
    sck._raise_on(lib, err, "fused_neighborhood_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fold_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = 1 << int(np.ceil(np.log2(cs.N_MAIN)))
    extent = float(np.sqrt(cs.N_MAIN / 0.4))
    cell = radius = 4.0
    w = int(extent / cell)
    kv = sc.auto_bucket(cap, w)
    ka = sc.auto_bucket(int(np.ceil(cap / 30)), w, lo=4, align=2)
    pop = cs.population(cs.N_MAIN, cap, extent, 1)
    vt, at = sc.build_cell_table_pair(pop["pos"], pop["alive"], pop["vic"],
                                      pop["attacking"], pop["att"], cell, w, kv, ka)
    vs, ats = sc.build_cell_slots_pair(pop["pos"], pop["alive"], pop["attacking"],
                                       cell, w, kv, ka)
    bank, n = pop["bank"], pop["bank"].shape[0]
    reps = args.reps
    t = lambda fn: cs.time_ms(fn, reps=reps)  # noqa: E731
    out = {"card": smi, "geometry": {"width": w, "kv": kv, "ka": ka}, "reps": reps}

    k1 = lambda m: (lambda: m.combat_fold(vt, at, radius))  # noqa: E731
    k2 = lambda m: (lambda: m.fused_neighborhood(bank, vs, ats, radius))  # noqa: E731
    if args.base is not None:
        base = load_base(args.base.resolve())
        for name, k in (("combat_fold", k1), ("fused_neighborhood", k2)):
            a, b = k(base), k(sck)
            want = [x.clone() for x in b()]
            check_eq = all(torch.equal(x, y) for x, y in zip(a(), want))
            out[f"ab_{name}"] = {"base_ms": [t(a)], "this_ms": [t(b), t(b)],
                                 "outputs_equal": check_eq}
            out[f"ab_{name}"]["base_ms"].append(t(a))

    r2 = float(radius) * float(radius)
    want1 = sck.combat_fold(vt, at, radius)
    want2 = sck.fused_neighborhood(bank, vs, ats, radius)
    vtab, atab = sck.row_tables(vs, ats, n)
    variants = {"combat_fold": {}, "fused_neighborhood": {}, "fused_fold_only": {}}
    for ty, tx in sck.TILES:
        for kind in ("combat", "fused"):
            smem = sck.tile_bytes(kind, ty, tx, kv, ka)
            if smem > sck.SMEM_LIMIT:
                continue
            for threads in (128, 256):
                plan = sck.FoldPlan(kind, w, ty, tx, threads, smem, 0)
                key = f"{ty}x{tx}/{threads}t/{smem}B"
                if kind == "combat":
                    got = sck.combat_fold_planned(vt, at, radius, plan)
                    same = all(torch.equal(x, y) for x, y in zip(got, want1))
                    variants["combat_fold"][key] = [
                        t(lambda: sck.combat_fold_planned(vt, at, radius, plan)), same]
                else:
                    got = sck.fused_neighborhood_planned(bank, vs, ats, radius, plan)
                    same = all(torch.equal(x, y) for x, y in zip(got, want2))
                    variants["fused_neighborhood"][key] = [t(
                        lambda: sck.fused_neighborhood_planned(bank, vs, ats, radius, plan)),
                        same]
                    res = [torch.empty_like(want2[0]) for _ in range(3)]
                    variants["fused_fold_only"][key] = [t(
                        lambda: fused_fold_only(bank, vtab, atab, w, kv, ka, r2, plan, res)),
                        same]
    out["variants"] = variants
    if args.variants:
        plans = {kind: sck.plan_fold(kind, w, kv, ka) for kind in ("combat", "fused")}
        res1 = [torch.empty_like(want1[0]) for _ in range(2)]
        res2 = [torch.empty_like(want2[0]) for _ in range(3)]
        timed = {}
        for name in ["this", *VARIANTS]:
            lib = sck.library() if name == "this" else build_variant(name)
            fields = {} if name == "this" else VARIANTS[name][1]
            p1, p2 = plans["combat"]._replace(**fields), plans["fused"]._replace(**fields)
            f1 = lambda: combat_only(lib, vt, at, w, kv, ka, r2, p1, res1)  # noqa: E731
            f2 = lambda: fused_fold_only(  # noqa: E731
                bank, vtab, atab, w, kv, ka, r2, p2, res2, lib)
            f1(), f2()
            same = (all(torch.equal(x, y) for x, y in zip(res1, want1))
                    and all(torch.equal(x, y) for x, y in zip(res2, want2)))
            timed[name] = {"combat_ms": t(f1), "fused_fold_ms": t(f2), "outputs_equal": same}
        timed["this_again"] = {"combat_ms": t(lambda: combat_only(
            sck.library(), vt, at, w, kv, ka, r2, plans["combat"], res1)), "fused_fold_ms": t(
            lambda: fused_fold_only(bank, vtab, atab, w, kv, ka, r2, plans["fused"], res2))}
        out["source_variants"] = timed
    if args.probes:
        probes = {}
        res1 = [torch.empty_like(want1[0]) for _ in range(2)]
        res2 = [torch.empty_like(want2[0]) for _ in range(3)]
        plans = {kind: sck.plan_fold(kind, w, kv, ka) for kind in ("combat", "fused")}
        for kind, plan in plans.items():
            for stage in range(len(PROBES[kind])):
                lib = build_probe(kind, stage)
                if kind == "combat":
                    fn = lambda: combat_only(lib, vt, at, w, kv, ka, r2, plan, res1)  # noqa: E731
                else:
                    fn = lambda: fused_fold_only(  # noqa: E731
                        bank, vtab, atab, w, kv, ka, r2, plan, res2, lib)
                probes[f"{kind}_before_phase_{stage + 2}"] = t(fn)
        probes["combat_full"] = t(lambda: combat_only(
            sck.library(), vt, at, w, kv, ka, r2, plans["combat"], res1))
        probes["fused_full"] = t(lambda: fused_fold_only(
            bank, vtab, atab, w, kv, ka, r2, plans["fused"], res2))
        out["probes"] = probes
    out["planned"] = {k: list(sck.plan_fold(k, w, kv, ka)[2:]) for k in ("combat", "fused")}
    # host time of one wrapper call, launch included (the card idles if a
    # kernel is shorter)
    for name, fn in (("combat_fold", k1(sck)), ("fused_neighborhood", k2(sck))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"host_ms_{name}"] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
    out["row_tables_ms"] = t(lambda: sck.row_tables(vs, ats, n))
    out["slot_rows_plain_ms"] = t(lambda: (sck.slot_rows(vs, n), sck.slot_rows(ats, n)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
