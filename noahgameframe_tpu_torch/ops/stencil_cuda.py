"""The combat stencil folds and the tick's threefry stream: hand-written
CUDA kernels and their plain PyTorch versions.

Two kernels in ``csrc/stencil.cu`` replace the JAX package's two Pallas
kernels (``noahgameframe_tpu/ops/stencil_pallas.py``):

- :func:`combat_fold` (engine 1) replaces ``combat_fold_pallas``: the 3x3
  combat fold over the split victim/attacker cell tables.  Its plain
  version, :func:`combat_fold_plain`, is engine 0, the port of the XLA
  fold (``game/combat.py:combat_fold_xla``).
- :func:`fused_neighborhood` (engine 2) replaces ``fused_neighborhood``:
  the same fold gathered straight from a ``[N, 6]`` feature bank through
  the slot assignments, plus the AOI occupancy count ``nbr``.  Its plain
  version is :func:`fused_neighborhood_plain`.

Two more kernels of the same file compute the tick's threefry stream in
native uint32 arithmetic (``core/prng.py`` emulates it with int64 ops):

- :func:`wander` replaces the JAX package's movement phase
  (``game/movement.py``'s ``_move_phase``): the seek step, the threefry
  draw of fresh targets and the target refresh in one launch.  Its plain
  version, :func:`wander_plain`, is the port's composite phase.
- :func:`fold_in` replaces ``jax.random.fold_in`` of the tick key and of
  ``ctx.rng()``: one launch for what the int64 emulation takes ~180 ops
  for.  Its plain version, :func:`fold_in_plain`, is ``core/prng.py``'s.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; it never falls back.  The
kernels are built with ``nvcc`` for ``sm_90a`` at first use into
``csrc/build/`` (:func:`library`) and loaded with ctypes.  Each wrapper
counts its launches in ``KERNELS[name].launches``.

:func:`plan_fold` picks each launch's tile of cells, threads and shared
memory from the grid width and buckets (or the chunk kernels, when not
even a one-cell tile's halo fits a block); :func:`combat_fold_planned`
and :func:`fused_neighborhood_planned` launch under a given plan.  The
fused kernel reads its row tables from :func:`row_tables` (a fill and one
scatter launch), whose plain version is :func:`slot_rows`.

Feature layouts (floats; every int column is exact below 2^24):

    victim payload   [n_cells*Kv + 1, 6]: x, y, camp, scene, group, occ
    attacker payload [n_cells*Ka + 1, 8]: x, y, eff_atk, camp, scene,
                                          group, row, occ
    bank             [N, 6]:              x, y, camp, scene, group, eff_atk

A pair counts for combat when ``dx*dx + dy*dy <= r*r``, the square sum
rounded as the reference rounds it, ``fma(dx, dx, dy*dy)`` (see
core/rounding.py), ``eff_atk != 0``, the camps differ (which also
rules out self) and scene and group are equal.  Per shift, the damage sum
is taken in float32 and truncated into the int32 total; the best attacker
is the largest attack, ties to the smallest row.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.rounding import fma32, sqrt32
from .interest import scope_mask
from .stencil import CellSlots, CellTable, stencil_fold

# "no attacker" sentinel for the float best-row carry: 2^24, exactly
# representable and above every row id (< 2^24)
NO_ROW = 16777216.0

V_FEATS = 5  # victim payload columns before occupancy
A_FEATS = 7  # attacker payload columns before occupancy
B_FEATS = 6  # bank columns

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "stencil.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no implicit FMA contraction: the one fused multiply-add the folds
    # need is written out (__fmaf_rn), so pairs on the radius boundary
    # round exactly as the reference rounds them
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class CudaKernel:
    """One kernel of csrc/stencil.cu: its name, what it replaces, and a
    plain-integer count of launches made by its wrapper."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0


KERNELS = {
    "combat_fold": CudaKernel(
        "combat_fold", "noahgameframe_tpu/ops/stencil_pallas.py:133"),
    "fused_neighborhood": CudaKernel(
        "fused_neighborhood", "noahgameframe_tpu/ops/stencil_pallas.py:426"),
    "wander": CudaKernel("wander", "noahgameframe_tpu/game/movement.py:42"),
    "fold_in": CudaKernel("fold_in", "noahgameframe_tpu/kernel/kernel.py:401"),
    # csrc/buff.cu, launched by ops/buff_cuda.py
    "buff_fold": CudaKernel("buff_fold", "noahgameframe_tpu/game/buff.py:157"),
}


# nf-lint custom-op-parity-pinned registry (lint/rules_cuda.py): every
# torch.library.custom_op of this module, keyed to the card-only test file
# that holds its wrapper against its plain version
CUSTOM_OP_PARITY_TESTS = {
    "nf::combat_fold": "tests/test_torch_cuda.py",
    "nf::slot_rows": "tests/test_torch_cuda.py",
    "nf::fused_neighborhood": "tests/test_torch_cuda.py",
    "nf::wander": "tests/test_torch_cuda.py",
    "nf::fold_in": "tests/test_torch_cuda.py",
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# -- plain versions -------------------------------------------------------


def combat_fold_closure(v: torch.Tensor, radius: float):
    """(fold, init) over a victim grid v [H, W, Kv, >=5] (x, y, camp,
    scene, group): the engine-0 fold body, a port of the JAX package's
    ``combat_fold_closure``.  Candidate blocks carry x, y, eff_atk, camp,
    scene, group, row."""
    vx, vy = v[..., 0], v[..., 1]
    vcamp, vscene, vgroup = v[..., 2, None], v[..., 3, None], v[..., 4, None]
    r2 = float(radius) * float(radius)

    def fold(acc, cand):
        inc, besta, bestr = acc
        c = cand[:, :, None]  # [H, W, 1, Ka, F]
        dx = vx[..., None] - c[..., 0]
        dy = vy[..., None] - c[..., 1]
        ca = c[..., 2]
        ok = (
            (fma32(dx, dx, dy * dy) <= r2)
            & (ca != 0)  # a real attacker (empty slots carry 0)
            & (c[..., 3] != vcamp)  # no friendly fire (also self)
            & (c[..., 4] == vscene)
            & (c[..., 5] == vgroup)
        )
        inc = inc + torch.sum(torch.where(ok, ca, 0.0), dim=-1).to(torch.int32)
        # strongest attacker, ties to the minimum row id; a shift with no
        # attacker has m == -1 and its `first` is discarded
        sa = torch.where(ok, ca, -1.0)
        m = sa.amax(dim=-1)
        first = torch.where(sa >= m[..., None], c[..., 6], NO_ROW).amin(dim=-1)
        first = torch.where(m >= 0.0, first, NO_ROW)
        # lexicographic (max attack, min row) merge
        top = torch.maximum(besta, m)
        bestr = torch.minimum(
            torch.where(m >= top, first, NO_ROW),
            torch.where(besta >= top, bestr, NO_ROW),
        )
        return inc, top, bestr

    shape, dev = v.shape[:3], v.device
    init = (
        torch.zeros(shape, dtype=torch.int32, device=dev),
        torch.full(shape, -1.0, dtype=torch.float32, device=dev),
        torch.full(shape, NO_ROW, dtype=torch.float32, device=dev),
    )
    return fold, init


def _best_rows(bestr: torch.Tensor) -> torch.Tensor:
    return torch.where(bestr >= NO_ROW, -1.0, bestr).to(torch.int32)


def combat_fold_plain(vic_table: CellTable, att_table: CellTable, radius: float):
    """Engine 0: the fold over the split tables in plain PyTorch.
    Returns (inc [H, W, Kv] int32, bestr [H, W, Kv] int32, -1 = none)."""
    fold, init = combat_fold_closure(vic_table.grid_view(), radius)
    inc, _besta, bestr = stencil_fold(att_table.grid_view(), fold, init)
    return inc, _best_rows(bestr)


def slot_rows(slots: CellSlots, n: int) -> torch.Tensor:
    """CellSlots -> [H, W, K] int32 row ids per slot; empty slots hold
    the sentinel ``n`` (a zero feature row)."""
    w, k = slots.width, slots.bucket
    dump = w * w * k
    dev = slots.slot_of.device
    idx = torch.full((dump + 1,), n, dtype=torch.int32, device=dev).scatter(
        0, slots.slot_of.long(), torch.arange(n, dtype=torch.int32, device=dev))
    return idx[:dump].reshape(w, w, k)


def fused_neighborhood_plain(bank: torch.Tensor, vic_slots: CellSlots,
                             att_slots: CellSlots, radius: float):
    """The fused fold in plain PyTorch: gather victims and attackers from
    ``bank`` through the slot assignments, fold combat like engine 0, and
    count AOI neighbors (occupied, within radius, ``scope_mask`` scope,
    not self).  Returns (inc, bestr, nbr), each [H, W, Kv] int32."""
    n = bank.shape[0]
    bankp = torch.cat([bank, bank.new_zeros((1, B_FEATS))])
    vidx = slot_rows(vic_slots, n).long()
    aidx = slot_rows(att_slots, n).long()
    v = bankp[vidx]  # [H, W, Kv, 6]
    a = bankp[aidx]
    att = torch.stack([a[..., 0], a[..., 1], a[..., 5], a[..., 2], a[..., 3],
                       a[..., 4], aidx.to(torch.float32)], dim=-1)
    fold, init = combat_fold_closure(v, radius)
    inc, _besta, bestr = stencil_fold(att, fold, init)

    vrow = vidx.to(torch.float32)[..., None]
    vx, vy = v[..., 0, None], v[..., 1, None]
    vscene, vgroup = v[..., 3, None], v[..., 4, None]
    r2 = float(radius) * float(radius)
    cands = torch.stack([v[..., 0], v[..., 1], v[..., 3], v[..., 4],
                         (vidx < n).to(torch.float32), vidx.to(torch.float32)], dim=-1)

    def count(acc, cand):
        c = cand[:, :, None]
        dx = vx - c[..., 0]
        dy = vy - c[..., 1]
        near = (
            (fma32(dx, dx, dy * dy) <= r2)
            & (c[..., 4] != 0)
            & scope_mask(c[..., 2], c[..., 3], vscene, vgroup)
            & (c[..., 5] != vrow)
        )
        return acc + torch.sum(near, dim=-1, dtype=torch.int32)

    nbr = stencil_fold(cands, count, torch.zeros_like(inc))
    return inc, _best_rows(bestr), nbr


# -- the launch planner --------------------------------------------------------

SMEM_LIMIT = 232_448  # the most shared memory one H100 block may use
# a tile within this leaves room for four blocks on one SM
SMEM_TARGET = 48 * 1024
# tile shapes (rows, columns of cells), largest first
TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
MAX_THREADS = 256
CHUNK_SLOTS = 1024  # slots a chunk streams at most


def _up16(b: int) -> int:
    return (b + 15) & ~15


def combat_tile_bytes(ty: int, tx: int, kv: int, ka: int) -> int:
    """Shared memory of one combat_fold_kernel tile: the attacker halo
    rows (32 B a slot), per-cell counts and shift masks, and the origin
    flag (csrc/stencil.cu FoldTile).  Victim rows stream from global
    memory."""
    aseg = _up16((tx + 2) * ka * 32) + 16
    return (ty + 2) * aseg + _up16((ty + 2) * (tx + 2) * 4) + _up16(ty * tx * 4) + 16


def fused_tile_bytes(ty: int, tx: int, kv: int, ka: int) -> int:
    """Shared memory of one fused_neighborhood_kernel tile: the halo's
    index rows, the gathered victim lists (28 B an entry, packed per halo
    row) and attacker lists (28 B an entry, an odd stride per cell), the
    tile's slot flags, the cell starts and counts, the tile cells' starts
    and the flag (FusedTile)."""
    nh = (ty + 2) * (tx + 2)
    nv, na = nh * kv, nh * (ka | 1)
    vseg = _up16((tx + 2) * kv * 4) + 16
    aseg = _up16((tx + 2) * ka * 4) + 16
    b = _up16(nv * 16 + na * 16 + na * 8)
    b = _up16(b + (ty + 2) * (vseg + aseg) + nv * 4)  # index rows, vrow
    b = _up16(b + nv * 4)  # vcamp
    b = _up16(b + nv * 4)  # vslot
    b = _up16(b + na * 4)  # arow
    b = _up16(b + ty * tx * kv * 4)  # vpos
    b = _up16(b + (ty + 2) * (tx + 3) * 4)  # cstart
    b = _up16(b + nh * 4)  # acount
    b = _up16(b + (ty * tx + 1) * 4)  # ostart
    return b + 16


def tile_bytes(kind: str, ty: int, tx: int, kv: int, ka: int) -> int:
    """Shared memory of one tile-kernel block of ``kind``."""
    return (combat_tile_bytes if kind == "combat" else fused_tile_bytes)(ty, tx, kv, ka)


# bytes a streamed slot takes in the chunk kernels, and their fixed pad
_CHUNK_BYTES = {"combat": (32, 16), "fused": (28, 0)}


class FoldPlan(NamedTuple):
    """One launch of a fold kernel over an [H, W] grid (H == W).

    chunk == 0: the tile kernel, one block per ty x tx tile in row-major
    order; chunk > 0: the chunk kernel, one block per cell streaming
    ``chunk`` slots at a time.  ``smem`` is the dynamic shared memory of a
    block."""

    kind: str
    width: int
    ty: int
    tx: int
    threads: int
    smem: int
    chunk: int

    @property
    def blocks(self) -> int:
        w = self.width
        return -(-w // self.ty) * -(-w // self.tx)

    def tiles(self):
        """(y0, x0, rows, cols) of every block's tile, clipped to the grid,
        as numpy arrays in block order."""
        import numpy as np

        w = self.width
        b = np.arange(self.blocks, dtype=np.int64)
        gx = -(-w // self.tx)
        y0, x0 = (b // gx) * self.ty, (b % gx) * self.tx
        return y0, x0, np.minimum(self.ty, w - y0), np.minimum(self.tx, w - x0)


@functools.lru_cache(maxsize=256)
def plan_fold(kind: str, width: int, kv: int, ka: int,
              smem_limit: int = SMEM_LIMIT) -> FoldPlan:
    """Tile and block shape for one fold launch.  The first tile of TILES
    (clipped to the grid) whose shared memory is within SMEM_TARGET; else
    the one-cell tile if it fits ``smem_limit`` (the card's most per
    block); else the chunk kernel with as many slots per chunk as fit.
    Raises when nothing fits."""
    if kind not in _CHUNK_BYTES:
        raise ValueError(f"unknown fold kind {kind!r}")
    target = min(SMEM_TARGET, smem_limit)
    pick = None
    for ty, tx in TILES:
        ty, tx = max(1, min(ty, width)), max(1, min(tx, width))
        if tile_bytes(kind, ty, tx, kv, ka) <= target:
            pick = (ty, tx)
            break
    if pick is None and tile_bytes(kind, 1, 1, kv, ka) <= smem_limit:
        pick = (1, 1)
    if pick is not None:
        ty, tx = pick
        threads = min(MAX_THREADS, max(128, -(-ty * tx * kv // 32) * 32))
        return FoldPlan(kind, width, ty, tx, threads, tile_bytes(kind, ty, tx, kv, ka), 0)
    per_slot, pad = _CHUNK_BYTES[kind]
    chunk = min(CHUNK_SLOTS, max(kv, ka, 1), (smem_limit - pad) // per_slot)
    if chunk < 1:
        raise ValueError(f"no {kind} fold plan fits {smem_limit} B of shared memory")
    threads = min(MAX_THREADS, max(32, -(-kv // 32) * 32))
    return FoldPlan(kind, width, 1, 1, threads, chunk * per_slot + pad, chunk)


# -- the CUDA library --------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG: Optional[str] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA stencil kernels cannot be built")
    return found


def build_library(source: Path, stem: str) -> Tuple[ctypes.CDLL, str]:
    """Build ``source`` with ``nvcc`` (once per source version and flags)
    into ``csrc/build/<stem>_<tag>.so`` and load it; returns the library
    and the compiler's output, kept beside it."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}_{tag}.so"
    log = BUILD_DIR / f"{stem}_{tag}.log"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """Build (once per source version) and load csrc/stencil.cu."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = build_library(SOURCE, "libnf_stencil")
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.nf_combat_fold.argtypes = [p, p, i, i, i, i, i, f, i, i, i, i, i, p, p, p]
    lib.nf_combat_fold.restype = i
    lib.nf_slot_rows.argtypes = [p, p, i, i, q, q, p, p, p]
    lib.nf_slot_rows.restype = i
    lib.nf_fused_neighborhood.argtypes = [p, p, p, i, i, i, i, i, i, f, i, i, i, i, i,
                                          p, p, p, p]
    lib.nf_fused_neighborhood.restype = i
    lib.nf_fold_in.argtypes = [p, p, i, ctypes.c_uint, i, p, p]
    lib.nf_fold_in.restype = i
    lib.nf_wander.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, f, q, p, p]
    lib.nf_wander.restype = i
    lib.nf_error_string.argtypes = [i]
    lib.nf_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.nf_error_string(err).decode()}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on(device: torch.device):
    """The device as the current one for a launch; no switch when it
    already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _plan_args(plan: FoldPlan):
    return plan.ty, plan.tx, plan.threads, plan.smem, plan.chunk


# -- the custom ops ------------------------------------------------------------
#
# Each kernel is a torch.library custom op (nf::combat_fold,
# nf::slot_rows, nf::fused_neighborhood) over plain tensors and the launch
# plan's integers, with a fake (shape-only) version and a vmap rule.  The
# op's own implementation launches one world (R = 1); under
# torch.func.vmap the rule moves the room axis to the front, makes the
# tensors contiguous and makes ONE launch for all R rooms (the grid holds
# R x the room's blocks).  JAX batches a pallas_call under vmap by adding
# a grid dimension; these rules are that dimension written out.  Only CUDA
# tensors reach the ops: the wrappers below give the CPU the plain
# versions, which batch under vmap on their own.


def _room_front(x: torch.Tensor, dim: Optional[int], rooms: int) -> torch.Tensor:
    """``x`` with its room axis first and contiguous; an input that is not
    batched is expanded to every room."""
    if dim is None:
        x = x.unsqueeze(0).expand(rooms, *x.shape)
    else:
        x = x.movedim(dim, 0)
    return x.contiguous()


def _rooms_of(lead: Tuple[int, ...], per_room: int = 1) -> int:
    """The room count of a launch over ``lead`` (``()``: one world,
    ``(R,)``: R rooms laid out back to back); raises when R x the room's
    ``per_room`` blocks exceed one grid dimension (2^31 - 1)."""
    rooms = lead[0] if lead else 1
    if rooms * per_room > 0x7FFFFFFF:
        raise ValueError(f"{rooms} rooms of {per_room} blocks exceed one launch's grid")
    return rooms


def _fold_rooms(lead: Tuple[int, ...], width: int, plan: Tuple[int, ...]) -> int:
    """:func:`_rooms_of` for a fold launched under ``plan``."""
    ty, tx, _threads, _smem, chunk = plan
    return _rooms_of(lead, width * width if chunk else -(-width // ty) * -(-width // tx))


def _launch_combat(vp: torch.Tensor, ap: torch.Tensor, lead: Tuple[int, ...], width: int,
                   kv: int, ka: int, r2: float, plan: Tuple[int, ...]):
    """combat_fold_kernel over the rooms of ``lead`` (``()``: one world,
    ``(R,)``: R rooms laid out back to back)."""
    dev = vp.device
    if dev.type != "cuda":
        raise ValueError(f"combat_fold_kernel runs on cuda, not {dev}")
    rooms = _fold_rooms(lead, width, plan)
    _check(vp, "victim payload", torch.float32, (*lead, width * width * kv + 1, V_FEATS + 1), dev)
    _check(ap, "attacker payload", torch.float32, (*lead, width * width * ka + 1, A_FEATS + 1),
           dev)
    inc = torch.empty((*lead, width, width, kv), dtype=torch.int32, device=dev)
    bestr = torch.empty_like(inc)
    lib = library()
    with _on(dev):
        err = lib.nf_combat_fold(
            vp.data_ptr(), ap.data_ptr(), rooms, width, width, kv, ka, r2,
            *plan, inc.data_ptr(), bestr.data_ptr(), _stream(dev))
    _raise_on(lib, err, "combat_fold_kernel")
    KERNELS["combat_fold"].launches += 1
    return inc, bestr


def _launch_slot_rows(vslot: torch.Tensor, aslot: torch.Tensor, lead: Tuple[int, ...],
                      width: int, kv: int, ka: int):
    """slot_rows_kernel (and the two zero fills) over the rooms of ``lead``."""
    dev = vslot.device
    if dev.type != "cuda":
        raise ValueError(f"slot_rows_kernel runs on cuda, not {dev}")
    n = vslot.shape[-1]
    rooms = _rooms_of(lead, -(-n // 256))
    _check(vslot, "victim slot_of", torch.int32, (*lead, n), dev)
    _check(aslot, "attacker slot_of", torch.int32, (*lead, n), dev)
    vtab = torch.empty((*lead, width, width, kv), dtype=torch.int32, device=dev)
    atab = torch.empty((*lead, width, width, ka), dtype=torch.int32, device=dev)
    lib = library()
    with _on(dev):
        err = lib.nf_slot_rows(
            vslot.data_ptr(), aslot.data_ptr(), rooms, n, width * width * kv,
            width * width * ka, vtab.data_ptr(), atab.data_ptr(), _stream(dev))
    _raise_on(lib, err, "slot_rows_kernel")
    return vtab, atab


def _launch_fused(bank: torch.Tensor, vtab: torch.Tensor, atab: torch.Tensor,
                  lead: Tuple[int, ...], width: int, kv: int, ka: int, r2: float,
                  plan: Tuple[int, ...]):
    """fused_neighborhood_kernel over the rooms of ``lead``."""
    dev = bank.device
    if dev.type != "cuda":
        raise ValueError(f"fused_neighborhood_kernel runs on cuda, not {dev}")
    rooms = _fold_rooms(lead, width, plan)
    n = bank.shape[-2]
    _check(bank, "bank", torch.float32, (*lead, n, B_FEATS), dev)
    _check(vtab, "victim row table", torch.int32, (*lead, width, width, kv), dev)
    _check(atab, "attacker row table", torch.int32, (*lead, width, width, ka), dev)
    inc = torch.empty((*lead, width, width, kv), dtype=torch.int32, device=dev)
    bestr = torch.empty_like(inc)
    nbr = torch.empty_like(inc)
    lib = library()
    with _on(dev):
        err = lib.nf_fused_neighborhood(
            bank.data_ptr(), vtab.data_ptr(), atab.data_ptr(), rooms, n, width, width, kv, ka,
            r2, *plan, inc.data_ptr(), bestr.data_ptr(), nbr.data_ptr(), _stream(dev))
    _raise_on(lib, err, "fused_neighborhood_kernel")
    KERNELS["fused_neighborhood"].launches += 1
    return inc, bestr, nbr


@torch.library.custom_op("nf::combat_fold", mutates_args=())
def _combat_fold_op(vic: torch.Tensor, att: torch.Tensor, width: int, kv: int, ka: int,
                    r2: float, ty: int, tx: int, threads: int, smem: int,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_combat(vic, att, (), width, kv, ka, r2, (ty, tx, threads, smem, chunk))


@_combat_fold_op.register_fake
def _(vic, att, width, kv, ka, r2, ty, tx, threads, smem, chunk):
    shape = (width, width, kv)
    return vic.new_empty(shape, dtype=torch.int32), vic.new_empty(shape, dtype=torch.int32)


@torch.library.register_vmap("nf::combat_fold")
def _(info, in_dims, vic, att, width, kv, ka, r2, ty, tx, threads, smem, chunk):
    r = info.batch_size
    out = _launch_combat(_room_front(vic, in_dims[0], r), _room_front(att, in_dims[1], r),
                         (r,), width, kv, ka, r2, (ty, tx, threads, smem, chunk))
    return out, (0, 0)


@torch.library.custom_op("nf::slot_rows", mutates_args=())
def _slot_rows_op(vslot: torch.Tensor, aslot: torch.Tensor, width: int, kv: int,
                  ka: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_slot_rows(vslot, aslot, (), width, kv, ka)


@_slot_rows_op.register_fake
def _(vslot, aslot, width, kv, ka):
    return (vslot.new_empty((width, width, kv), dtype=torch.int32),
            vslot.new_empty((width, width, ka), dtype=torch.int32))


@torch.library.register_vmap("nf::slot_rows")
def _(info, in_dims, vslot, aslot, width, kv, ka):
    r = info.batch_size
    out = _launch_slot_rows(_room_front(vslot, in_dims[0], r), _room_front(aslot, in_dims[1], r),
                            (r,), width, kv, ka)
    return out, (0, 0)


@torch.library.custom_op("nf::fused_neighborhood", mutates_args=())
def _fused_op(bank: torch.Tensor, vtab: torch.Tensor, atab: torch.Tensor, width: int, kv: int,
              ka: int, r2: float, ty: int, tx: int, threads: int, smem: int,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_fused(bank, vtab, atab, (), width, kv, ka, r2, (ty, tx, threads, smem, chunk))


@_fused_op.register_fake
def _(bank, vtab, atab, width, kv, ka, r2, ty, tx, threads, smem, chunk):
    shape = (width, width, kv)
    return tuple(bank.new_empty(shape, dtype=torch.int32) for _ in range(3))


@torch.library.register_vmap("nf::fused_neighborhood")
def _(info, in_dims, bank, vtab, atab, width, kv, ka, r2, ty, tx, threads, smem, chunk):
    r = info.batch_size
    out = _launch_fused(_room_front(bank, in_dims[0], r), _room_front(vtab, in_dims[1], r),
                        _room_front(atab, in_dims[2], r), (r,), width, kv, ka, r2,
                        (ty, tx, threads, smem, chunk))
    return out, (0, 0, 0)


# -- the wrappers --------------------------------------------------------------


def _r2(radius: float) -> float:
    return float(radius) * float(radius)


def combat_fold(vic_table: CellTable, att_table: CellTable,
                radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Engine 1: the split-table combat fold.  CPU tensors run
    :func:`combat_fold_plain`; CUDA tensors launch ``combat_fold_kernel``
    (or its chunk form) as :func:`plan_fold` plans it, once for all rooms
    under ``torch.func.vmap``.  Returns (inc, bestr), each [H, W, Kv]
    int32."""
    if vic_table.payload.device.type == "cpu":
        return combat_fold_plain(vic_table, att_table, radius)
    plan = plan_fold("combat", vic_table.width, vic_table.bucket, att_table.bucket)
    return combat_fold_planned(vic_table, att_table, radius, plan)


def combat_fold_planned(vic_table: CellTable, att_table: CellTable, radius: float,
                        plan: FoldPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`combat_fold` on CUDA tensors under a given launch plan."""
    w = vic_table.width
    if att_table.width != w or plan.width != w or plan.kind != "combat":
        raise ValueError("tables and plan differ in grid width or kind")
    return torch.ops.nf.combat_fold(vic_table.payload, att_table.payload, w,
                                    vic_table.bucket, att_table.bucket, _r2(radius),
                                    *_plan_args(plan))


def row_tables(vic_slots: CellSlots, att_slots: CellSlots,
               n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's row tables on CUDA, one zero fill each and one
    scatter launch for both: [H, W, K] int32 holding row + 1 per slot, 0
    for an empty slot (``slot_rows`` + 1 with its sentinel ``n`` as 0)."""
    if vic_slots.slot_of.shape[-1] != n or att_slots.slot_of.shape[-1] != n:
        raise ValueError(f"slot assignments do not cover {n} rows")
    return torch.ops.nf.slot_rows(vic_slots.slot_of, att_slots.slot_of, vic_slots.width,
                                  vic_slots.bucket, att_slots.bucket)


def fused_neighborhood(bank: torch.Tensor, vic_slots: CellSlots,
                       att_slots: CellSlots, radius: float):
    """Engine 2: the table-free fold gathered from ``bank`` [N, 6], plus the
    AOI occupancy count.  CPU tensors run :func:`fused_neighborhood_plain`;
    CUDA tensors build the row tables (:func:`row_tables`) and launch
    ``fused_neighborhood_kernel`` (or its chunk form) as :func:`plan_fold`
    plans it, once for all rooms under ``torch.func.vmap``.  Returns (inc,
    bestr, nbr), each [H, W, Kv] int32."""
    if bank.device.type == "cpu":
        return fused_neighborhood_plain(bank, vic_slots, att_slots, radius)
    plan = plan_fold("fused", vic_slots.width, vic_slots.bucket, att_slots.bucket)
    return fused_neighborhood_planned(bank, vic_slots, att_slots, radius, plan)


def fused_neighborhood_planned(bank: torch.Tensor, vic_slots: CellSlots,
                               att_slots: CellSlots, radius: float, plan: FoldPlan):
    """:func:`fused_neighborhood` on CUDA tensors under a given plan."""
    w = vic_slots.width
    if att_slots.width != w or plan.width != w or plan.kind != "fused":
        raise ValueError("slots and plan differ in grid width or kind")
    vtab, atab = row_tables(vic_slots, att_slots, bank.shape[-2])
    return torch.ops.nf.fused_neighborhood(bank, vtab, atab, w, vic_slots.bucket,
                                           att_slots.bucket, _r2(radius), *_plan_args(plan))


# -- the tick's threefry stream: nf::fold_in and nf::wander -------------------


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` in int64 ops (:func:`prng.fold_in`)."""
    return prng.fold_in(key, data)


def wander_plain(alive: torch.Tensor, i32: torch.Tensor, vec: torch.Tensor, key: torch.Tensor,
                 pos_col: int, tgt_col: int, speed_col: int, gate_col: int, hp_col: int,
                 speed_scale: float, dt: float, extent: float, offset: int = 0) -> torch.Tensor:
    """The wander phase in plain PyTorch: seek ``vec[:, tgt_col]`` at
    ``i32[:, speed_col] * speed_scale`` units a second (0 where the gate
    column is > 0 or the HP column <= 0; a column below 0 is absent), and
    when within one step of it take a fresh uniform target in ``[0,
    extent)`` from ``key`` (flat counter ``offset + 2 * row + component``).
    Returns a new ``vec`` bank with Position.xy and TargetPos.xy replaced;
    ``dt`` and ``speed_scale`` are float32 values."""
    pos = vec[:, pos_col, :2]  # [C, 2]
    tgt = vec[:, tgt_col, :2]
    speed = i32[:, speed_col].to(torch.float32) * speed_scale
    if gate_col >= 0:
        speed = torch.where(i32[:, gate_col] > 0, 0.0, speed)
    if hp_col >= 0:
        speed = torch.where(i32[:, hp_col] > 0, speed, 0.0)
    step = speed * dt  # [C]

    delta = tgt - pos
    # the reference sums the two squares as fma(d1, d1, d0*d0)
    sq = fma32(delta[:, 1], delta[:, 1], delta[:, 0] * delta[:, 0])
    dist = sqrt32(sq + float(np.float32(1e-12)))
    arrived = dist <= torch.clamp(step, min=float(np.float32(1e-6)))
    # fresh uniform target for arrived walkers (dead/rooted ones have
    # step 0 and never "arrive" once a target is outstanding)
    new_tgt = prng.uniform(key, (pos.shape[0], 2), 0.0, extent, offset=offset)
    tgt = torch.where((arrived & alive)[:, None], new_tgt, tgt)
    # pos + where(arrived, delta, delta/dist*step): the reference fuses
    # the walking arm into fma(delta/dist, step, pos)
    walk = fma32(delta / dist[:, None], step[:, None].expand_as(delta), pos)
    moved = torch.where(arrived[:, None], pos + delta, walk)
    new_pos = torch.where(alive[:, None], moved, pos)
    new_pos = torch.clamp(new_pos, 0.0, float(np.float32(extent)))

    out = vec.clone()
    out[:, pos_col, :2] = new_pos
    out[:, tgt_col, :2] = tgt
    return out


def _launch_fold_in(key: torch.Tensor, data: Optional[torch.Tensor], value: int,
                    lead: Tuple[int, ...]) -> torch.Tensor:
    """fold_in_kernel over the keys of ``lead`` (``()``: one key ``[2]``,
    ``(R,)``: ``[R, 2]``); ``data`` holds one int32 or int64 word a key, or
    is None for the constant ``value``."""
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"fold_in_kernel runs on cuda, not {dev}")
    rooms = _rooms_of(lead)
    _check(key, "key", torch.int64, (*lead, 2), dev)
    if data is not None:
        if data.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"fold_in data dtype {data.dtype}, expected int32 or int64")
        _check(data, "fold_in data", data.dtype, lead, dev)
    out = torch.empty_like(key)
    lib = library()
    with _on(dev):
        err = lib.nf_fold_in(
            key.data_ptr(), None if data is None else data.data_ptr(),
            int(data is not None and data.dtype == torch.int64), value & prng.MASK32, rooms,
            out.data_ptr(), _stream(dev))
    _raise_on(lib, err, "fold_in_kernel")
    KERNELS["fold_in"].launches += 1
    return out


@torch.library.custom_op("nf::fold_in", mutates_args=())
def _fold_in_op(key: torch.Tensor, data: Optional[torch.Tensor], value: int) -> torch.Tensor:
    return _launch_fold_in(key.contiguous(), None if data is None else data.contiguous(),
                           value, ())


@_fold_in_op.register_fake
def _(key, data, value):
    return torch.empty_like(key)


@torch.library.register_vmap("nf::fold_in")
def _(info, in_dims, key, data, value):
    r = info.batch_size
    data = None if data is None else _room_front(data, in_dims[1], r)
    return _launch_fold_in(_room_front(key, in_dims[0], r), data, value, (r,)), 0


def _launch_wander(alive: torch.Tensor, i32: torch.Tensor, vec: torch.Tensor,
                   key: torch.Tensor, lead: Tuple[int, ...], cols, speed_scale: float,
                   dt: float, extent: float, offset: int) -> torch.Tensor:
    """wander_kernel over the rooms of ``lead`` (``()``: one world,
    ``(R,)``: R rooms back to back, a key a room); ``cols`` = (pos, tgt,
    speed, gate, hp)."""
    dev = vec.device
    if dev.type != "cuda":
        raise ValueError(f"wander_kernel runs on cuda, not {dev}")
    rooms = _rooms_of(lead)
    c, nv = vec.shape[-3], vec.shape[-2]
    ni = i32.shape[-1]
    _check(vec, "vec bank", torch.float32, (*lead, c, nv, 3), dev)
    _check(i32, "i32 bank", torch.int32, (*lead, c, ni), dev)
    _check(alive, "alive", torch.bool, (*lead, c), dev)
    _check(key, "key", torch.int64, (*lead, 2), dev)
    out = torch.empty_like(vec)
    lib = library()
    with _on(dev):
        err = lib.nf_wander(
            alive.data_ptr(), i32.data_ptr(), vec.data_ptr(), key.data_ptr(), rooms, c, ni, nv,
            *cols, speed_scale, dt, extent, offset, out.data_ptr(), _stream(dev))
    _raise_on(lib, err, "wander_kernel")
    KERNELS["wander"].launches += 1
    return out


@torch.library.custom_op("nf::wander", mutates_args=())
def _wander_op(alive: torch.Tensor, i32: torch.Tensor, vec: torch.Tensor, key: torch.Tensor,
               pos_col: int, tgt_col: int, speed_col: int, gate_col: int, hp_col: int,
               speed_scale: float, dt: float, extent: float, offset: int) -> torch.Tensor:
    return _launch_wander(alive.contiguous(), i32.contiguous(), vec.contiguous(),
                          key.contiguous(), (), (pos_col, tgt_col, speed_col, gate_col, hp_col),
                          speed_scale, dt, extent, offset)


@_wander_op.register_fake
def _(alive, i32, vec, key, pos_col, tgt_col, speed_col, gate_col, hp_col, speed_scale, dt,
      extent, offset):
    return torch.empty_like(vec)


@torch.library.register_vmap("nf::wander")
def _(info, in_dims, alive, i32, vec, key, pos_col, tgt_col, speed_col, gate_col, hp_col,
      speed_scale, dt, extent, offset):
    r = info.batch_size
    out = _launch_wander(*(_room_front(x, d, r) for x, d in zip((alive, i32, vec, key), in_dims)),
                         (r,), (pos_col, tgt_col, speed_col, gate_col, hp_col), speed_scale, dt,
                         extent, offset)
    return out, 0


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: CPU keys run
    :func:`fold_in_plain`; a CUDA key launches ``fold_in_kernel`` once (for
    all rooms under ``torch.func.vmap``).  ``data`` is an int or a
    one-element integer tensor (the tick), read on the device with no host
    sync."""
    if key.device.type == "cpu":
        return fold_in_plain(key, data)
    if isinstance(data, torch.Tensor):
        return torch.ops.nf.fold_in(key, data.to(device=key.device).reshape(()), 0)
    return torch.ops.nf.fold_in(key, None, data)


def wander(alive: torch.Tensor, i32: torch.Tensor, vec: torch.Tensor, key: torch.Tensor,
           pos_col: int, tgt_col: int, speed_col: int, gate_col: int, hp_col: int,
           speed_scale: float, dt: float, extent: float, offset: int = 0) -> torch.Tensor:
    """The wander phase over one class's banks (arguments as
    :func:`wander_plain`'s).  CPU tensors run :func:`wander_plain`; CUDA
    tensors launch ``wander_kernel`` once, for all rooms under
    ``torch.func.vmap``.  Returns the new ``vec`` bank."""
    if vec.device.type == "cpu":
        return wander_plain(alive, i32, vec, key, pos_col, tgt_col, speed_col, gate_col, hp_col,
                            speed_scale, dt, extent, offset)
    return torch.ops.nf.wander(alive, i32, vec, key, pos_col, tgt_col, speed_col, gate_col,
                               hp_col, float(speed_scale), float(dt),
                               float(np.float32(extent)), int(offset))
