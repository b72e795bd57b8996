"""The buff fold: a hand-written CUDA kernel and its plain PyTorch version.

:func:`buff_fold` is the device phase of ``game/buff.py`` (the port of
NoahGameFrame's NFCBuffModule).  For every entity row of a class, over
the rows of its ``BuffList`` record and a ``[K, S]`` int32 table of each
buff kind's stat deltas:

    active[C, R]  = used & (ExpireTick > tick)
    contrib[C, S] = sum_R table[clamp(ConfigIdx, 0, K - 1)] * active

in int32.  The JAX package's phase is XLA (no Pallas kernel); its port,
:func:`buff_fold_plain`, accumulates one gathered record row at a time.
A CUDA tensor launches ``buff_fold_kernel`` (``csrc/buff.cu``) once, as
the custom op ``nf::buff_fold``, whose vmap rule makes one launch for
all rooms of a ``RoomBatch`` (each room with its own tick); a CPU tensor
runs the plain version.
Integer sums do not depend on their order, so the two agree bit for bit.

The kernel lives in a translation unit of its own, built with ``nvcc``
for ``sm_90a`` into ``csrc/build/`` and loaded with ctypes at the op's
first call on a card (:func:`library`), so a world without buffs never
builds it.  Its launches count in ``stencil_cuda.KERNELS["buff_fold"]``
with the port's other hand kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .stencil_cuda import KERNELS, _check, _on, _room_front, _rooms_of, _stream, build_library

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "buff.cu"
MAX_STATS = 32  # the kernel's register sums (NF_BUFF_MAX_STATS)

# nf-lint custom-op-parity-pinned registry (lint/rules_cuda.py)
CUSTOM_OP_PARITY_TESTS = {
    "nf::buff_fold": "tests/test_torch_cuda.py",
}

_LIB: Optional[ctypes.CDLL] = None


def buff_fold_plain(buf: torch.Tensor, used: torch.Tensor, table: torch.Tensor,
                    tick: torch.Tensor, cfg_col: int, exp_col: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold in plain PyTorch over ``buf`` [C, R, NC] int32 (the
    ``BuffList`` record's int bank), ``used`` [C, R] bool, ``table`` [K, S]
    int32 and the tick: ``(contrib [C, S] int32, active [C, R] bool)``.
    The sum runs over the R record rows one gathered row at a time (the
    ``[C, R, S]`` product would be ~1 GB at 2^20 rows)."""
    cfg = buf[:, :, cfg_col].clamp(0, table.shape[0] - 1)
    active = used & (buf[:, :, exp_col] > tick)
    contrib = torch.zeros((cfg.shape[0], table.shape[1]), dtype=torch.int32, device=cfg.device)
    for r in range(cfg.shape[1]):  # out of place: vmap batches the sum
        contrib = contrib + table[cfg[:, r]] * active[:, r, None]
    return contrib, active


def library() -> ctypes.CDLL:
    """Build (once per source version) and load csrc/buff.cu."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib, _log = build_library(SOURCE, "libnf_buff")
    p, i = ctypes.c_void_p, ctypes.c_int
    q = ctypes.c_longlong
    lib.nf_buff_fold.argtypes = [p, p, p, p, q, q, i, i, i, i, i, i, p, p, p]
    lib.nf_buff_fold.restype = i
    lib.nf_buff_error_string.argtypes = [i]
    lib.nf_buff_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _launch_buff_fold(buf: torch.Tensor, used: torch.Tensor, table: torch.Tensor,
                      tick: torch.Tensor, cfg_col: int, exp_col: int, lead: Tuple[int, ...] = ()
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """buff_fold_kernel over the C rows of one class in the rooms of
    ``lead`` (``()``: one world, ``(R,)``: R rooms back to back, a tick a
    room)."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"buff_fold_kernel runs on cuda, not {dev}")
    rooms = _rooms_of(lead)
    c, r, nc = buf.shape[-3:]
    k, s = table.shape
    if s > MAX_STATS:
        raise ValueError(f"{s} stats exceed the kernel's {MAX_STATS}")
    _check(buf, "BuffList i32 bank", torch.int32, (*lead, c, r, nc), dev)
    _check(used, "BuffList used", torch.bool, (*lead, c, r), dev)
    _check(table, "buff table", torch.int32, (k, s), dev)
    _check(tick, "tick", torch.int32, lead, dev)
    contrib = torch.empty((*lead, c, s), dtype=torch.int32, device=dev)
    active = torch.empty_like(used)
    lib = library()
    with _on(dev):
        err = lib.nf_buff_fold(buf.data_ptr(), used.data_ptr(), table.data_ptr(),
                               tick.data_ptr(), rooms * c, max(c, 1), r, nc, cfg_col, exp_col,
                               k, s, contrib.data_ptr(), active.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError("buff_fold_kernel launch failed: "
                           f"{lib.nf_buff_error_string(err).decode()}")
    KERNELS["buff_fold"].launches += 1
    return contrib, active


@torch.library.custom_op("nf::buff_fold", mutates_args=())
def _buff_fold_op(buf: torch.Tensor, used: torch.Tensor, table: torch.Tensor,
                  tick: torch.Tensor, cfg_col: int,
                  exp_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_buff_fold(buf.contiguous(), used.contiguous(), table.contiguous(),
                             tick.contiguous(), cfg_col, exp_col)


@_buff_fold_op.register_fake
def _(buf, used, table, tick, cfg_col, exp_col):
    return buf.new_empty((buf.shape[0], table.shape[1]), dtype=torch.int32), torch.empty_like(used)


@torch.library.register_vmap("nf::buff_fold")
def _(info, in_dims, buf, used, table, tick, cfg_col, exp_col):
    if in_dims[2] is not None:
        raise ValueError("nf::buff_fold under vmap takes one buff table for every room")
    r = info.batch_size
    return _launch_buff_fold(_room_front(buf, in_dims[0], r), _room_front(used, in_dims[1], r),
                             table.contiguous(), _room_front(tick, in_dims[3], r), cfg_col,
                             exp_col, (r,)), (0, 0)


def buff_fold(buf: torch.Tensor, used: torch.Tensor, table: torch.Tensor, tick: torch.Tensor,
              cfg_col: int, exp_col: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buff fold of one class (arguments as :func:`buff_fold_plain`'s).
    CPU tensors run :func:`buff_fold_plain`; CUDA tensors launch
    ``buff_fold_kernel`` once.  The tick is read on the device, with no
    host sync."""
    if buf.device.type == "cpu":
        return buff_fold_plain(buf, used, table, tick, cfg_col, exp_col)
    tick = tick.to(device=buf.device, dtype=torch.int32).reshape(())
    return torch.ops.nf.buff_fold(buf, used, table, tick, int(cfg_col), int(exp_col))
