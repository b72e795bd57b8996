"""Collectives over a mesh's shards: the port's ``shard_map`` and
``jax.lax.{ppermute, psum, pmax, all_gather, axis_index}``.

The JAX package writes its explicit multi-device bodies under
``shard_map`` (the spatial combat body, the row migration, the Verlet
rebuild vote) and lets XLA insert the rest.  PyTorch has neither, so the
port writes both out here.  A body sees one shard: :func:`per_shard` calls
it once for every shard this process holds, with that shard's blocks and
its axis index.  Between bodies, a collective takes the list of every
local shard's value (in ``mesh.local`` order) and returns the list of
results:

- in one process each collective is a tensor copy (``.to(dst)``, a peer
  copy between cards, nothing at all between two shards of one device)
  or a reduction on the first shard's device;
- across processes (``mesh.ranks``) the values also go through
  ``torch.distributed``.  Gloo carries only host tensors, so a CUDA
  tensor bound for a gloo group is staged through the host; NCCL takes
  them as they are.

Reductions here are over integers (counts, votes, digest partials), whose
sums are exact in any order.

``mesh.bytes_moved`` counts the bytes each shard receives from other
shards, as if every shard had a card of its own: a ``ppermute`` counts
each value whose source and destination differ, an ``all_gather`` the
D - 1 foreign blocks each shard receives, and a ``psum``/``pmax`` the
D - 1 foreign partials each shard combines.  This is the mesh layer's
metric (collective bytes per tick); on a virtual mesh most of those
copies are elided, and the count is the traffic a mesh of real cards
would carry.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def per_shard(mesh: Mesh, body: Callable, *lists) -> list:
    """``body(axis_index, *blocks)`` for every local shard, in order.  A
    body returning a tuple gives a tuple of lists."""
    outs = [body(idx, *(a[i] for a in lists)) for i, idx in enumerate(mesh.local)]
    if outs and isinstance(outs[0], tuple):
        return tuple(list(col) for col in zip(*outs))
    return outs


# -- torch.distributed plumbing (a mesh across processes) ------------------------


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the process group's backend takes it: gloo carries host
    tensors only, so a CUDA tensor goes through the host."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend(mesh.group) == "gloo":
        # nf-lint: disable=capture-safety -- gloo carries host tensors
        # only; a mesh across processes ticks through the sharded
        # kernel's eager dispatcher, never a captured graph
        return x.cpu()
    return x.contiguous()


def _dist_all_gather(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist

    t = _staged(mesh, x)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(out, t, group=mesh.group)
    return out


def _dist_all_reduce(mesh: Mesh, x: torch.Tensor, op: str) -> torch.Tensor:
    import torch.distributed as dist

    t = _staged(mesh, x).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    return t.to(x.device)


def _group_rank(mesh: Mesh, rank: int) -> int:
    import torch.distributed as dist

    return rank if mesh.group is None else dist.get_global_rank(mesh.group, rank)


# -- collectives -------------------------------------------------------------


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} values for {len(mesh.local)} local shards")
    home = mesh.devices[mesh.local[0]]
    stacked = torch.stack([x.to(home) for x in xs])
    acc = stacked.sum(0, dtype=stacked.dtype) if op == "sum" else stacked.amax(0)
    if mesh.multiprocess:
        acc = _dist_all_reduce(mesh, acc, op)
    d = mesh.size
    mesh.bytes_moved += d * (d - 1) * _nbytes(xs[0])
    return _broadcast(mesh, acc)


def _broadcast(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every local shard's device: one copy per device, shared by
    the shards of a virtual mesh (readers never write into it)."""
    per_dev: Dict[torch.device, torch.Tensor] = {}
    out = []
    for idx in mesh.local:
        dev = mesh.devices[idx]
        if dev not in per_dev:
            per_dev[dev] = x.to(dev)
        out.append(per_dev[dev])
    return out


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over all shards, on every shard (integers: exact)."""
    return _reduce(mesh, xs, "sum")


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max over all shards, on every shard."""
    return _reduce(mesh, xs, "max")


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's block concatenated in shard order along dim 0, on
    every local shard's device."""
    whole = gather_blocks(mesh, xs, mesh.devices[mesh.local[0]])
    d = mesh.size
    mesh.bytes_moved += (d - 1) * d * _nbytes(xs[0])
    return _broadcast(mesh, whole)


def gather_blocks(mesh: Mesh, xs: Sequence[torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """Every shard's block concatenated in shard order on ``device`` (no
    byte accounting: the host-side assembly of a sharded world)."""
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} blocks for {len(mesh.local)} local shards")
    local = torch.cat([x.to(device) for x in xs]) if len(xs) > 1 else xs[0].to(device)
    if not mesh.multiprocess:
        return local
    if list(mesh.ranks) != sorted(mesh.ranks):
        raise ValueError("a mesh across processes lists each process's shards together")
    return torch.cat([p.to(device) for p in _dist_all_gather(mesh, local)])


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``dst`` receives shard ``src``'s value
    for each ``(src, dst)`` pair; a shard no pair names receives zeros."""
    src_of = {int(dst): int(src) for src, dst in perm}
    pos = {idx: i for i, idx in enumerate(mesh.local)}
    out: List[Optional[torch.Tensor]] = [None] * len(mesh.local)
    pending = []
    if mesh.multiprocess:
        import torch.distributed as dist

        reqs, recvs = [], []
        for src, dst in perm:
            src, dst = int(src), int(dst)
            if src in pos and dst not in pos:
                reqs.append(dist.isend(_staged(mesh, xs[pos[src]]),
                                       dst=_group_rank(mesh, mesh.ranks[dst]),
                                       group=mesh.group, tag=src * mesh.size + dst))
            elif dst in pos and src not in pos:
                like = _staged(mesh, xs[pos[dst]])
                buf = torch.empty_like(like)
                reqs.append(dist.irecv(buf, src=_group_rank(mesh, mesh.ranks[src]),
                                       group=mesh.group, tag=src * mesh.size + dst))
                recvs.append((dst, buf))
        for r in reqs:
            r.wait()
        pending = recvs
    for dst, buf in pending:
        out[pos[dst]] = buf.to(mesh.devices[dst])
        mesh.bytes_moved += _nbytes(buf)
    for i, dst in enumerate(mesh.local):
        if out[i] is not None:
            continue
        src = src_of.get(dst)
        if src is None:
            out[i] = torch.zeros_like(xs[i])
        else:
            out[i] = xs[pos[src]].to(mesh.devices[dst])
            if src != dst:
                mesh.bytes_moved += _nbytes(out[i])
    return out


def ring(n: int, d: int) -> List[Tuple[int, int]]:
    """The ``(i, (i + d) % n)`` permutation: ``d=1`` forward, ``-1`` back."""
    return [(i, (i + d) % n) for i in range(n)]
