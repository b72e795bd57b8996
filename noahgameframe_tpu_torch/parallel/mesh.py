"""Device meshes: an explicit, ordered list of shard devices.

Counterpart of ``noahgameframe_tpu/parallel/mesh.py``.  The JAX package
builds a ``jax.sharding.Mesh`` over ``jax.devices()`` and lets XLA place
every array.  Here a :class:`Mesh` is the ordered list of the D devices
its shards live on: a sharded leaf is held as D row blocks, block ``d`` a
tensor on ``devices[d]``, and a replicated leaf as one tensor per shard.

A device may repeat in the list.  That is a **virtual mesh**: D shards on
one card (or on ``cpu``), each with its own blocks and its own kernel
launches, the counterpart of the JAX tests' virtual CPU devices
(``--xla_force_host_platform_device_count``).  A virtual mesh exists only
when it is asked for (``make_mesh(n, device=..., virtual=True)`` or a
``Mesh`` built from a list of devices); :func:`make_mesh` never folds a
mesh onto fewer devices than it was asked for.

A mesh may span processes (parallel/multihost.py ``global_mesh``): shard
``d`` then belongs to process ``ranks[d]``, this process holds only the
blocks of ``local``, and the collectives (parallel/collectives.py) cross
processes through ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

SHARD_AXIS = "shard"
# the many-worlds room engine (parallel/rooms.py) batches independent
# rooms on a leading [R] axis and shards that axis instead of the
# entity axis: one mesh, two orthogonal scale shapes
ROOMS_AXIS = "rooms"


class Mesh:
    """A 1-D mesh: ``devices[d]`` holds shard ``d``; ``ranks[d]`` is the
    process that owns it (all 0 in one process), and ``local`` lists the
    shards of this process (``rank``).  ``bytes_moved`` counts the bytes
    its collectives moved between shards (parallel/collectives.py)."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS, *,
                 ranks: Optional[Sequence[int]] = None, rank: int = 0,
                 group=None):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.ranks: Tuple[int, ...] = (tuple(int(r) for r in ranks) if ranks is not None
                                       else (0,) * len(self.devices))
        if len(self.ranks) != len(self.devices):
            raise ValueError("one rank per mesh device")
        self.rank = int(rank)
        # the torch.distributed process group of a mesh across processes
        self.group = group
        self.local: Tuple[int, ...] = tuple(
            i for i, r in enumerate(self.ranks) if r == self.rank)
        self.bytes_moved = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def virtual(self) -> bool:
        """True when shards share a device (several shards on one card)."""
        return len(set(zip(self.devices, self.ranks))) < self.size

    @property
    def multiprocess(self) -> bool:
        return len(set(self.ranks)) > 1

    def key(self):
        return (self.axis, self.devices, self.ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        kind = "virtual " if self.virtual else ""
        return f"Mesh({kind}{self.axis}={self.size}: {[str(d) for d in self.devices]})"

    def without(self, index: int) -> "Mesh":
        """The mesh with shard ``index`` removed (an elastic drain)."""
        keep = [i for i in range(self.size) if i != int(index)]
        return Mesh([self.devices[i] for i in keep], self.axis,
                    ranks=[self.ranks[i] for i in keep], rank=self.rank, group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = SHARD_AXIS, *,
              device=None, virtual: bool = False) -> Mesh:
    """1-D mesh over the first n cards (default: all), as the JAX package's
    ``make_mesh`` over ``jax.devices()``; raises when there are fewer.

    ``virtual=True`` asks for a virtual mesh of n shards on ONE device,
    ``device`` (default ``"cuda:0"``; ``"cpu"`` for the tests)."""
    if virtual:
        if n_devices is None:
            raise ValueError("a virtual mesh needs its shard count")
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"virtual mesh on {str(dev)!r}: no CUDA device")
        return Mesh([dev] * int(n_devices), axis)
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(
            f"make_mesh over {str(device)!r}: only cards form a real mesh; "
            "pass virtual=True for several shards on one device")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} CUDA devices "
            "(make_mesh(n, device=..., virtual=True) builds n shards on one device)")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


class Sharding:
    """Where a leaf lives on a mesh: ``spec == (axis,)`` row-blocked over
    the leading axis, ``()`` replicated (``jax.sharding.PartitionSpec``'s
    two 1-D forms).  A plain object, not a container: a tree of
    shardings flattens to one leaf per state leaf."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: Tuple[str, ...]):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Sharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"Sharding(spec={self.spec})"


def row_sharding(mesh: Mesh, axis: str = SHARD_AXIS) -> Sharding:
    """Shard the leading (entity/capacity) axis; replicate the rest."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
