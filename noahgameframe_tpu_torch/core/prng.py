"""Threefry-2x32 keys, bit-exact with ``jax.random``'s legacy uint32 keys.

The world's per-tick randomness is part of its state contract: the
``state_digest`` stream of a seeded world must equal the JAX package's, so
the port cannot draw from a ``torch.Generator``.  This module reproduces
the three ``jax.random`` calls the tick makes, under jax's default
``jax_threefry_partitionable=True``:

- ``PRNGKey(seed)``: the key ``(seed >> 32, seed & 0xFFFFFFFF)`` of the
  seed taken as a 32-bit integer (jax without x64);
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
- ``uniform(key, shape, minval, maxval)`` in float32: the counter of flat
  element ``i`` is ``(i >> 32, i & 0xFFFFFFFF)``, the bits are the xor of
  the two threefry words, and the top 23 bits become the mantissa of a
  float in ``[1, 2)``.

A key is an int64 tensor ``[2]`` holding two uint32 words.  uint32
arithmetic runs in int64 with a ``0xFFFFFFFF`` mask, so every device and
every torch build gives the same bits.  These are the plain versions: on
a card the tick's ``fold_in`` and the movement phase's draw run as one
kernel each (``ops/stencil_cuda.py`` ``fold_in`` and ``wander``).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .device import resolve_device

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1: IntLike, k2: IntLike, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k1, k2)``; every argument holds uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor on ``device``
    (``None`` = ``"cuda"``)."""
    s = int(np.int32(seed))  # jax without x64 takes the seed as int32
    hi = (s >> 32) & MASK32 if s >= 0 else 0
    return torch.tensor([hi, s & MASK32], dtype=torch.int64, device=resolve_device(device))


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` may be a 0-dim device
    tensor (the tick), so no host sync happens."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64).reshape(1) & MASK32
    else:  # a fill, not a host-to-device copy
        d = torch.full((1,), int(data) & MASK32, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(d)
    a, b = threefry2x32(key[0], key[1], zero, d)
    return torch.cat([a, b])


def random_bits(key: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 values in ``[0, 2^32)``).
    ``offset`` starts the flat counter there: a shard holding rows
    ``[r0, r0 + rows)`` of a ``[R, C]`` draw takes ``offset=r0 * C`` and
    gets exactly its slice of the whole draw (the partitionable layout)."""
    n = int(np.prod(shape, dtype=np.int64))
    count = torch.arange(offset, offset + n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], count >> 32, count & MASK32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(
    key: torch.Tensor, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
    offset: int = 0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``;
    ``offset`` as in :func:`random_bits`."""
    bits = random_bits(key, shape, offset)
    # jax: bitcast(0x3F800000 | bits >> 9) - 1.0, a float in [1, 2) minus
    # one; exactly the 23 random bits times 2^-23 (no bit view, so it
    # batches under torch.func.vmap)
    floats = (bits >> 9).to(torch.float32) * 2.0 ** -23
    lo = np.float32(minval)
    span = np.float32(maxval) - lo  # computed in float32, as jax does
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))
