"""Integer and float arithmetic of the tick, written out plainly.

- Threefry-2x32 (20 rounds; Salmon et al., "Parallel random numbers: as
  easy as 1, 2, 3", SC 2011) with ``jax.random``'s legacy uint32 key
  layout: ``fold_in(key, d) = threefry(key, (0, d))``, and a float32
  uniform draw whose flat element ``i`` hashes the counter ``(i >> 32,
  i & 0xFFFFFFFF)`` and keeps the top 23 bits of the xor of the two words
  as the mantissa of a float in ``[1, 2)``.  uint32 words live in int64
  with a mask, batched over a leading room axis.
- ``fma``: ``a*b + c`` rounded once to float32.  The product is exact in
  float64; TwoSum gives the float64 sum's error, and a float64 sum that
  lands on a float32 midpoint with a non-zero error is rounded towards the
  error's side.
- ``sqrt``: correctly rounded (float64, rounded once more to float32).
- ``recip``: the float32 reciprocal that ``x / c`` by a constant becomes.

In a lower precision (``fdt`` not float32) every operation is the plain
one in that dtype: that is the control of the correctness check.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SPLIT25 = float((1 << 28) + 1)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of counter words (x0, x1) under key words (k1, k2);
    every argument holds uint32 values in int64 and broadcasts."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``key`` [R, 2] folded with ``data`` [R] (int): [R, 2]."""
    d = data.to(torch.int64) & MASK32
    a, b = threefry(key[:, 0], key[:, 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=1)


def uniform(key: torch.Tensor, n: int, lo: float, hi: float) -> torch.Tensor:
    """``n`` float32 draws in ``[lo, hi)`` per room: [R, n]."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    b1, b2 = threefry(key[:, 0:1], key[:, 1:2], count >> 32, count & MASK32)
    bits = b1 ^ b2
    unit = (bits >> 9).to(torch.float32) * 2.0 ** -23
    lo32 = np.float32(lo)
    span = np.float32(hi) - lo32
    return torch.clamp(unit * float(span) + float(lo32), min=float(lo32))


def recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` with one rounding to float32; in another dtype, the
    plain product and sum of that dtype."""
    if a.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    f = s.float()
    fd = f.double()
    k = s * _SPLIT25
    on_midpoint = ((k - (k - s)) == s) & (fd != s) & (err != 0)
    other = (2.0 * s - fd).float()
    towards = torch.where(err > 0, torch.maximum(f, other), torch.minimum(f, other))
    return torch.where(on_midpoint, towards, f)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()
