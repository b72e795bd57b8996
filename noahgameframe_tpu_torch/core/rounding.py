"""Float32 arithmetic rounded the way the reference rounds it.

The world's state contract is bit-exact against the JAX package, whose
tick is compiled by XLA.  Three of XLA's rewrites change float32 results,
and the port reproduces each one explicitly (on every device):

- ``a*b + c`` is contracted into a fused multiply-add, one rounding:
  ``dx*dx + dy*dy`` in the combat fold (engines 0, 1 and 2) is
  ``fma(dx, dx, dy*dy)``; in the movement phase ``sum(delta*delta, -1)``
  over the two components is ``fma(d1, d1, d0*d0)`` and a walker's new
  position ``pos + delta/dist*step`` is ``fma(delta/dist, step, pos)``
  (:func:`fma32`; the CUDA kernels call ``__fmaf_rn``);
- ``x / c`` by a constant is ``x * float32(1/c)``: the movement speed
  (``MOVE_SPEED / 10000``) and the cell ids (``pos / cell_size``) are
  written as that product (:func:`recip32`);
- ``sqrt`` is correctly rounded; PyTorch's vectorised CPU ``sqrt`` is
  not, so :func:`sqrt32` takes it in float64.
"""

from __future__ import annotations

import numpy as np
import torch

# Veltkamp's splitting constant 2^28 + 1: (k - (k - s)) with k = s * it is
# s rounded to 53 - 28 = 25 significant bits
_SPLIT25 = float((1 << 28) + 1)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` for float32 tensors, rounded once to float32.

    The product is exact in float64 and TwoSum gives the exact error of
    the float64 sum, so the only wrong rounding left is a float64 sum on
    an exact float32 midpoint with a non-zero error: the true value lies
    beyond the midpoint on the error's side.  Exact for results in
    float32's normal range (the world's distances and positions never
    reach the subnormals).

    The midpoint is found in plain arithmetic, so the test batches under
    ``torch.func.vmap`` (the rooms) on every torch: a float64 with 25
    significant bits, the last one set, is such a midpoint, and the float32
    neighbour on the error's side is taken."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)  # p + cd == s + err exactly
    f = s.float()  # round to nearest, ties to even
    fd = f.double()
    k = s * _SPLIT25
    tie = ((k - (k - s)) == s) & (fd != s) & (err != 0)
    other = (2.0 * s - fd).float()  # the midpoint's other float32 neighbour
    beyond = torch.where(err > 0, torch.maximum(f, other), torch.minimum(f, other))
    return torch.where(tie, beyond, f)


def recip32(c: float) -> float:
    """The float32 reciprocal XLA multiplies by for ``x / c`` (returned
    as the exact Python float of that float32 value)."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (float64 sqrt, rounded once
    more: innocuous, as 53 >= 2*24 + 2)."""
    return torch.sqrt(x.double()).float()
