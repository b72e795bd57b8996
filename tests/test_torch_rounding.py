"""The port's fused multiply-add (noahgameframe_tpu_torch/core/rounding.py
``fma32``) against exact rational arithmetic, plain and under
``torch.func.vmap`` with the slow-path fallback off.

The hard inputs are float64 sums that land exactly on a float32 midpoint:
with a non-zero rounding error the float32 on the error's side is right,
with none the midpoint rounds to even.  They are built here on purpose
(random inputs almost never reach one), on both sides of a value, at and
around powers of two, with both signs of the error and with none."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from noahgameframe_tpu_torch.core.rounding import fma32
from noahgameframe_tpu_torch.parallel.rooms import no_vmap_fallback
from test_torch_parity import one_intra_op_thread  # noqa: F401

N_TIES = 1024
N_RANDOM = 1 << 16
N_EXACT = 2048  # random inputs also held against the rational reference


def _round32(x: Fraction) -> int:
    """The float32 nearest ``x``, ties to even, as its bit pattern."""
    f = np.float32(float(x))  # at most one float32 step off (double rounding)
    cands = [f, np.nextafter(f, np.float32(-np.inf)), np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.uint32)) & 1))
    return int(np.array(best).view(np.int32))


def _exact_bits(a, b, c) -> np.ndarray:
    return np.array([_round32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.int32)


def _ulp32(x: np.ndarray) -> np.ndarray:
    x = np.abs(x).astype(np.float32)
    return (np.nextafter(x, np.float32(np.inf)) - x).astype(np.float64)


def _ties(kind: str, seed: int):
    """Float32 (a, b, c) whose float64 ``a*b + c`` is a float32 midpoint.

    ``c`` is a float32 and ``a*b = ±h(1 + eps)`` with ``h`` half the float32
    step from ``c`` to the neighbour named by ``kind`` and ``|eps| < 2^-30``,
    so the float64 sum is ``c ± h`` and its error ``±h*eps``; ``eps`` comes
    from ``a * float32(1/a)``, and is 0 for ``err_zero``."""
    rng = np.random.default_rng(seed)
    n = N_TIES
    if kind == "err_zero":
        a = np.ones(n, np.float32)
        eps_ok = np.ones(n, bool)
    else:
        a = rng.uniform(1.0, 2.0, 64 * n).astype(np.float32)
        inv = (np.float32(1.0) / a).astype(np.float32)
        eps = a.astype(np.float64) * inv.astype(np.float64) - 1.0
        eps_ok = (eps != 0) & (np.abs(eps) < 2.0 ** -30)
        a = a[eps_ok][:n]
        assert a.size == n
    inv = np.ones(n, np.float32) if kind == "err_zero" else (np.float32(1.0) / a).astype(np.float32)
    exp = rng.integers(-20, 21, n)
    if kind == "power_of_two":
        mag = np.ldexp(1.0, exp)
    elif kind == "below_power_of_two":
        mag = np.ldexp(1.0, exp) - np.ldexp(1.0, exp - 24)  # the float32 just below
    else:
        mag = np.ldexp(rng.uniform(1.0, 2.0, n), exp)
    c = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    # away from zero: half a step of |c|; towards zero: half the step
    # below |c|, which is half as wide at a power of two
    away = rng.random(n) < 0.5
    if kind == "power_of_two":
        away[:] = False
    step = np.where(away, _ulp32(c),
                    np.abs(c).astype(np.float64) - np.nextafter(
                        np.abs(c), np.float32(0)).astype(np.float64))
    h = step / 2
    sign = np.sign(c.astype(np.float64)) * np.where(away, 1.0, -1.0)
    b = (inv.astype(np.float64) * h * sign).astype(np.float32)
    assert np.array_equal(b.astype(np.float64), inv.astype(np.float64) * h * sign)
    return a, b, c


def _random(seed: int):
    rng = np.random.default_rng(seed)
    n = N_RANDOM
    a = np.ldexp(rng.uniform(-2, 2, n), rng.integers(-12, 12, n)).astype(np.float32)
    b = np.ldexp(rng.uniform(-2, 2, n), rng.integers(-12, 12, n)).astype(np.float32)
    c = np.ldexp(rng.uniform(-2, 2, n), rng.integers(-12, 12, n)).astype(np.float32)
    # world-like values too: squared offsets and positions of one scale
    k = n // 4
    a[:k] = b[:k] = rng.uniform(-6, 6, k).astype(np.float32)
    c[:k] = (rng.uniform(-6, 6, k).astype(np.float32) ** 2).astype(np.float32)
    return a, b, c


CASES = ["above", "power_of_two", "below_power_of_two", "err_zero"]


def _run(a, b, c, batched: bool) -> np.ndarray:
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    if not batched:
        out = fma32(ta, tb, tc)
    else:
        with no_vmap_fallback():
            out = torch.func.vmap(fma32)(ta.view(8, -1), tb.view(8, -1), tc.view(8, -1))
        out = out.reshape(-1)
    assert out.dtype == torch.float32
    return out.numpy().view(np.int32)


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "vmap"])
@pytest.mark.parametrize("kind", CASES)
def test_fma32_midpoint_ties_exact(kind, batched):
    a, b, c = _ties(kind, seed=CASES.index(kind))
    s = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    # the inputs are what they claim: every float64 sum is a float32 midpoint
    assert np.all((s.view(np.int64) & ((1 << 29) - 1)) == 1 << 28)
    bp = s - a.astype(np.float64) * b.astype(np.float64)
    err = (a.astype(np.float64) * b.astype(np.float64) - (s - bp)) + (c.astype(np.float64) - bp)
    if kind == "err_zero":
        assert np.all(err == 0)
    else:
        assert np.all(err != 0) and (err > 0).any() and (err < 0).any()
    got = _run(a, b, c, batched)
    np.testing.assert_array_equal(got, _exact_bits(a, b, c))
    # the float64 sum rounded to float32 is wrong on the ties with an error
    naive = s.astype(np.float32).view(np.int32)
    if kind != "err_zero":
        assert (naive != got).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_fma32_random_exact_and_batched_equal(seed):
    a, b, c = _random(seed)
    plain = _run(a, b, c, batched=False)
    np.testing.assert_array_equal(_run(a, b, c, batched=True), plain)
    idx = np.random.default_rng(seed + 100).choice(N_RANDOM, N_EXACT, replace=False)
    np.testing.assert_array_equal(plain[idx], _exact_bits(a[idx], b[idx], c[idx]))


def test_fma32_vmap_with_unbatched_operand():
    """A walker's step: the scalar operand is shared by every room."""
    a, b, c = _ties("above", seed=7)
    ta, tc = torch.from_numpy(a).view(8, -1), torch.from_numpy(c).view(8, -1)
    tb = torch.from_numpy(b[: ta.shape[1]])
    with no_vmap_fallback():
        got = torch.func.vmap(fma32, in_dims=(0, None, 0))(ta, tb, tc)
    want = fma32(ta, tb.expand_as(ta), tc)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        want.reshape(-1).numpy().view(np.int32),
        _exact_bits(a, np.tile(b[: ta.shape[1]], 8), c))
