"""The port's threefry PRNG (noahgameframe_tpu_torch/core/prng.py) against
jax.random: keys, fold_in chains and float32 uniforms are bit-equal."""

import jax
import numpy as np
import pytest

from noahgameframe_tpu_torch.core import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -5]


def _u32(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(_u32(jk), tk.numpy())
    # the tick folds the tick number, then each phase call its position
    for data in (0, 1, 5, 29, 2**31 + 3, 2**32 - 1):
        jk, tk = jax.random.fold_in(jk, data), prng.fold_in(tk, data)
        np.testing.assert_array_equal(_u32(jk), tk.numpy())


@pytest.mark.parametrize("n", [1, 3, 64, 1001])
@pytest.mark.parametrize("seed", [0, 7, -5])
def test_uniform_bits_equal(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, (n, 2), minval=0.0, maxval=1581.1388))
    got = prng.uniform(prng.fold_in(prng.prng_key(seed, "cpu"), 3), (n, 2), 0.0, 1581.1388).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fold_in_takes_a_device_tick():
    """The tick arrives as a 0-dim int32 tensor; folding it must match
    folding the same number from the host."""
    import torch

    key = prng.prng_key(11, "cpu")
    np.testing.assert_array_equal(
        prng.fold_in(key, torch.tensor(41, dtype=torch.int32)).numpy(),
        prng.fold_in(key, 41).numpy())
