"""isca_tpu_torch.utils.threefry against jax.random, bit for bit.

The stirring goldens depend on isca_tpu's exact jax.random draws, so the
port's threefry must give the same bits: PRNGKey for several seeds (one at
2^31, one above 2^32), a 10-deep chain of splits, and uniform(-1, 1) at
float32 and float64 on the spectral shapes of T21 (22, 23, 2) and T85
(86, 87, 2) and an odd shape. JAX runs in its default
jax_threefry_partitionable=True mode, which the port follows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isca_tpu_torch.utils import threefry

SEEDS = [0, 1, 42, 2**31, 2**32 + 5]
SHAPES = [(22, 23, 2), (86, 87, 2), (3, 5, 7)]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def test_jax_runs_the_partitionable_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    key = threefry.prng_key(seed, "cpu")
    assert key.dtype == torch.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_jax(seed):
    """Ten splits deep, each (key, sub) pair bit-equal, and a 5-way split."""
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed, "cpu")
    for _ in range(10):
        jpair, tpair = np.asarray(jax.random.split(jk)), threefry.split(tk)
        assert tpair.dtype == torch.uint32 and tpair.shape == (2, 2)
        np.testing.assert_array_equal(tpair.numpy(), jpair)
        jk, tk = jpair[0], tpair[0]
    np.testing.assert_array_equal(threefry.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bits(seed, jdtype, tdtype, shape):
    """uniform(-1, 1) from the stirring's sub-key, every bit equal."""
    _, jsub = jax.random.split(jax.random.PRNGKey(seed))
    _, tsub = threefry.split(threefry.prng_key(seed, "cpu"))
    want = np.asarray(jax.random.uniform(jsub, shape, dtype=jdtype, minval=-1.0, maxval=1.0))
    got = threefry.uniform(tsub, shape, tdtype, -1.0, 1.0).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert got.min() >= -1.0 and got.max() < 1.0


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
def test_uniform_default_range_matches_jax(jdtype, tdtype):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.uniform(key, (4, 9), dtype=jdtype))
    got = threefry.uniform(threefry.prng_key(7, "cpu"), (4, 9), tdtype).numpy()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_uniform_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        threefry.uniform(threefry.prng_key(0, "cpu"), (2,), torch.float16)
