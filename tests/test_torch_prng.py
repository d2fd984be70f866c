"""The port's threefry-2x32 against ``jax.random``.

``flow_updating_tpu_torch.utils.prng`` must give ``jax.random``'s words
bit for bit — the key from a seed, ``split`` and the Bernoulli keep mask
of message loss — or no lossy run of the port could be compared with the
JAX package.  The suite runs JAX with ``jax_enable_x64`` (tests/conftest),
where ``bernoulli`` with a Python-float ``p`` draws in float64; the float32
draw (JAX without x64, e.g. its CLI) is checked by giving JAX a float32
``p``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow_updating_tpu_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


SEEDS = [0, 1, 7, 2024, 2**31 - 1, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed, device="cpu")
    assert np.array_equal(np.asarray(jkey).astype(np.int64), key.numpy())
    for num in (2, 3, 8):
        assert np.array_equal(
            np.asarray(jax.random.split(jkey, num)).astype(np.int64),
            prng.split(key, num).numpy())
    # the round's chain: key, sub = split(key), twice
    jk, k = jkey, key
    for _ in range(2):
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k)
        assert np.array_equal(np.asarray(jsub).astype(np.int64), sub.numpy())
    assert np.array_equal(np.asarray(jk).astype(np.int64), k.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 17, 1000, 4099])
@pytest.mark.parametrize("p", [0.9, 0.5, 0.1])
def test_bernoulli_masks_equal_jax(seed, n, p):
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    _, tsub = prng.split(prng.prng_key(seed, device="cpu"))
    want64 = np.asarray(jax.random.bernoulli(sub, p, (n,)))
    assert np.array_equal(want64, prng.bernoulli(tsub, p, n,
                                                 torch.float64).numpy())
    want32 = np.asarray(jax.random.bernoulli(sub, jnp.float32(p), (n,)))
    assert np.array_equal(want32, prng.bernoulli(tsub, p, n,
                                                 torch.float32).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_equal_jax_and_in_range(dtype):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.uniform(
        key, (5000,), jnp.float32 if dtype == torch.float32
        else jnp.float64))
    got = prng.uniform(prng.prng_key(3, device="cpu"), 5000, dtype).numpy()
    assert np.array_equal(want, got)
    assert got.min() >= 0.0 and got.max() < 1.0
    with pytest.raises(ValueError, match="float32 or float64"):
        prng.uniform(prng.prng_key(3, device="cpu"), 4, torch.float16)
