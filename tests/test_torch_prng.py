"""The port's threefry (``repro_torch.prng``) against ``jax.random``.

Keys and random bits must be bit-equal.  Normals are ``√2·erfinv(u)`` of
a bit-equal uniform; the port evaluates XLA's float32 erfinv polynomial
with torch's ``log1p`` and without fused multiply-adds, so a normal may
differ from jax's by a few ulps: the gate is 4 ulps of the value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch import prng
from torch_one_thread import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ULPS = 4


def _ulps(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(port - ref) / np.spacing(np.abs(ref))))


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 1, -1, -5,
                                  2 ** 32 - 1])
def test_prng_key_is_bit_equal(seed):
    assert np.array_equal(prng.PRNGKey(seed),
                          np.asarray(jax.random.PRNGKey(seed)))
    assert prng.PRNGKey(seed).dtype == np.uint32


def test_split_and_fold_in_are_bit_equal():
    rng = np.random.default_rng(0)
    for seed in rng.integers(0, 2 ** 31, 5):
        key = jax.random.PRNGKey(int(seed))
        pk = np.asarray(key)
        for n in (2, 3, 17):
            assert np.array_equal(prng.split(pk, n),
                                  np.asarray(jax.random.split(key, n)))
        for data in (0, 1, 123456, 2 ** 32 - 1):
            assert np.array_equal(prng.fold_in(pk, data),
                                  np.asarray(jax.random.fold_in(key, data)))
        # a chain of splits, as the uniform sampler walks it
        k, pkk = key, pk
        for _ in range(4):
            k, _ = jax.random.split(k)
            pkk, _ = prng.split(pkk)
        assert np.array_equal(pkk, np.asarray(k))


def test_batched_fold_in_matches_vmapped_jax():
    """The engine's row keys: fold_in(fold_in(key, rid), row_index)."""
    key = jax.random.PRNGKey(3)
    rids = np.array([0, 0, 1, 5, 5, 9], np.uint32)
    ridx = np.array([0, 1, 0, 2, 3, 0], np.uint32)
    ref = jax.vmap(lambda r, i: jax.random.fold_in(
        jax.random.fold_in(key, r), i))(jnp.asarray(rids), jnp.asarray(ridx))
    port = prng.fold_in(prng.fold_in(np.asarray(key)[None], rids), ridx)
    assert port.shape == (6, 2) and np.array_equal(port, np.asarray(ref))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 7), (2, 16, 16, 3)])
def test_random_bits_are_bit_equal(shape):
    key = jax.random.PRNGKey(11)
    port = prng.random_bits(np.asarray(key), shape).numpy()
    assert port.shape == shape
    assert np.array_equal(port.astype(np.uint32),
                          np.asarray(jax.random.bits(key, shape)))


def test_uniform_is_bit_equal_and_normal_within_ulps():
    key = jax.random.PRNGKey(5)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    n = (100_000,)
    u = prng.uniform_bits_to_float(prng.random_bits(np.asarray(key), n),
                                   float(lo), 1.0).numpy()
    assert np.array_equal(
        u, np.asarray(jax.random.uniform(key, n, minval=lo, maxval=1.0)))
    ref = np.asarray(jax.random.normal(key, n))
    port = prng.normal(np.asarray(key), n).numpy()
    assert port.dtype == np.float32
    assert _ulps(port, ref) <= ULPS
    assert float(np.max(np.abs(port - ref))) < 2e-6


def test_batched_normal_equals_one_jax_draw_per_key():
    """One vectorised call over a (S, B) batch of keys, as a ragged wave
    draws all of its steps' noise."""
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 6).reshape(2, 3, 2)
    port = prng.normal(np.asarray(keys), (4, 4, 3)).numpy()
    assert port.shape == (2, 3, 4, 4, 3)
    for i in range(2):
        for j in range(3):
            ref = np.asarray(jax.random.normal(keys[i, j], (4, 4, 3)))
            assert _ulps(port[i, j], ref) <= ULPS


def test_keys_must_be_uint32_pairs():
    with pytest.raises(TypeError):
        prng.fold_in(np.array([0, 1], np.int64), 3)
    with pytest.raises(TypeError):
        prng.split(np.zeros((3,), np.uint32))
