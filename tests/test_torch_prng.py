"""The port's PRNG twin (consul_tpu_torch/prng.py) against jax.random,
bit for bit, at every shape and dtype the SWIM round draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu_torch import prng

SEEDS = (0, 1, 7, 42, 2**31 - 1, -1)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("make", ["key", "PRNGKey"])
def test_key(seed, make):
    assert np.array_equal(_kd(getattr(jax.random, make)(seed)),
                          getattr(prng, make)(seed))


def test_jax_prng_config():
    """The configuration the twin reproduces."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", (0, 7, 42))
def test_round_key_schedule(seed):
    """The fold_in chains and split of _swim_round_impl (kernel.py:886-888,
    :957) over a run of rounds."""
    jb, tb = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for rnd in list(range(0, 40)) + [1000, 2**20, 2**31 - 1]:
        jk, tk = jax.random.fold_in(jb, rnd), prng.fold_in(tb, rnd)
        assert np.array_equal(_kd(jk), tk), rnd
        for d in (1, 2, 3):
            assert np.array_equal(_kd(jax.random.fold_in(jk, d)),
                                  prng.fold_in(tk, d)), (rnd, d)
        assert np.array_equal(
            _kd(jax.random.split(jax.random.fold_in(jk, 1), 4)),
            prng.split(prng.fold_in(tk, 1), 4)), rnd


@pytest.mark.parametrize("num", (2, 3, 4))
def test_split(num):
    for seed in SEEDS:
        assert np.array_equal(_kd(jax.random.split(jax.random.key(seed), num)),
                              prng.split(prng.key(seed), num))


@pytest.mark.parametrize("shape", [(), (3,), (4,), (48,), (48, 3), (5, 7)])
def test_random_bits(shape):
    for seed in (3, 11):
        k = jax.random.key(seed)
        assert np.array_equal(np.asarray(jax.random.bits(k, shape, jnp.uint32)),
                              prng.random_bits(prng.key(seed), shape))


@pytest.mark.parametrize("n", [2, 3, 16, 240, 4096, 16_000, 1_000_000,
                               2**31 - 1])
@pytest.mark.parametrize("shape", [(3,), (4,), ()])
def test_randint(shape, n):
    """Gossip offsets (fanout,), probe offsets (1+indirect_k,) and the
    push/pull partner () over [1, N)."""
    for seed in (0, 5, 99):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
        tk = prng.fold_in(prng.PRNGKey(seed), 17)
        a = np.asarray(jax.random.randint(jk, shape, 1, n, jnp.int32))
        b = prng.randint(tk, shape, 1, n)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), (seed, a, b)


@pytest.mark.parametrize("n", [4, 1000, 10_000, 1_000_000])
def test_randint_scalar_from_zero(n):
    """The event flood's origin: ``randint(key(seed ^ 0x5EED), (), 0, n)``."""
    for seed in (0, 1, 2, 3, 17):
        a = np.asarray(jax.random.randint(jax.random.key(seed ^ 0x5EED), (),
                                          0, n))
        b = prng.randint(prng.key(seed ^ 0x5EED), (), 0, n)
        assert a.dtype == b.dtype and a.shape == b.shape == ()
        assert int(a) == int(b), (seed, a, b)


def test_randint_empty_span():
    """maxval <= minval returns minval, as jax does."""
    k = jax.random.key(4)
    for lo, hi in ((1, 1), (5, 2)):
        a = np.asarray(jax.random.randint(k, (4,), lo, hi, jnp.int32))
        assert np.array_equal(a, prng.randint(prng.key(4), (4,), lo, hi))


@pytest.mark.parametrize("shape", [(48,), (48, 3), (240,), (820, 3), (1,)])
def test_uniform_bitwise(shape):
    """Prober uniforms (B,), helper uniforms (B, k) and a full (N,) draw,
    compared bitwise, on the host and as a torch draw."""
    for seed in (0, 13):
        jk = jax.random.fold_in(jax.random.key(seed), 2)
        tk = prng.fold_in(prng.key(seed), 2)
        a = np.asarray(jax.random.uniform(jk, shape))
        b = prng.uniform(tk, shape)
        t = prng.uniform_tensor(tk, shape, "cpu")
        assert a.dtype == b.dtype == np.float32
        assert t.dtype == torch.float32 and tuple(t.shape) == shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        assert np.array_equal(a.view(np.uint32),
                              t.numpy().view(np.uint32))


@pytest.mark.parametrize("legs, n", [(1, 7), (3, 240), (2, 4099)])
def test_uniform_rows_bitwise(legs, n):
    """The drop masks' batched draw: one [N] uniform per key (the keys of
    the nemesis legs, ``fold_in(k_nem, f)``), bitwise."""
    jk, tk = jax.random.key(5), prng.key(5)
    want = [np.asarray(jax.random.uniform(jax.random.fold_in(jk, f), (n,)))
            for f in range(legs)]
    got = prng.uniform_rows([prng.fold_in(tk, f) for f in range(legs)], n,
                            "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (legs, n)
    for f in range(legs):
        assert np.array_equal(want[f].view(np.uint32),
                              got[f].numpy().view(np.uint32)), f


def test_bad_key_rejected():
    with pytest.raises(ValueError):
        prng.fold_in(np.zeros(2, np.int32), 1)
    with pytest.raises(OverflowError):
        prng.key(2**31)
