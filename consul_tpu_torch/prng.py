"""A bit-exact twin of the ``jax.random`` calls the SWIM round makes.

The reference draws every random number of a round from ``jax.random``
under this configuration: the ``threefry2x32`` implementation,
``jax_threefry_partitionable=True`` and 64-bit mode off.  This module
reproduces those draws bit for bit, so the port's round under the same
key takes the same decisions as the reference's:

- ``key``/``PRNGKey``: ``threefry_seed`` — ``[seed >> 32, seed & 0xFFFFFFFF]``
  of an int32 seed, i.e. ``[0, seed]`` for a non-negative one;
- ``fold_in``: ``threefry_2x32(key, [0, data])``;
- ``split``: the partitionable fold-like split, counters from the
  flattened iota of the output shape (hi word 0, lo word the index);
- ``random_bits`` (32-bit): the same counters, result ``bits1 ^ bits2``;
- ``uniform`` (float32 in [0, 1)): the top 23 bits as the mantissa of a
  float in [1, 2), minus 1;
- ``randint`` (int32): two 32-bit draws from ``split(key)``, reduced by
  the span/multiplier rule of ``jax.random.randint``.

A key is a host ``numpy.uint32[2]`` (``jax.random.key_data(key)`` of the
reference).  Key derivation and the small draws (gossip offsets, probe
offsets) run on the host in Python integers: they are a handful of
scalars per round and the round needs them as host integers anyway (they
are roll shifts and slice starts), so no device→host read is spent on
them.  The large draws (one uniform per prober) run on the device as
plain torch code (``uniform_tensor``) — the reference computes them in
XLA, outside any Pallas kernel.

All 32-bit unsigned arithmetic is carried in signed 64-bit values masked
to 32 bits: torch's ``uint32`` does not support add, shifts or compares
on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (jax ``_threefry2x32_lowering``).

    Operands are non-negative values below 2**32 carried in any type
    with 64-bit integer ``+ ^ << >> &``: Python ints on the host, int64
    tensors on a device.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is uint32[2], got {k.dtype}{list(k.shape)}")
    return int(k[0]), int(k[1])


def _as_key(k1: int, k2: int) -> np.ndarray:
    return np.asarray([k1, k2], dtype=np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for an int32 seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    # threefry_seed of an int32: the logical shift by 32 is 0, the low
    # word is the seed's bit pattern.
    return _as_key(0, seed & _M32)


PRNGKey = key


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: hash the pair ``[0, data]``."""
    k1, k2 = _key_words(k)
    return _as_key(*_threefry2x32(k1, k2, 0, int(data) & _M32))


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` as ``uint32[num, 2]``."""
    k1, k2 = _key_words(k)
    out = [_threefry2x32(k1, k2, 0, i) for i in range(num)]
    return np.asarray(out, dtype=np.uint32).reshape(num, 2)


def _bits_host(k, shape) -> list[int]:
    k1, k2 = _key_words(k)
    return [a ^ b for a, b in
            (_threefry2x32(k1, k2, 0, i) for i in range(math.prod(shape)))]


def random_bits(k, shape=()) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)`` on the host."""
    shape = tuple(shape)
    return np.asarray(_bits_host(k, shape), dtype=np.uint32).reshape(shape)


def _to_unit_float(bits: np.ndarray) -> np.ndarray:
    mant = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).astype(np.uint32)
    return mant.view(np.float32) - np.float32(1.0)


def uniform(k, shape=()) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` (float32, [0, 1)) on the host."""
    return _to_unit_float(random_bits(k, shape))


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, int32)`` on the host."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -2**31 <= v < 2**31:
            raise OverflowError(f"randint bound {v} does not fit int32")
    k_hi, k_lo = split(k, 2)
    higher, lower = _bits_host(k_hi, shape), _bits_host(k_lo, shape)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    # jax's multiplier (2**16 % span)**2 % span, with the square taken
    # in uint32 — it wraps, as it does there.
    mult = (2**16) % span
    mult = ((mult * mult) & _M32) % span
    out = []
    for hi, lo in zip(higher, lower):
        off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
        v = (minval + off % span) & _M32
        out.append(v - 2**32 if v >= 2**31 else v)
    return np.asarray(out, dtype=np.int32).reshape(shape)


# -- device draws --------------------------------------------------------------

def random_bits_tensor(k, shape, device) -> torch.Tensor:
    """``random_bits`` computed on ``device``: int64 values in [0, 2**32)."""
    k1, k2 = _key_words(k)
    shape = tuple(shape)
    lo = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, 0, lo)
    return (b1 ^ b2).reshape(shape)


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform_tensor(k, shape, device) -> torch.Tensor:
    """``uniform`` computed on ``device`` (float32, bit-identical)."""
    return _unit_float(random_bits_tensor(k, shape, device))


def uniform_rows(keys, n: int, device) -> torch.Tensor:
    """``[uniform(k, (n,)) for k in keys]`` stacked into one float32
    ``[len(keys), n]`` tensor, bit-identical, in one pass of the threefry
    ops (the keys ride a broadcast dimension)."""
    words = [_key_words(k) for k in keys]
    lo = torch.arange(n, dtype=torch.int64, device=device)
    # Fills on the device, not a host->device copy (which would
    # synchronise the stream).
    k1, k2 = (torch.cat([lo.new_full((1, 1), w[i]) for w in words])
              for i in (0, 1))
    b1, b2 = _threefry2x32(k1, k2, 0, lo)
    return _unit_float(b1 ^ b2)

