"""The JAX package's random stream in numpy: threefry2x32 keys and f32
uniform draws, bit for bit as ``jax.random`` gives them.

The port draws every initial parameter from this stream so that a model
built from a ``seed`` keyword starts from the same weights as the JAX
model built from the same keyword, without importing JAX. It copies the
four functions the JAX models use, in their default (partitionable) form:

- :func:`prng_key` is ``jax.random.PRNGKey``: with 64-bit types off, the
  seed is taken as an int64, cut to its low 32 bits and paired with a zero
  high word.
- :func:`split` is ``jax.random.split``: the threefry hash of the counter
  ``(hi, lo)`` of each flat index under the key, both output words kept.
- :func:`fold_in` is ``jax.random.fold_in``: the hash of the counter
  ``(0, data)``.
- :func:`uniform` is ``jax.random.uniform`` for f32: 32 random bits per
  element (the two hash words XORed), 23 of them as the mantissa of a
  float in [1, 2), less 1, then ``x * (maxval - minval) + minval`` in f32
  and not below ``minval``. XLA on the CPU contracts that product and sum
  into one fused multiply-add (one rounding), and so does :func:`fma32`.

A key is a ``uint32`` array of shape ``[2]``; :func:`split` returns
``[n, 2]``. Only the draws of initial parameters come from here: dropout
(``nets._dropout``) keeps its ``torch.Generator``, and no path of the port
runs it.
"""

from __future__ import annotations

import math

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)


def _rotl(x, d):
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds: the hash of the counter words ``x0``,
    ``x1`` (``uint32`` arrays of one shape) under ``key``."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, U32) + ks[0]
    x1 = np.asarray(x1, U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def _counters(shape):
    """The high and low words of each element's flat index."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(U32), idx.astype(U32)


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` (64-bit types off)."""
    lo = int(np.int64(seed)) & 0xFFFFFFFF
    return np.array([0, lo], U32)


def key_or_default(key):
    """``key`` as a ``uint32`` key; ``None`` is ``prng_key(0)``."""
    return prng_key(0) if key is None else np.asarray(key, U32)


def split(key, num=2):
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    bits0, bits1 = threefry2x32(key, *_counters((num,)))
    return np.stack([bits0, bits1], axis=-1)


def split_keys(key, n):
    """An iterator over ``split(key, n)`` (``key`` None: the default key),
    for modules that take their layers' keys in turn as JAX does."""
    return iter(split(key_or_default(key), n))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``."""
    bits0, bits1 = threefry2x32(key, np.zeros(1, U32),
                                np.array([int(data) & 0xFFFFFFFF], U32))
    return np.array([bits0[0], bits1[0]], U32)


def fma32(a, b, c):
    """``a * b + c`` of f32 arrays with one rounding to f32. The product is
    exact in f64; the sum is taken in f64 rounded to odd (its last bit set
    where the f64 sum was inexact), which then rounds to f32 as the exact
    sum would."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(np.uint64) & np.uint64(1)) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def random_bits(key, shape):
    """``uint32`` random bits of ``shape``."""
    bits0, bits1 = threefry2x32(key, *_counters(tuple(shape)))
    return bits0 ^ bits1


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    shape = tuple(int(d) for d in shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


def linear_bound(fan_in):
    """``1 / sqrt(fan_in)`` in f32, as ``jnp`` computes the bound of the JAX
    package's ``init_linear``."""
    return np.float32(1.0) / np.sqrt(np.float32(fan_in))
