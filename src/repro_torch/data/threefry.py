"""The JAX package's counter-based PRNG (threefry2x32) in numpy.

The data pipeline draws every shard from ``jax.random``; a port rank must
draw the same tokens bit for bit, so this module computes the same streams
on the host with uint32 numpy arithmetic. It follows jax 0.9.0 with
``jax_threefry_partitionable=True`` (that release's default):

  * a key is a ``(2,)`` uint32 array; ``prng_key(seed)`` is ``[seed >> 32,
    seed & 0xFFFFFFFF]``;
  * ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under ``key``;
  * ``split(key, n)`` and 32-bit ``random_bits(key, shape)`` hash the
    64-bit iota over the shape, as a (high, low) uint32 pair, under
    ``key``: ``split`` keeps both words as the new keys, ``random_bits``
    returns their XOR;
  * ``randint`` draws high and low words from the two halves of a
    ``split`` and folds them into the span by the multiply-mod rule of
    ``jax.random.randint``; ``uniform`` puts 23 random bits in the
    mantissa of a float in [1, 2) and subtracts 1.

Every array operation wraps modulo 2**32 as the device arithmetic does.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block hash (20 rounds) of the count words
    ``(x1, x2)`` under ``key``; returns the two output words."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x1, np.uint32) + ks[0]
        b = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for data in [0, 2**32)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _iota_hash(key: np.ndarray, shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"shape {shape}: more than 2**32 counts")
    lo = np.arange(n, dtype=np.uint32).reshape(shape)
    return threefry2x32(key, np.zeros(shape, np.uint32), lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    a, b = _iota_hash(key, (num,))
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element, as ``jax.random.bits(key, shape)``."""
    a, b = _iota_hash(key, tuple(shape))
    return a ^ b


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int, maxval: int
            ) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(f"bounds [{minval}, {maxval}) outside int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        multiplier = np.uint32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + lower % span
        offset = offset % span
        return np.int32(minval) + offset.astype(np.int32)


def uniform(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))
