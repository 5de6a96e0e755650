"""Threefry-2x32 random bits that equal ``jax.random``'s bit for bit.

The port's own copy of the counter-based generator behind
``jax.random.PRNGKey``, ``jax.random.bits``, ``jax.random.uniform`` and
``jax.random.bernoulli``, as JAX computes them with its default settings:
32-bit mode (``jax_enable_x64`` off), so a key is ``(0, seed mod 2**32)``,
and ``jax_threefry_partitionable`` on, so element ``i`` (row-major) of an
array of bits is ``x1 ^ x2`` of the threefry hash of the counter pair
``(i >> 32, i & 0xFFFFFFFF)`` under the key.

Every array is an int64 tensor holding the unsigned 32-bit values and
every sum is masked to 32 bits (this torch has no ``>>``, ``%`` or ``+`` on
uint32 tensors). The functions run on the device their ``device`` names.
"""
from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "prng_key", "random_bits", "uniform", "bernoulli"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(key: tuple[int, int], x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)``: int64 tensors of uint32 values, of one shape. Returns the two
    output words, int64 tensors of uint32 values."""
    k1, k2 = (int(k) & M32 for k in key)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & M32, (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed taken modulo
    2**32 (negative seeds wrap), the high word zero."""
    return 0, int(seed) & M32


def random_bits(key: tuple[int, int], shape, device=None):
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor."""
    shape = tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, i >> 32, i & M32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: tuple[int, int], shape, device=None):
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the top
    23 bits, as ``1.m - 1``."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: tuple[int, int], p: float, shape, device=None):
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``: ``uniform
    < p`` in float32."""
    return uniform(key, shape, device) < torch.tensor(p, dtype=torch.float32,
                                                      device=device)
