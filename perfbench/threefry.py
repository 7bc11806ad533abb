"""Frozen Threefry-2x32 arithmetic: JAX's default counter-based generator
(``jax_threefry_partitionable``) in int64 tensor ops.

The plain reference draws GADGET's minibatch ids, random-neighbour targets
and link-failure masks with it, from the seed alone, so that what the
program draws is judged against draws made without the program. Every
intermediate stays below 2^63 in int64 (a 32-bit word shifted left by at
most 29 bits, sums below 2^37), so the CPU and the card compute the same
bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The 20-round block function of key ``(k1, k2)`` on counter words
    ``(x1, x2)``; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + k1
    x2 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & M32
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1 & M32, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed of 32 signed bits."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 signed bits, got {seed}")
    return 0, seed & M32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``, which is also ``split(key, n)[data]``."""
    return threefry2x32(key[0], key[1], 0, data)


def bits(key, index):
    """32 random bits at flat position ``index`` of ``jax.random.bits``."""
    y1, y2 = threefry2x32(key[0], key[1], 0, index)
    return y1 ^ y2


def randint(key, index: torch.Tensor, span) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span)`` at flat ``index``: a high
    and a low word from the key's two halves, reduced as JAX reduces them
    (uint32 arithmetic, wrapping)."""
    hi = bits(fold_in(key, 0), index)
    lo = bits(fold_in(key, 1), index)
    span = torch.as_tensor(span, dtype=torch.int64, device=index.device)
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    return ((((hi % span) * mult) & M32) + lo % span & M32) % span


def bernoulli(key, index: torch.Tensor, p: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` at flat ``index``: the top 23
    bits as a uniform in [0, 1) against float32 ``p``."""
    threshold = math.ceil(float(np.float32(p)) * 2.0 ** 23)
    return (bits(key, index) >> 9) < threshold
