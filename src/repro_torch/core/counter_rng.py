"""Counter-based random draws: JAX's Threefry-2x32 streams in PyTorch.

The port draws its minibatch ids, random-topology targets and link failures
as the reference does, with ``jax.random``'s default generator
(threefry2x32, ``jax_threefry_partitionable``): every number is a pure
function of a key and a counter, so iteration t's draws do not depend on
how a run is chunked, streamed or resumed, nor on the device, and they are
the reference's own draws bit for bit.

Keys are pairs ``(k1, k2)`` of 32-bit words, each a Python int or an int64
tensor; tensor parts broadcast, so a chunk of iterations is drawn in a few
elementwise passes, with no launch per iteration and no stateful
generator. Every intermediate stays far below 2^63 in int64 (a word
shifted left by at most 29 bits, a sum below 2^37, the product of two
values below 2^31), so the CPU and the card compute the same bits.

Only what the trainer uses is here: ``PRNGKey``, ``fold_in`` (``split``
under the partitionable flag is ``fold_in`` of the key index),
``random_bits``, ``randint`` (int32) and ``bernoulli`` (float32, the
default ``mode="low"``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "randint",
           "bernoulli"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) of key ``(k1, k2)`` on
    the counter words ``(x1, x2)``; returns the two output words. As JAX's
    ``threefry2x32_p``. ``x1`` is reduced mod 2^32 only at the end (only its
    low word reaches ``x2`` or the result; it stays below 2^37); ``x2`` is a
    word at every rotation."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + k1
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & _M32
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1 & _M32, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in 32 signed bits, got {seed}")
    return 0, seed & _M32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``; also ``jax.random.split(key, n)[data]``
    (the partitionable split). ``data`` an int or an int64 tensor of
    uint32 values; broadcasts with the key's parts."""
    return threefry2x32(key[0], key[1], 0, data)


def random_bits(key, index):
    """``jax.random.bits(key, shape)`` (32 bits) at the flat row-major
    ``index`` of each element in ``shape``."""
    y1, y2 = threefry2x32(key[0], key[1], 0, index)
    return y1 ^ y2


def randint(key, index, maxval):
    """``jax.random.randint(key, shape, 0, maxval)`` (int32) at the flat
    ``index`` of each element: two words a value, reduced mod the span as
    JAX reduces them (uint32 arithmetic, wrapping). With a key of Python
    ints, an int ``index`` and an int ``maxval`` it is computed on the host
    in Python ints (no device work for a single draw)."""
    if isinstance(index, int):
        hi = random_bits(fold_in(key, 0), index)  # split(key): a key for each word
        lo = random_bits(fold_in(key, 1), index)
        span = max(int(maxval), 1)
        mult = ((2 ** 16 % span) ** 2 & _M32) % span
        return ((((hi % span) * mult & _M32) + lo % span) & _M32) % span
    ndim = max(index.dim(), *(torch.as_tensor(k).dim() for k in key))
    parts = torch.arange(2, dtype=torch.int64, device=index.device).view((2,) + (1,) * ndim)
    hi, lo = random_bits(fold_in(key, parts), index)  # split(key): a key for each word
    span = torch.as_tensor(maxval, dtype=torch.int64, device=index.device)
    span = torch.where(span <= 0, torch.ones_like(span), span)
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    offset = ((hi % span) * mult & _M32) + lo % span
    return (offset & _M32) % span


def bernoulli(key, index, p: float):
    """``jax.random.bernoulli(key, p, shape)`` for a float32 ``p`` at the flat
    ``index`` of each element: ``uniform < p``, the uniform being the top 23
    bits times 2^-23."""
    threshold = math.ceil(float(np.float32(p)) * 2.0 ** 23)
    return (random_bits(key, index) >> 9) < threshold
