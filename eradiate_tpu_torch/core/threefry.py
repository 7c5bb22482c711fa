"""threefry2x32: the row and chunk keys of a render, and JAX's key stream on
tensors.

The reference derives one key per (seed, spectral row, sample chunk) with
``jax.random.key(seed)`` -> ``fold_in(row)`` -> ``fold_in(chunk)``
(``eradiate_tpu/ops/tracer.py:752-762``). Those few keys are computed here in
Python integers (:func:`key`, :func:`fold_in`), bit for bit as JAX's default
threefry2x32 implementation computes them, by the same cipher that the tensor
functions below run.

The structured samplers, the one-shot tracer's target jitter and the legacy
``threefry`` per-bounce stream draw from JAX's key stream itself
(``jax.random.fold_in``, ``split``, ``bits``, ``uniform`` and
``permutation``). The ``*_t`` functions below reproduce it on tensors, bit for
bit as JAX computes it with ``jax_threefry_partitionable`` on (its default):
the counters of ``bits`` and ``split`` are the flat C-order index of each
output, split into its high and low 32-bit words, and a 32-bit output is the
xor of the cipher's two words. A key is a ``[..., 2]`` int64 tensor of
uint32 words; words live in int64 and are masked to 32 bits after every step,
as in :mod:`..ops.fastrng`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "key", "fold_in", "fold_in_t", "split_t", "bits_t", "uniform_t",
           "permutation_t"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds of the block ``(x0, x1)`` under the key
    ``(k0, k1)``, on uint32 words held in Python ints or int64 tensors
    (broadcasting): returns the block's two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """Key data of ``jax.random.key(seed)`` for a uint32 ``seed``."""
    return 0, int(seed) & _MASK


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """Key data of ``jax.random.fold_in(k, data)`` for a uint32 ``data``."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


# -- the key stream on tensors -------------------------------------------------


def fold_in_t(keys, data):
    """``jax.random.fold_in`` over a batch: keys ``[..., 2]`` and uint32
    ``data`` (an int or a tensor broadcasting with ``keys[..., 0]``)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def _counters(keys, shape):
    """The (high, low) counter words of ``bits``/``split`` of ``shape``: the
    flat C-order index of each output, broadcast behind the keys' batch."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    lead = (1,) * (keys.ndim - 1)
    return (idx >> 32).reshape(lead + tuple(shape)), (idx & _MASK).reshape(lead + tuple(shape))


def _cipher(keys, shape):
    hi, lo = _counters(keys, shape)
    sel = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][sel], keys[..., 1][sel], hi, lo)


def split_t(keys, num=2):
    """``jax.random.split(key, num)`` for each key of ``[..., 2]``: returns
    ``[..., num, 2]``."""
    a, b = _cipher(keys, (num,))
    return torch.stack([a, b], dim=-1)


def bits_t(keys, shape):
    """``jax.random.bits(key, shape)`` (uint32) for each key of ``[..., 2]``:
    an int64 tensor ``[..., *shape]`` of uint32 words."""
    a, b = _cipher(keys, tuple(shape))
    return a ^ b


def uniform_t(keys, shape, dtype=torch.float32):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) for each key of
    ``[..., 2]``: random mantissa bits under the exponent of 1.0, minus 1.
    float64 takes 64 random bits (the high word from the cipher's first
    output, the low from its second), as JAX does under x64."""
    shape = tuple(shape)
    if dtype == torch.float32:
        x = (bits_t(keys, shape) >> 9) | 0x3F800000
        return x.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        a, b = _cipher(keys, shape)
        # (a << 32 | b) >> 12, kept below 2^52 so that int64 holds it
        x = (a << 20) | (b >> 12) | 0x3FF0000000000000
        return x.view(torch.float64) - 1.0
    raise TypeError(f"uniform_t takes float32 or float64, not {dtype}")


def permutation_t(keys, n):
    """``jax.random.permutation(key, n)`` for each key of ``[..., 2]``:
    ``[..., n]`` int64. JAX shuffles by rounds of stable sorts on fresh
    32-bit keys, ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each from the second
    key of a split whose first carries on."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(keys.shape[:-1] + (n,))
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1)))
    for _ in range(rounds):
        pair = split_t(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(bits_t(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
