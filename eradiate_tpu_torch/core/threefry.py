"""Host-side threefry2x32: the row and chunk keys of a render.

The reference derives one key per (seed, spectral row, sample chunk) with
``jax.random.key(seed)`` -> ``fold_in(row)`` -> ``fold_in(chunk)``
(``eradiate_tpu/ops/tracer.py:752-762``); every per-sample and per-bounce
draw after that is pcg4d hashing (:mod:`eradiate_tpu_torch.ops.fastrng`).
Those few keys are computed here in Python integers, bit for bit as JAX's
default threefry2x32 implementation computes them.

A key is a pair of uint32 words (JAX's ``key_data``).
"""

from __future__ import annotations

__all__ = ["threefry2x32", "key", "fold_in"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k: tuple[int, int], x: tuple[int, int]) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds of the block ``x`` under key ``k``."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x[0] + ks[0]) & _MASK
    x1 = (x[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """Key data of ``jax.random.key(seed)`` for a uint32 ``seed``."""
    return 0, int(seed) & _MASK


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """Key data of ``jax.random.fold_in(k, data)`` for a uint32 ``data``."""
    return threefry2x32(k, (0, int(data) & _MASK))
