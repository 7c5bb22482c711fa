"""pcg4d hashing for the per-sample keys and per-bounce uniforms, and the
legacy threefry stream.

Port of ``eradiate_tpu/ops/fastrng.py``. The streams are bit for bit the
reference's: a key is a ``[..., 2]`` tensor of uint32 words; with ``impl``
``"pcg4d"`` (the default) every uniform is the top 24 bits of a pcg4d output
word times 2^-24 in float32, with ``"threefry"`` the per-sample keys are
``jax.random.fold_in`` of the row key and the uniforms
``jax.random.uniform`` of a key folded once more
(:mod:`..core.threefry`).

torch has no uint32 arithmetic on every device, so words live in int64 and
are masked to 32 bits after every step. Products of two full-range words
reach 2^64 and would overflow int64, so :func:`_mul32` builds the low 32
bits of such a product from 16-bit halves (each partial product stays below
2^49).
"""

from __future__ import annotations

import torch

from ..core.threefry import fold_in_t, uniform_t

__all__ = [
    "pcg4d",
    "uniforms_from_keys",
    "derive_keys",
    "origin_uniforms",
    "bounce_uniforms",
]

MASK = 0xFFFFFFFF
_M = 1664525
_A = 1013904223
_INV24 = 1.0 / (1 << 24)
#: domain salt of the per-sample key derivation (reference ``_DERIVE_SALT``)
_DERIVE_SALT = 0x9E3779B9
#: counter of the per-sample origin-jitter draw (reference ``_ORIGIN_CTR``)
_ORIGIN_CTR = 0x7A19


def _mul32(x, y):
    """Low 32 bits of ``x * y`` for words ``x``, ``y`` < 2^32 held in int64."""
    lo = x * (y & 0xFFFF)
    hi = (x * (y >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def _feedback(a, b, c, d):
    a = (a + _mul32(b, d)) & MASK
    b = (b + _mul32(c, a)) & MASK
    c = (c + _mul32(a, b)) & MASK
    d = (d + _mul32(b, c)) & MASK
    return a, b, c, d


def pcg4d(a, b, c, d):
    """One pcg4d mix over four uint32 words (int64 tensors or ints,
    broadcasting); reference ``fastrng.pcg4d``."""
    a, b, c, d = ((w * _M + _A) & MASK for w in (a, b, c, d))
    a, b, c, d = _feedback(a, b, c, d)
    a, b, c, d = (w ^ (w >> 16) for w in (a, b, c, d))
    return _feedback(a, b, c, d)


def _to_unit(x):
    # top 24 bits -> [0, 1) on the 2^-24 grid; exact in float32
    return (x >> 8).to(torch.float32) * _INV24


def uniforms_from_keys(keys, ctr, n):
    """``[B, n]`` float32 uniforms from keys ``[B, 2]`` and a per-lane
    counter ``ctr`` ``[B]``: block ``j`` of four outputs hashes
    ``(k0, k1, ctr, j)``."""
    k0, k1 = keys[..., 0], keys[..., 1]
    ctr = ctr & MASK
    cols = []
    for j in range((n + 3) // 4):
        cols.extend(pcg4d(k0, k1, ctr, j))
    return _to_unit(torch.stack(cols[:n], dim=-1))


def derive_keys(row_key, sid, impl="pcg4d"):
    """Per-sample keys ``[B, 2]`` from a row key ``[2]`` (or ``[B, 2]``) and
    global sample ids ``sid`` ``[B]``: one pcg4d mix folded to two words, or
    with ``impl`` ``"threefry"`` ``fold_in(row_key, sid)``."""
    if impl == "threefry":
        return fold_in_t(row_key.expand(sid.shape + (2,)), sid)
    a, b, c, d = pcg4d(row_key[..., 0], row_key[..., 1], sid & MASK, _DERIVE_SALT)
    return torch.stack([a ^ c, b ^ d], dim=-1)


def origin_uniforms(keys, n=2, impl="pcg4d", dtype=torch.float32):
    """Per-sample origin-jitter uniforms ``[B, n]`` (rectangle targets). The
    pcg4d uniforms are float32 whatever ``dtype`` (they lie on the 2^-24
    grid, so the reference's cast to the path's dtype changes nothing);
    threefry's are drawn in ``dtype``, which for float64 takes 64 random
    bits, as the reference's under x64."""
    ctr = torch.full(keys.shape[:-1], _ORIGIN_CTR, dtype=keys.dtype, device=keys.device)
    if impl == "threefry":
        return uniform_t(fold_in_t(keys, ctr), (n,), dtype)
    return uniforms_from_keys(keys, ctr, n)


def bounce_uniforms(keys, depth_b, n, impl="pcg4d"):
    """The per-bounce draw ``[B, n]`` at path depth ``depth_b`` ``[B]``;
    ``impl`` ``"threefry"`` is the legacy stream, ``uniform(fold_in(key,
    depth), (n,))``, and any other than these two raises ``ValueError``."""
    if impl == "threefry":
        return uniform_t(fold_in_t(keys, depth_b), (n,))
    if impl != "pcg4d":
        raise ValueError(f"unknown rng impl: {impl!r}")
    return uniforms_from_keys(keys, depth_b, n)
