"""Sample generators: the reference's ``independent``, ``stratified``,
``multijitter``, ``orthogonal`` and ``ldsampler`` kinds.

Port of ``eradiate_tpu/ops/samplers.py``, bit for bit. The sampler kind
shapes the primary dimension, the first flight's distance uniform
(:func:`primary_samples`, one point set a pixel from the pixel's threefry
key); every other dimension of every bounce draws an Owen-scrambled van der
Corput point indexed by the sample's slot in its pixel
(:func:`padded_bounce_uniforms`).

torch has no uint32 arithmetic on every device, so words live in int64 and
are masked to 32 bits after every step; products of two full words take the
low 32 bits from 16-bit halves (:func:`.fastrng._mul32`).
"""

from __future__ import annotations

import torch

from ..core.threefry import permutation_t, split_t, uniform_t
from .fastmath import fma32
from .fastrng import MASK, _mul32

__all__ = ["SAMPLER_KINDS", "primary_samples", "owen_scrambled_vdc", "padded_bounce_uniforms"]

SAMPLER_KINDS = (
    "independent",
    "stratified",
    "multijitter",
    "orthogonal",
    "ldsampler",
)

_2_POW_M32 = 2.3283064365386963e-10
_2_POW_M24 = 5.960464477539063e-08


def _reverse_bits32(i):
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    return ((i << 16) & MASK) | (i >> 16)


def _radical_inverse_base2(i):
    """Van der Corput points of integers ``i``: their bits reversed, as
    float32 (rounded to nearest) times 2^-32."""
    return _reverse_bits32(i & MASK).to(torch.float32) * _2_POW_M32


def primary_samples(kind, spp, keys):
    """Primary-dimension samples ``[..., spp]`` in [0, 1) for pixel keys
    ``[..., 2]`` (the reference's ``primary_samples`` of one key, for each
    key).

    - ``independent``: iid uniforms;
    - ``stratified``: one jittered sample per stratum;
    - ``multijitter``: strata with a permuted sub-stratum offset and a jitter;
    - ``orthogonal``: a randomly permuted stratified set;
    - ``ldsampler``: van der Corput points with a Cranley-Patterson shift.
    """
    if kind == "independent":
        return uniform_t(keys, (spp,))
    idx = torch.arange(spp, dtype=torch.int64, device=keys.device)
    # the jitted reference divides by spp as a product with the float32
    # reciprocal (XLA's rewrite of a division by a constant)
    inv = torch.tensor(1.0, dtype=torch.float32, device=keys.device) / spp
    if kind == "stratified":
        return (idx.to(torch.float32) + uniform_t(keys, (spp,))) * inv
    if kind in ("multijitter", "orthogonal"):
        pair = split_t(keys)
        perm = permutation_t(pair[..., 0, :], spp).to(torch.float32)
        jitter = uniform_t(pair[..., 1, :], (spp,))
        if kind == "multijitter":
            # the inner product and sum as one fused multiply-add, as XLA:CPU
            # contracts them
            return fma32(perm + jitter, inv, idx.to(torch.float32)) * inv
        return (perm + jitter) * inv
    if kind == "ldsampler":
        shift = uniform_t(keys, ())[..., None]
        return torch.remainder(_radical_inverse_base2(idx) + shift, 1.0)
    raise ValueError(f"unsupported sampler kind '{kind}'")


def _laine_karras(x, seed):
    """Hash-based nested-uniform (Owen) permutation in the base-2 suffix
    domain: bit k of the output depends only on bits <= k of the input."""
    x = (x + seed) & MASK
    for m in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, m)
    return x


def _hash32(x):
    """Finalizer-style integer hash."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def owen_scrambled_vdc(idx, seed):
    """Owen-shuffled, Owen-scrambled base-2 van der Corput points in [0, 1)
    of uint32 ``idx`` and ``seed`` (same shape), as float32: the top 24
    bits of ``rev(LK(rev(LK(rev(i), s_shuffle)), s_scramble))`` times
    2^-24."""
    idx = idx & MASK
    seed = seed & MASK
    s_shuffle = _hash32(seed ^ 0x55AA55AA)
    s_scramble = _hash32(seed ^ 0x33CC33CC)
    i2 = _reverse_bits32(_laine_karras(_reverse_bits32(idx), s_shuffle))
    x = _reverse_bits32(_laine_karras(i2, s_scramble))
    return (x >> 8).to(torch.float32) * _2_POW_M24


def padded_bounce_uniforms(slot, pix_seed, depth_b, n_dims=10):
    """``[B, n_dims]`` Owen-scrambled van der Corput points for one bounce:
    ``slot`` [B] the sample's index within its pixel, ``pix_seed`` [B] its
    pixel's scramble base, ``depth_b`` [B] the bounce depth; each (pixel,
    depth, dimension) has a scramble of its own."""
    dims = torch.arange(n_dims, dtype=torch.int64, device=slot.device)
    h = _hash32(
        (_mul32(depth_b[:, None] & MASK, 0x9E3779B9) + _mul32(dims[None, :], 0x85EBCA6B)) & MASK
    )
    seeds = _hash32((pix_seed[:, None] & MASK) ^ h)
    return owen_scrambled_vdc(slot[:, None].expand_as(seeds), seeds)
