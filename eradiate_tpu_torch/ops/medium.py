"""Layered-medium traversal primitives (plane-parallel geometry).

Port of ``eradiate_tpu/ops/medium.py``, gather form (the reference's CPU
branch): with a piecewise-constant extinction profile the cumulative
vertical optical depth tau(z) is piecewise linear, so transmittance is
closed form and free-flight sampling inverts tau by table search.
:func:`interp_fetch` and :func:`fetch_pairs_at` are the same bracketed
interpolation for the tabulated phase function's tables.

:func:`collision_fetch` is the per-bounce search-and-fetch; it runs the
CUDA kernel for CUDA tensors and its plain twin for CPU tensors
(:mod:`eradiate_tpu_torch.kernels.collision_fetch`).
"""

from __future__ import annotations

import torch

from ..kernels.collision_fetch import collision_fetch

__all__ = [
    "MU_EPS",
    "clamp_mu",
    "searchsorted_leq",
    "take_1d",
    "interp_fetch",
    "fetch_pairs_at",
    "tau_at_z",
    "z_at_tau",
    "collision_fetch",
    "fetch_at_index",
]

#: Direction cosines are clamped away from zero (reference ``MU_EPS``).
MU_EPS = 1e-6


def clamp_mu(mu):
    """Clamp |mu| >= MU_EPS preserving sign (sign(0) treated as +)."""
    s = torch.where(mu < 0.0, -1.0, 1.0)
    return s * torch.clamp(torch.abs(mu), min=MU_EPS)


def searchsorted_leq(table, x):
    """Index i of the last table[i] <= x, clipped to [0, len(table) - 2]
    (``x`` taken in the table's dtype, as JAX promotes it)."""
    idx = torch.searchsorted(table, x.to(table.dtype).contiguous(), right=True) - 1
    return torch.clamp(idx, 0, table.shape[0] - 2)


def _interp_tables(x, x_table, y_tables):
    """Bracket each x in ``x_table``; return (idx, frac, [(y0, y1), ...])."""
    idx = searchsorted_leq(x_table, x)
    x0 = x_table[idx]
    x1 = x_table[idx + 1]
    ys = [(yt[idx], yt[idx + 1]) for yt in y_tables]
    frac = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-30), 0.0, 1.0)
    return idx, frac, ys


def interp_fetch(x, x_table, y_tables):
    """Bracketed linear interpolation of several tables: the bracket of each
    x in ``x_table`` [M] by search, then ``(y0, dy)`` of each table there.
    Returns ``(idx, frac, [(y0, dy), ...])``; interpolate as ``y0 + frac * dy``
    (reference ``interp_fetch``, its CPU gather branch)."""
    idx, frac, ys = _interp_tables(x, x_table, y_tables)
    return idx, frac, [(y0, y1 - y0) for y0, y1 in ys]


def fetch_pairs_at(idx, y_tables):
    """``(y[idx], y[idx + 1] - y[idx])`` of each table [M] at brackets
    ``idx`` the caller found (reference ``fetch_pairs_at``, its CPU gather
    branch)."""
    M = y_tables[0].shape[-1]
    nxt = torch.clamp(idx + 1, max=M - 1)
    return [(yt[idx], yt[nxt] - yt[idx]) for yt in y_tables]


def tau_at_z(z, z_levels, tau_levels):
    """Interpolate tau(z); z: [...], z_levels/tau_levels: [L+1]."""
    _, frac, ((t0, t1),) = _interp_tables(z, z_levels, (tau_levels,))
    return t0 + frac * (t1 - t0)


def z_at_tau(tau, z_levels, tau_levels):
    """Invert the piecewise-linear tau(z); returns (z, layer index). Within
    zero-extinction layers tau is flat; collisions never land there, so
    clamping into the bracketing layer is exact."""
    idx, frac, ((z0, z1),) = _interp_tables(tau, tau_levels, (z_levels,))
    return z0 + frac * (z1 - z0), idx


def take_1d(table, idx):
    """``table[idx]`` for a 1D table (reference ``take_1d``, gather form)."""
    return table[idx]


def fetch_at_index(idx, tables):
    """Per-layer tables stacked as ``[K, L]``, fetched at per-lane layer
    indices ``idx`` [B] in one gather; returns ``[K, B]`` (reference
    ``fetch_at_index``, its CPU gather branch, which takes and returns K
    separate tables)."""
    return tables[:, idx.long()]
