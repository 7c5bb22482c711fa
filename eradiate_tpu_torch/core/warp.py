# Host-code copy of eradiate_tpu/core/warp.py; regenerate with tools/copy_host_code.py, do not edit.
"""Warping functions: unit square <-> disk / hemisphere / sphere mappings.

Mirror of ``src/eradiate/warp.py`` (square_to_uniform_disk, concentric disk,
square_to_uniform_hemisphere and inverses), written once for torch tensors
(the tracers) and numpy arrays (the host code). Samples are (..., 2) arrays in [0,1)^2; directions are
(..., 3) unit vectors.
"""

from __future__ import annotations

import numpy as np

import torch


class _TorchNamespace:
    """The numpy spellings this module uses, on torch tensors."""

    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)
    clip = staticmethod(torch.clip)
    arctan2 = staticmethod(torch.arctan2)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)


def _np(x):
    """Return the array namespace for x: torch for tensors (the tracers),
    numpy otherwise (the host code)."""
    return _TorchNamespace if isinstance(x, torch.Tensor) else np

__all__ = [
    "square_to_uniform_disk",
    "uniform_disk_to_square",
    "square_to_uniform_disk_concentric",
    "uniform_disk_to_square_concentric",
    "square_to_uniform_hemisphere",
    "uniform_hemisphere_to_square",
    "square_to_cosine_hemisphere",
    "square_to_uniform_sphere",
    "square_to_uniform_cone",
]


def square_to_uniform_disk(sample):
    xp = _np(sample)
    r = xp.sqrt(sample[..., 0])
    from ..ops.fastmath import cos_sin_2pi

    cp, sp = cos_sin_2pi(sample[..., 1])
    return xp.stack([r * cp, r * sp], axis=-1)


def uniform_disk_to_square(p):
    xp = _np(p)
    r2 = p[..., 0] ** 2 + p[..., 1] ** 2
    phi = xp.arctan2(p[..., 1], p[..., 0]) % (2.0 * np.pi)
    return xp.stack([r2, phi / (2.0 * np.pi)], axis=-1)


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu low-distortion concentric mapping."""
    xp = _np(sample)
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    # Handle degenerate origin
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = xp.abs(x) > xp.abs(y)
    r = xp.where(quadrant_x, x, y)
    ratio = xp.where(
        quadrant_x,
        xp.where(x != 0.0, y / xp.where(x == 0.0, 1.0, x), 0.0),
        xp.where(y != 0.0, x / xp.where(y == 0.0, 1.0, y), 0.0),
    )
    # azimuth in TURNS (phi / 2pi): the quadrant-reduced polynomial pair
    # (ops/fastmath.cos_sin_2pi) replaces libm cos+sin — measured at 40%
    # of c1 transport device time through the sampling call sites (r5)
    u_phi = xp.where(
        quadrant_x, (1.0 / 8.0) * ratio, 0.25 - (1.0 / 8.0) * ratio
    )
    r = xp.where(is_zero, 0.0, r)
    from ..ops.fastmath import cos_sin_2pi

    cp, sp = cos_sin_2pi(u_phi)
    return xp.stack([r * cp, r * sp], axis=-1)


def uniform_disk_to_square_concentric(p):
    xp = _np(p)
    x, y = p[..., 0], p[..., 1]
    r = xp.sqrt(x * x + y * y)
    phi = xp.arctan2(y, x)
    # Map phi to [-pi/4, 7pi/4)
    phi = xp.where(phi < -np.pi / 4.0, phi + 2.0 * np.pi, phi)
    quad1 = phi < np.pi / 4.0
    quad2 = (phi >= np.pi / 4.0) & (phi < 3.0 * np.pi / 4.0)
    quad3 = (phi >= 3.0 * np.pi / 4.0) & (phi < 5.0 * np.pi / 4.0)
    a = xp.where(
        quad1,
        r,
        xp.where(quad2, (phi - np.pi / 2.0) * r * (-4.0 / np.pi), 0.0),
    )
    b = xp.where(
        quad1,
        phi * r * 4.0 / np.pi,
        xp.where(quad2, r, 0.0),
    )
    a = xp.where(quad3, -r, a)
    b = xp.where(quad3, (phi - np.pi) * (-r) * 4.0 / np.pi, b)
    quad4 = ~(quad1 | quad2 | quad3)
    a = xp.where(quad4, (phi - 3.0 * np.pi / 2.0) * r * 4.0 / np.pi, a)
    b = xp.where(quad4, -r, b)
    return xp.stack([0.5 * (a + 1.0), 0.5 * (b + 1.0)], axis=-1)


def square_to_uniform_hemisphere(sample):
    """Uniform over the upper (+z) hemisphere; pdf = 1/(2 pi)."""
    xp = _np(sample)
    # Mitsuba-compatible mapping via concentric disk projection
    p = square_to_uniform_disk_concentric(sample)
    z = 1.0 - p[..., 0] ** 2 - p[..., 1] ** 2
    scale = xp.sqrt(xp.clip(2.0 - p[..., 0] ** 2 - p[..., 1] ** 2, 0.0, None))
    return xp.stack([p[..., 0] * scale, p[..., 1] * scale, z], axis=-1)


def uniform_hemisphere_to_square(d):
    # forward: (x, y) = p * sqrt(2 - r_d^2) with z = 1 - r_d^2, so the
    # disk point is (x, y) / sqrt(1 + z)
    xp = _np(d)
    denom = xp.sqrt(xp.clip(1.0 + d[..., 2], 1e-12, None))
    p = xp.stack([d[..., 0] / denom, d[..., 1] / denom], axis=-1)
    return uniform_disk_to_square_concentric(p)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere; pdf = cos(theta)/pi."""
    xp = _np(sample)
    p = square_to_uniform_disk_concentric(sample)
    z = xp.sqrt(xp.clip(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2, 0.0, 1.0))
    return xp.stack([p[..., 0], p[..., 1], z], axis=-1)


def square_to_uniform_sphere(sample):
    xp = _np(sample)
    z = 1.0 - 2.0 * sample[..., 0]
    r = xp.sqrt(xp.clip(1.0 - z * z, 0.0, 1.0))
    from ..ops.fastmath import cos_sin_2pi

    cp, sp = cos_sin_2pi(sample[..., 1])
    return xp.stack([r * cp, r * sp, z], axis=-1)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z with half-angle acos(cos_cutoff);
    pdf = 1 / (2 pi (1 - cos_cutoff))."""
    xp = _np(sample)
    cos_theta = (1.0 - sample[..., 0]) + sample[..., 0] * cos_cutoff
    sin_theta = xp.sqrt(xp.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    from ..ops.fastmath import cos_sin_2pi

    cp, sp = cos_sin_2pi(sample[..., 1])
    return xp.stack([sin_theta * cp, sin_theta * sp, cos_theta], axis=-1)
