"""Unit-square warps used by the tracer.

Port of ``eradiate_tpu/core/warp.py`` (``square_to_uniform_disk_concentric``,
``square_to_cosine_hemisphere``, ``square_to_uniform_cone``). Samples are
``[..., 2]`` float32 tensors in [0, 1)^2; directions are ``[..., 3]``.
"""

from __future__ import annotations

import torch

from ..ops.fastmath import cos_sin_2pi

__all__ = [
    "square_to_uniform_disk_concentric",
    "square_to_cosine_hemisphere",
    "square_to_uniform_cone",
]


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu low-distortion concentric mapping."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quadrant_x, x, y)
    ratio = torch.where(
        quadrant_x,
        torch.where(x != 0.0, y / torch.where(x == 0.0, 1.0, x), 0.0),
        torch.where(y != 0.0, x / torch.where(y == 0.0, 1.0, y), 0.0),
    )
    # azimuth in turns, for the quadrant-reduced polynomial pair
    u_phi = torch.where(quadrant_x, 0.125 * ratio, 0.25 - 0.125 * ratio)
    r = torch.where(is_zero, 0.0, r)
    cp, sp = cos_sin_2pi(u_phi)
    return torch.stack([r * cp, r * sp], dim=-1)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere; pdf = cos(theta)/pi."""
    p = square_to_uniform_disk_concentric(sample)
    p0, p1 = p[..., 0], p[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - p0 * p0 - p1 * p1, 0.0, 1.0))
    return torch.stack([p0, p1, z], dim=-1)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z with half-angle
    acos(cos_cutoff); pdf = 1 / (2 pi (1 - cos_cutoff))."""
    s0 = sample[..., 0]
    cos_theta = (1.0 - s0) + s0 * cos_cutoff
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    cp, sp = cos_sin_2pi(sample[..., 1])
    return torch.stack([sin_theta * cp, sin_theta * sp, cos_theta], dim=-1)
