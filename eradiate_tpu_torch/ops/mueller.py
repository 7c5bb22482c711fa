"""Mueller/Stokes calculus for polarized transport, batched over lanes.

Port of ``eradiate_tpu/ops/mueller.py``, with the same conventions: Stokes
vectors (I, Q, U, V) are defined with respect to a unit reference basis
vector ``b`` perpendicular to the propagation direction ``d`` (Q > 0 means
polarization along ``b``); rotating the basis by ``phi`` around ``d``
(right-handed, looking against the propagation) transforms S by
:func:`rotator`; the Rayleigh phase matrix follows Hansen & Travis (1974)
with Chandrasekhar's depolarization, its (0, 0) element the scalar phase
function [1/sr].

The products of 4x4 matrices and 4-vectors (:func:`matmul4`,
:func:`matvec4`) are explicit four-term sums in a fixed order, so that the
CPU and the card round alike and no batched library call is made for a 4x4;
norms take the correctly rounded square root (:func:`.spherical.sqrt_rn`),
as XLA and CUDA do.
"""

from __future__ import annotations

import math

import torch

from .spherical import sqrt_rn

__all__ = [
    "rotator",
    "rayleigh_mueller",
    "depolarizer",
    "default_basis",
    "rotate_basis_angle",
    "stokes_rotate_to_basis",
    "cross",
    "dot",
    "norm",
    "matmul4",
    "matvec4",
    "matrix4",
]


def dot(a, b):
    """``sum(a * b, -1)`` over the last axis of length 3, in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(a):
    """Euclidean norm over the last axis of length 3."""
    return sqrt_rn(dot(a, a))


def cross(a, b):
    """Cross product over the last axis of length 3."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def matmul4(a, b):
    """``a @ b`` for ``[..., 4, 4]`` matrices: ``sum_j a[i, j] b[j, k]`` as
    four products added in the order j = 0, 1, 2, 3."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, 4):
        out = out + a[..., :, j : j + 1] * b[..., j : j + 1, :]
    return out


def matvec4(a, x):
    """``a @ x`` for ``[..., 4, 4]`` matrices and ``[..., 4]`` vectors, in
    the order of :func:`matmul4`."""
    out = a[..., :, 0] * x[..., 0:1]
    for j in range(1, 4):
        out = out + a[..., :, j] * x[..., j : j + 1]
    return out


def matrix4(rows):
    """A ``[..., 4, 4]`` tensor from four rows of four same-shape tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotator(phi):
    """Stokes rotation Mueller matrix R(phi) for a basis rotation by ``phi``
    around the propagation direction."""
    c = torch.cos(2.0 * phi)
    s = torch.sin(2.0 * phi)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return matrix4([[o, z, z, z], [z, c, s, z], [z, -s, c, z], [z, z, z, o]])


def rayleigh_mueller(cos_theta, depol):
    """Rayleigh scattering Mueller matrix [1/sr] with reference frames in the
    scattering plane on both sides (Hansen & Travis 1974 eqs. 2.15-2.16):
    with Delta = (1 - rho) / (1 + rho / 2) and Delta' = (1 - 2 rho) / (1 - rho),
    P = Delta P_pure + (1 - Delta) diag(1, 0, 0, 0) / (4 pi), P44 of P_pure
    scaled by Delta'."""
    c = cos_theta
    c2 = c * c
    scale = 3.0 / (16.0 * math.pi)
    delta = (1.0 - depol) / (1.0 + 0.5 * depol)
    delta_p = (1.0 - 2.0 * depol) / torch.clamp(1.0 - depol, min=1e-12)

    a = scale * (1.0 + c2)
    b = -scale * (1.0 - c2)
    d = 2.0 * scale * c
    z = torch.zeros_like(c)
    iso = 1.0 / (4.0 * math.pi)

    m00 = delta * a + (1.0 - delta) * iso
    m01 = delta * b
    m11 = delta * a
    m22 = delta * d
    m33 = delta * delta_p * d
    return matrix4([[m00, m01, z, z], [m01, m11, z, z], [z, z, m22, z], [z, z, z, m33]])


def depolarizer(value):
    """Ideal depolarizer Mueller matrix scaled by ``value`` (diffuse
    surfaces): only M00 nonzero."""
    z = torch.zeros_like(value)
    return matrix4([[value, z, z, z], [z, z, z, z], [z, z, z, z], [z, z, z, z]])


def default_basis(d):
    """Deterministic reference basis perpendicular to ``d`` [..., 3]: the
    meridian-plane basis (b in the (d, z) plane) when d is not parallel to
    z, the x axis orthogonalized against d at the poles."""
    zero = torch.zeros_like(d[..., 0])
    one = torch.ones_like(zero)
    b = torch.stack([zero, zero, one], dim=-1) - d * d[..., 2:3]
    n = norm(b)[..., None]
    fb = torch.stack([one, zero, zero], dim=-1) - d * d[..., 0:1]
    fb = fb / torch.clamp(norm(fb)[..., None], min=1e-12)
    return torch.where(n > 1e-6, b / torch.clamp(n, min=1e-12), fb)


def rotate_basis_angle(d, b_from, b_to):
    """Signed angle rotating ``b_from`` onto ``b_to`` around ``d`` (unit
    bases perpendicular to ``d``; right-handed around d looking against the
    propagation, the convention of :func:`rotator`)."""
    cosang = torch.clamp(dot(b_from, b_to), -1.0, 1.0)
    sinang = dot(cross(b_from, b_to), d)
    return torch.atan2(sinang, cosang)


def stokes_rotate_to_basis(S, d, b_from, b_to):
    """Re-express Stokes vectors ``S`` [..., 4] from basis ``b_from`` to
    basis ``b_to``."""
    return matvec4(rotator(rotate_basis_angle(d, b_from, b_to)), S)
