"""``cos(2*pi*u)`` and ``sin(2*pi*u)`` by quadrant reduction.

Port of ``eradiate_tpu/ops/fastmath.py``: the same degree-4 polynomials,
evaluated in the same Horner order, with the same quadrant selects, so
sampled directions agree with the reference to the last few ulps. Works on
torch tensors (the tracers) and numpy arrays (the host code's warps);
float64 input keeps libm accuracy, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["cos_sin_2pi"]

_COS_Y = (2.31883391e-05, -1.38555251e-03, 4.16638976e-02,
          -4.99999242e-01, 9.99999979e-01)
_SIN_Y = (2.60838923e-06, -1.98107494e-04, 8.33307983e-03,
          -1.66666597e-01, 9.99999998e-01)

_HALF_PI = math.pi / 2.0


def cos_sin_2pi(u):
    """(cos(2*pi*u), sin(2*pi*u)) for ``u`` in turns."""
    if isinstance(u, torch.Tensor):
        xp = torch
    else:
        xp, u = np, np.asarray(u)
    if u.dtype in (torch.float64, np.float64):
        phi = (2.0 * math.pi) * u
        return xp.cos(phi), xp.sin(phi)
    w = u * 4.0
    q = xp.floor(w)
    x = (w - q) * _HALF_PI
    y = x * x
    c = _COS_Y[0]
    for a in _COS_Y[1:]:
        c = c * y + a
    s = _SIN_Y[0]
    for a in _SIN_Y[1:]:
        s = s * y + a
    s = s * x
    qi = q - 4.0 * xp.floor(q * 0.25)  # q mod 4, exact for f32
    swap = (qi == 1.0) | (qi == 3.0)
    cos_out = xp.where(swap, s, c)
    sin_out = xp.where(swap, c, s)
    neg_c = (qi == 1.0) | (qi == 2.0)
    neg_s = qi >= 2.0
    return (
        xp.where(neg_c, -cos_out, cos_out),
        xp.where(neg_s, -sin_out, sin_out),
    )
