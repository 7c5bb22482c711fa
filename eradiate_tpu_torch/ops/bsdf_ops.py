"""Surface BSDF evaluation and sampling, batched over lanes.

Port of the ``lambertian`` and ``black`` kinds of
``eradiate_tpu/ops/bsdf_ops.py``. ``wi`` and ``wo`` [B, 3] point away from
the surface (+z up); ``eval`` returns f [1/sr] with dL_o = f cos(theta_i)
dE_i; ``sample`` returns ``(w_new, f cos / pdf)``. Parameters are
per-spectral-row scalars.
"""

from __future__ import annotations

import math

import torch

from ..core.warp import square_to_cosine_hemisphere

__all__ = ["lambertian_eval", "bsdf_eval", "bsdf_sample_from_uniforms",
           "SUPPORTED_BSDFS"]

SUPPORTED_BSDFS = ("black", "lambertian")


def _mu(w):
    return torch.clamp(w[..., 2], min=0.0)


def lambertian_eval(params, wi, wo):
    rho = params["reflectance"]
    return torch.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / math.pi, 0.0)


def _check_kind(kind):
    if kind not in SUPPORTED_BSDFS:
        raise NotImplementedError(
            f"surface kind {kind!r} is not ported yet (supported: "
            f"{', '.join(SUPPORTED_BSDFS)})"
        )


def bsdf_eval(kind, params, wi, wo):
    """BRDF value f(wi, wo) [1/sr]."""
    _check_kind(kind)
    if kind == "black":
        return torch.zeros_like(wi[..., 0])
    return lambertian_eval(params, wi, wo)


def bsdf_sample_from_uniforms(kind, params, wo, u):
    """Cosine-hemisphere continuation from uniforms ``u`` [B, 2]; returns
    ``(w_new, weight)`` with weight = f cos / pdf = f pi."""
    _check_kind(kind)
    w_new = square_to_cosine_hemisphere(u)
    if kind == "black":
        return w_new, torch.zeros_like(wo[..., 0])
    return w_new, bsdf_eval(kind, params, w_new, wo) * math.pi
