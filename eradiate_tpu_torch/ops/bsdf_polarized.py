"""Polarized surface reflection: Mueller-matrix BRDFs, batched over lanes.

Port of ``eradiate_tpu/ops/bsdf_polarized.py``: ``maignan`` (reference
plugin ``scenes/bsdfs/_maignan.py:105``) and ``ocean_mishchenko``
(``scenes/bsdfs/_ocean_mishchenko.py``). Every other kind is an ideal
depolarizer of its scalar BRDF, so :func:`surface_mueller` is the one
dispatch point of the polarized tracers.

Frame convention: both reference bases lie **in the plane of incidence**
(spanned by the incident and outgoing propagation directions), the
"parallel" convention of :func:`.mueller.rayleigh_mueller`; Q > 0 means
polarization along the in-plane (p) basis. The complex Fresnel
coefficients are explicit real and imaginary parts; square roots are
correctly rounded (:func:`.spherical.sqrt_rn`), as the reference's are.
"""

from __future__ import annotations

import math

import torch

from .bsdf_ops import POLARIZED_SURFACES, bsdf_eval, rpv_eval
from .mueller import depolarizer, dot, matrix4, norm
from .spherical import sqrt_rn

__all__ = [
    "POLARIZED_SURFACES",
    "fresnel_mueller_elements",
    "maignan_mueller",
    "ocean_mishchenko_mueller",
    "maignan_eval",
    "ocean_mishchenko_eval",
    "surface_mueller",
]


def _mu(w):
    return torch.clamp(w[..., 2], min=0.0)


def fresnel_mueller_elements(cos_i, m_re, m_im):
    """Fresnel reflection Mueller elements ``(a, b, c, d)`` at incidence
    cosine ``cos_i`` for the relative complex refractive index ``m_re + i
    m_im``: the matrix [[a, b, 0, 0], [b, a, 0, 0], [0, 0, c, d], [0, 0, -d,
    c]] with a = (Rp + Rs) / 2, b = (Rp - Rs) / 2, c = Re(rp conj(rs)),
    d = Im(rp conj(rs)); Q referenced to the in-plane (p) basis."""
    cos_i = torch.clamp(cos_i, 1e-6, 1.0)
    sin2 = 1.0 - cos_i * cos_i

    # m^2 (complex), w = m^2 - sin^2(theta_i)
    m2_re = m_re * m_re - m_im * m_im
    m2_im = 2.0 * m_re * m_im
    w_re = m2_re - sin2
    w_im = m2_im

    # c2 = sqrt(w) = m cos(theta_t), principal branch (Im >= 0 for
    # absorbing media)
    mod = sqrt_rn(torch.clamp(w_re * w_re + w_im * w_im, min=1e-30))
    c2_re = sqrt_rn(torch.clamp((mod + w_re) / 2.0, min=0.0))
    c2_im = torch.sign(w_im + 1e-30) * sqrt_rn(torch.clamp((mod - w_re) / 2.0, min=0.0))

    def cdiv(ar, ai, br, bi):
        den = torch.clamp(br * br + bi * bi, min=1e-30)
        return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den

    # rs = (cos_i - c2) / (cos_i + c2)
    rs_re, rs_im = cdiv(cos_i - c2_re, -c2_im, cos_i + c2_re, c2_im)
    # rp = (m^2 cos_i - c2) / (m^2 cos_i + c2)
    rp_re, rp_im = cdiv(
        m2_re * cos_i - c2_re, m2_im * cos_i - c2_im,
        m2_re * cos_i + c2_re, m2_im * cos_i + c2_im,
    )

    Rs = rs_re * rs_re + rs_im * rs_im
    Rp = rp_re * rp_re + rp_im * rp_im
    a = 0.5 * (Rp + Rs)
    b = 0.5 * (Rp - Rs)
    # rp conj(rs)
    c = rp_re * rs_re + rp_im * rs_im
    d = rp_im * rs_re - rp_re * rs_im
    return a, b, c, d


def _fresnel_mueller_matrix(cos_i, m_re, m_im):
    a, b, c, d = fresnel_mueller_elements(cos_i, m_re, m_im)
    z = torch.zeros_like(a)
    return matrix4([[a, b, z, z], [b, a, z, z], [z, z, c, d], [z, z, -d, c]])


def _facet_geometry(wi, wo):
    """Specular facet geometry: incidence cosine on the half-vector facet
    and the facet's tilt cosine."""
    h = wi + wo
    h = h / torch.clamp(norm(h)[..., None], min=1e-12)
    cos_gamma = torch.clamp(dot(wi, h), 1e-6, 1.0)
    cos_beta = torch.clamp(h[..., 2], 1e-6, 1.0)
    return cos_gamma, cos_beta


def maignan_mueller(params, wi, wo, p=None):
    """Maignan (2009) polarized BRDF: the RPV base (depolarizing) plus the
    one-parameter Fresnel specular peak (their Eq. 21),
    ``C exp(-nu NDVI) exp(-tan gamma) F(gamma, m) / (4 (mu_i + mu_o))``,
    gamma the facet incidence angle, F the Fresnel reflection Mueller
    matrix; ``params['ndvi']`` carries the product nu NDVI."""
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)

    cos_gamma, _ = _facet_geometry(wi, wo)
    tan_gamma = sqrt_rn(torch.clamp(1.0 - cos_gamma * cos_gamma, min=0.0)) / cos_gamma

    m_re = params["refr_re"] / params["ext_ior"]
    m_im = params["refr_im"] / params["ext_ior"]
    A = (
        params["C"]
        * torch.exp(-params["ndvi"])
        * torch.exp(-tan_gamma)
        / torch.clamp(4.0 * (mu_i + mu_o), min=1e-9)
    )
    F = _fresnel_mueller_matrix(cos_gamma, m_re, m_im)
    peak = torch.where(valid, A, 0.0)[..., None, None] * F
    return depolarizer(rpv_eval(params, wi, wo)) + peak


def maignan_eval(params, wi, wo, p=None):
    """Scalar (I-I) Maignan BRDF: RPV base plus the peak's intensity."""
    return maignan_mueller(params, wi, wo, p)[..., 0, 0]


def _smith_lambda(mu, sigma2):
    """Smith shadowing auxiliary Lambda(mu) for an isotropic Gaussian slope
    distribution of mean-square slope ``sigma2``."""
    mu = torch.clamp(mu, 1e-6, 1.0)
    cot = mu / sqrt_rn(torch.clamp(1.0 - mu * mu, min=1e-12))
    v = cot / sqrt_rn(2.0 * torch.clamp(sigma2, min=1e-9))
    return 0.5 * (torch.exp(-v * v) / (v * math.sqrt(math.pi)) - torch.special.erfc(v))


def ocean_mishchenko_mueller(params, wi, wo, p=None):
    """Mishchenko & Travis (1997) polarized sunglint: the Cox-Munk Gaussian
    facet distribution times the Fresnel reflection Mueller matrix times
    bistatic Smith shadowing (opaque surface, glint only)."""
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = torch.clamp(mu_i, min=1e-6)
    mu_o = torch.clamp(mu_o, min=1e-6)

    cos_gamma, cos_beta = _facet_geometry(wi, wo)

    # Cox & Munk (1954) isotropic mean-square slope
    sigma2 = 0.003 + 0.00512 * params["wind_speed"]
    cos2_beta = cos_beta * cos_beta
    tan2_beta = (1.0 - cos2_beta) / cos2_beta
    p_slope = torch.exp(-tan2_beta / sigma2) / (math.pi * sigma2)
    prefactor = p_slope / (4.0 * mu_i * mu_o * (cos2_beta * cos2_beta))

    shadow = 1.0 / (
        1.0 + params["shadowing"] * (_smith_lambda(mu_i, sigma2) + _smith_lambda(mu_o, sigma2))
    )

    m_re = params["eta"] / params["ext_ior"]
    m_im = params["k"] / params["ext_ior"]
    F = _fresnel_mueller_matrix(cos_gamma, m_re, m_im)
    amp = torch.where(valid, prefactor * shadow, 0.0)
    return amp[..., None, None] * F


def ocean_mishchenko_eval(params, wi, wo, p=None):
    """Scalar (I-I) Mishchenko glint BRDF."""
    return ocean_mishchenko_mueller(params, wi, wo, p)[..., 0, 0]


def surface_mueller(kind, params, wi, wo, p=None):
    """Mueller BRDF matrix ``[..., 4, 4]`` in plane-of-incidence frames at
    the surface points ``p`` (None: no position): the polarized kinds' full
    matrices, every other kind an ideal depolarizer scaled by its scalar
    BRDF (exactly the scalar path for unpolarized light). The polarized
    kinds ignore ``p``, as the reference's do."""
    if kind == "maignan":
        return maignan_mueller(params, wi, wo, p)
    if kind == "ocean_mishchenko":
        return ocean_mishchenko_mueller(params, wi, wo, p)
    return depolarizer(bsdf_eval(kind, params, wi, wo, p))
