"""Surface and leaf BSDF evaluation and sampling, batched over lanes.

Port of the ``lambertian``, ``rpv``, ``hapke`` and ``black`` surface kinds
(``rpv`` also the base of ``maignan``), of the scalar (I-I) components
of the polarized ``maignan`` and ``ocean_mishchenko`` surfaces (their
Mueller matrices are :mod:`.bsdf_polarized`'s) and of the two-sided
``bilambertian`` leaf optics of ``eradiate_tpu/ops/bsdf_ops.py``.
``wi`` and ``wo`` [B, 3] point away from the surface (+z up); ``eval``
returns f [1/sr] with dL_o = f cos(theta_i) dE_i; ``sample`` returns
``(w_new, f cos / pdf)``. Parameters are per-spectral-row scalars.

The scalar tracers take the kinds of :data:`SUPPORTED_BSDFS`; the polarized
surfaces are rendered by the polarized tracers only, which also take every
scalar kind as a depolarizer.
"""

from __future__ import annotations

import math

import torch

from ..core.warp import square_to_cosine_hemisphere
from .fastmath import cosine_hemisphere_xla, fma32, sqrt_rn

__all__ = ["lambertian_eval", "hapke_eval", "rpv_eval", "bsdf_eval",
           "bsdf_sample_from_uniforms", "bilambertian_eval",
           "bilambertian_sample_from_uniforms", "SUPPORTED_BSDFS",
           "POLARIZED_SURFACES"]

#: Surface kinds of the scalar tracers.
SUPPORTED_BSDFS = ("black", "hapke", "lambertian", "rpv")

#: Surface kinds with a Mueller matrix of their own (:mod:`.bsdf_polarized`);
#: the polarized tracers take them beside :data:`SUPPORTED_BSDFS`.
POLARIZED_SURFACES = ("maignan", "ocean_mishchenko")


def _mu(w):
    return torch.clamp(w[..., 2], min=0.0)


def _one_minus_sq(mu, exact):
    """``1 - mu * mu``; with ``exact`` (a float32 ``mu`` in float64 path
    state) rounded once, as XLA:CPU fuses it."""
    if exact and mu.dtype == torch.float32:
        return fma32(-mu, mu, 1.0)
    return 1.0 - mu * mu


def _mixed(wi, wo):
    """Whether a float32 sampled direction meets float64 path state."""
    return wi.dtype == torch.float32 and wo.dtype == torch.float64


def lambertian_eval(params, wi, wo):
    rho = params["reflectance"]
    return torch.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / math.pi, 0.0)


def rpv_eval(params, wi, wo):
    """Rahman, Pinty & Verstraete (1993) BRDF, the base of ``maignan``
    (reference ``rpv_eval``); hot spot at wi == wo."""
    rho_0, k, g = params["rho_0"], params["k"], params["g"]
    rho_c = params.get("rho_c", rho_0)

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-7) & (mu_o > 1e-7)
    mu_i = torch.clamp(mu_i, min=1e-7)
    mu_o = torch.clamp(mu_o, min=1e-7)

    # Minnaert-like bowl term
    M = (mu_i * mu_o * (mu_i + mu_o)) ** (k - 1.0)
    # Henyey-Greenstein term; cos(Theta) = wi . wo (+1 at backscattering)
    cos_T = wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1] + wi[..., 2] * wo[..., 2]
    F = (1.0 - g * g) / torch.clamp((1.0 + g * g + 2.0 * g * cos_T) ** 1.5, min=1e-12)
    # hot-spot factor G = sqrt(tan^2 i + tan^2 o - 2 tan i tan o cos dphi)
    exact = _mixed(wi, wo)
    ti = sqrt_rn(torch.clamp(_one_minus_sq(mu_i, exact), min=0.0)) / mu_i
    to = sqrt_rn(torch.clamp(1.0 - mu_o * mu_o, min=0.0)) / mu_o
    sin_i = sqrt_rn(torch.clamp(_one_minus_sq(mu_i, exact), min=1e-30))
    sin_o = sqrt_rn(torch.clamp(1.0 - mu_o * mu_o, min=1e-30))
    cos_dphi = torch.clamp((cos_T - mu_i * mu_o) / (sin_i * sin_o), -1.0, 1.0)
    G = sqrt_rn(torch.clamp(ti * ti + to * to - 2.0 * ti * to * cos_dphi, min=0.0))
    H = 1.0 + (1.0 - rho_c) / (1.0 + G)
    # Rahman's rho is a BRF; BRDF = BRF / pi
    return torch.where(valid, rho_0 * M * F * H / math.pi, 0.0)


# Hapke (2012) IMSA with the shadow-hiding opposition effect and Hapke (1984)
# macroscopic roughness; parameters w, b, c, theta [rad], B_0, h (reference
# kernel plugin ``hapke``).


def _hapke_phase(b, c, cos_g):
    """Double Henyey-Greenstein on the phase angle (cos_g = 1 is exact
    backscattering); ``c`` weights the backscattering lobe."""
    b2 = b * b
    fwd = (1.0 - b2) / torch.clamp(1.0 + 2.0 * b * cos_g + b2, min=1e-12) ** 1.5
    bwd = (1.0 - b2) / torch.clamp(1.0 - 2.0 * b * cos_g + b2, min=1e-12) ** 1.5
    return (1.0 - c) * fwd + c * bwd


def _hapke_H(w, x):
    """Chandrasekhar H-function, Hapke (2002) approximation."""
    gamma = torch.sqrt(torch.clamp(1.0 - w, min=1e-12))
    r0 = (1.0 - gamma) / (1.0 + gamma)
    x = torch.clamp(x, min=1e-6)
    ln_term = torch.log((1.0 + x) / x)
    return 1.0 / (1.0 - w * x * (r0 + 0.5 * (1.0 - 2.0 * r0 * x) * ln_term))


def _hapke_roughness(theta, mu_i, mu_o, cos_phi, sin_phi, sin_i):
    """Hapke (1984) macroscopic roughness: effective cosines and the
    shadowing factor ``(mu0_e, mu_e, S)``."""
    theta = torch.clamp(theta, min=1e-4)
    tan_t = torch.tan(theta)
    cot_t = 1.0 / tan_t
    chi = 1.0 / torch.sqrt(1.0 + math.pi * tan_t * tan_t)

    sin_o = torch.sqrt(torch.clamp(1.0 - mu_o * mu_o, min=1e-12))
    tan_i = sin_i / mu_i
    tan_o = sin_o / mu_o
    cot_i = 1.0 / torch.clamp(tan_i, min=1e-6)
    cot_o = 1.0 / torch.clamp(tan_o, min=1e-6)

    def E1(cot_x):
        return torch.exp(-2.0 / math.pi * cot_t * cot_x)

    def E2(cot_x):
        return torch.exp(-1.0 / math.pi * cot_t * cot_t * cot_x * cot_x)

    phi = torch.abs(torch.atan2(sin_phi, cos_phi))
    # tan(phi/2) overflows near phi = pi, where the factor is 0 anyway
    half_phi = torch.clamp(phi / 2.0, max=math.pi / 2.0 - 1e-4)
    f_psi = torch.exp(-2.0 * torch.tan(half_phi))

    def eta(mu_x, sin_x, cot_x):
        return chi * (
            mu_x + sin_x * tan_t * E2(cot_x) / torch.clamp(2.0 - E1(cot_x), min=1e-12)
        )

    eta_i = eta(mu_i, sin_i, cot_i)
    eta_o = eta(mu_o, sin_o, cot_o)

    # i <= e and i > e branches (Hapke 1984 eqs. 46-51), selected branchless
    sin_hp2 = torch.sin(phi / 2.0) ** 2
    cos_phi_ = torch.cos(phi)
    denom_ie = torch.clamp(2.0 - E1(cot_o) - (phi / math.pi) * E1(cot_i), min=1e-12)
    denom_ei = torch.clamp(2.0 - E1(cot_i) - (phi / math.pi) * E1(cot_o), min=1e-12)
    mu0e_1 = chi * (
        mu_i + sin_i * tan_t * (cos_phi_ * E2(cot_o) + sin_hp2 * E2(cot_i)) / denom_ie
    )
    mue_1 = chi * (mu_o + sin_o * tan_t * (E2(cot_o) - sin_hp2 * E2(cot_i)) / denom_ie)
    mu0e_2 = chi * (mu_i + sin_i * tan_t * (E2(cot_i) - sin_hp2 * E2(cot_o)) / denom_ei)
    mue_2 = chi * (
        mu_o + sin_o * tan_t * (cos_phi_ * E2(cot_i) + sin_hp2 * E2(cot_o)) / denom_ei
    )

    i_le_e = tan_i <= tan_o
    mu0e = torch.where(i_le_e, mu0e_1, mu0e_2)
    mue = torch.where(i_le_e, mue_1, mue_2)
    shade = (mue / eta_o) * (mu_i / eta_i) * chi
    S = torch.where(
        i_le_e,
        shade / (1.0 - f_psi + f_psi * chi * (mu_i / eta_i)),
        shade / (1.0 - f_psi + f_psi * chi * (mu_o / eta_o)),
    )
    return mu0e, mue, S


def hapke_eval(params, wi, wo):
    w, b, c = params["w"], params["b"], params["c"]
    theta, B_0, h = params["theta"], params["B_0"], params["h"]

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = torch.clamp(mu_i, min=1e-6)
    mu_o = torch.clamp(mu_o, min=1e-6)

    # phase angle g: cos g = wi . wo (1 at exact backscatter)
    cos_g = torch.clamp(
        wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1] + wi[..., 2] * wo[..., 2],
        -1.0, 1.0,
    )
    half_tan_g = torch.sqrt(torch.clamp((1.0 - cos_g) / (1.0 + cos_g), min=0.0))

    # azimuth difference of the horizontal projections
    exact = _mixed(wi, wo)
    root = sqrt_rn if exact else torch.sqrt
    sin_i = root(torch.clamp(_one_minus_sq(mu_i, exact), min=1e-12))
    sin_o = torch.sqrt(torch.clamp(1.0 - mu_o * mu_o, min=1e-12))
    cos_phi = torch.clamp((cos_g - mu_i * mu_o) / (sin_i * sin_o), -1.0, 1.0)
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))

    P = _hapke_phase(b, c, cos_g)
    B_sh = torch.where(h > 0, B_0 / (1.0 + half_tan_g / torch.clamp(h, min=1e-9)), 0.0)
    mu0e, mue, S = _hapke_roughness(theta, mu_i, mu_o, cos_phi, sin_phi, sin_i)
    H_i = _hapke_H(w, mu0e)
    H_o = _hapke_H(w, mue)

    f = (
        (w / (4.0 * math.pi))
        * (1.0 / torch.clamp(mu0e + mue, min=1e-9))
        * (P * (1.0 + B_sh) + H_i * H_o - 1.0)
        * S
        * (mu0e / mu_i)  # effective-cosine flux correction
    )
    return torch.where(valid, torch.clamp(f, min=0.0), 0.0)


def _maignan_eval(params, wi, wo):
    from .bsdf_polarized import maignan_eval

    return maignan_eval(params, wi, wo)


def _ocean_mishchenko_eval(params, wi, wo):
    from .bsdf_polarized import ocean_mishchenko_eval

    return ocean_mishchenko_eval(params, wi, wo)


# the scalar (I-I) components of the polarized surfaces, as the reference
# registers them (lazy imports break the module cycle)
_EVAL = {
    "lambertian": lambertian_eval,
    "rpv": rpv_eval,
    "hapke": hapke_eval,
    "maignan": _maignan_eval,
    "ocean_mishchenko": _ocean_mishchenko_eval,
}


def _check_kind(kind):
    if kind != "black" and kind not in _EVAL:
        raise NotImplementedError(
            f"surface kind {kind!r} is not ported yet (supported: "
            f"{', '.join(SUPPORTED_BSDFS + POLARIZED_SURFACES)})"
        )


def _strong(params):
    """Per-row scalars as 1-element tensors: torch lets a 0-d float64
    tensor take a float32 operand's dtype (the sampled direction's), where
    JAX promotes the operand to float64; a 1-element tensor promotes as JAX
    does, and broadcasts the same."""
    return {
        k: v.reshape(1) if isinstance(v, torch.Tensor) and v.ndim == 0 else v
        for k, v in params.items()
    }


def bsdf_eval(kind, params, wi, wo):
    """BRDF value f(wi, wo) [1/sr]."""
    _check_kind(kind)
    if kind == "black":
        return torch.zeros_like(wi[..., 0])
    return _EVAL[kind](_strong(params), wi, wo)


def bsdf_sample_from_uniforms(kind, params, wo, u):
    """Cosine-hemisphere continuation from uniforms ``u`` [B, 2]; returns
    ``(w_new, weight)`` with weight = f cos / pdf = f pi. Float32 uniforms in
    float64 path state (``wo``) give a float32 direction rounded as the
    jitted reference's (:func:`.fastmath.cosine_hemisphere_xla`)."""
    _check_kind(kind)
    if wo.dtype == torch.float64 and u.dtype == torch.float32:
        w_new = cosine_hemisphere_xla(u)
    else:
        w_new = square_to_cosine_hemisphere(u)
    if kind == "black":
        return w_new, torch.zeros_like(wo[..., 0])
    return w_new, bsdf_eval(kind, params, w_new, wo) * math.pi


def bilambertian_eval(params, wi, wo):
    """Two-sided diffuse leaf: reflectance when ``wi`` and ``wo`` are on the
    same side of the surface, transmittance when on opposite sides."""
    same_side = (wi[..., 2] * wo[..., 2]) > 0
    return torch.where(same_side, params["reflectance"], params["transmittance"]) / math.pi


def bilambertian_sample_from_uniforms(params, wo, u_side, u):
    """Sample the two-sided diffuse BSDF in the local leaf frame (+z = the
    side ``wo`` leaves from) from uniforms ``u_side`` [B] and ``u`` [B, 2]:
    reflect with probability rho / (rho + tau) (cosine-weighted, +z),
    transmit otherwise (cosine-weighted, -z). Returns ``(w_new, weight)``
    with weight = rho + tau. Float32 uniforms in float64 path state (``wo``)
    give a float32 direction rounded as the jitted reference's
    (:func:`.fastmath.cosine_hemisphere_xla`)."""
    rho = params["reflectance"]
    total = rho + params["transmittance"]
    reflect = u_side < rho / torch.clamp(total, min=1e-12)
    if wo.dtype == torch.float64 and u.dtype == torch.float32:
        w_new = cosine_hemisphere_xla(u)
    else:
        w_new = square_to_cosine_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=w_new.dtype, device=w_new.device)
    w_new = torch.where(reflect[..., None], w_new, w_new * flip)
    weight = torch.where(total > 0, total, 0.0).expand(w_new.shape[:-1])
    return w_new, weight
