"""Surface and leaf BSDF evaluation and sampling, batched over lanes.

Port of every surface kind of ``eradiate_tpu/ops/bsdf_ops.py``:
``lambertian``, ``rpv``, ``hapke``, ``rtls``, ``bilambertian``, ``black``,
the oceans (``ocean_legacy``, ``ocean_grasp``), the measured ``mqdiffuse``,
the textures (``bitmap``, ``checkerboard``), the scalar (I-I) components of
the polarized ``maignan`` and ``ocean_mishchenko`` surfaces (their Mueller
matrices are :mod:`.bsdf_polarized`'s), the composites
``central_patch:<bg>:<patch>``, ``opacity_mask:<nested>`` and
``select:<k0>:<k1>:...`` (their children's rows prefixed ``bg_``,
``patch_``, ``nested_`` and ``c{i}_``), and the two-sided ``bilambertian``
leaf optics.
``wi`` and ``wo`` [B, 3] point away from the surface (+z up); ``eval``
returns f [1/sr] with dL_o = f cos(theta_i) dE_i; ``sample`` returns
``(w_new, f cos / pdf)``. Parameters are per-spectral-row scalars, or a
row's table (``bitmap``'s map [H, W], ``mqdiffuse``'s grid [Nto, Npd,
Nti]). ``p`` [B, 2] is the surface point in the scene's horizontal
coordinates, or None (the spherical tracers): then ``bitmap`` takes its
map's mean, ``checkerboard`` its ``reflectance_a``, ``central_patch`` its
background, ``opacity_mask`` its nested BSDF and ``select`` its child 0.

Every tracer takes the kinds of :data:`SUPPORTED_BSDFS` and the composites
of them; the polarized tracers give the kinds of :data:`POLARIZED_SURFACES`
their own Mueller matrices and depolarize the others.
"""

from __future__ import annotations

import functools
import math

import torch

from ..core.warp import square_to_cosine_hemisphere
from .fastmath import cosine_hemisphere_xla, fma32, sqrt_rn

__all__ = ["lambertian_eval", "hapke_eval", "rpv_eval", "rtls_eval",
           "checkerboard_eval", "ocean_legacy_eval", "ocean_grasp_eval",
           "mqdiffuse_eval", "bitmap_eval", "bsdf_eval", "check_kind", "uses_position",
           "bsdf_sample_from_uniforms", "bilambertian_eval",
           "bilambertian_sample_from_uniforms", "SUPPORTED_BSDFS",
           "POLARIZED_SURFACES"]

#: Surface kinds with a Mueller matrix of their own (:mod:`.bsdf_polarized`);
#: the polarized tracers depolarize every other kind.
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


def lambertian_eval(params, wi, wo, p=None):
    rho = params["reflectance"]
    return torch.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / math.pi, 0.0)


def rpv_eval(params, wi, wo, p=None):
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


def hapke_eval(params, wi, wo, p=None):
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


def black_eval(params, wi, wo, p=None):
    """Perfect absorber: zeros of the directions' batch shape, in their
    promoted dtype (the reference's ``jnp.zeros`` is float64 under x64)."""
    shape = torch.broadcast_shapes(wi.shape[:-1], wo.shape[:-1])
    return torch.zeros(shape, dtype=torch.promote_types(wi.dtype, wo.dtype), device=wi.device)


def checkerboard_eval(params, wi, wo, p=None):
    """Two-reflectance Lambertian checkerboard over the surface extent,
    Mitsuba's parity (reference ``checkerboard_eval``)."""
    rho_a, rho_b = params["reflectance_a"], params["reflectance_b"]
    if p is None:
        rho = rho_a
    else:
        scale = params.get("scale_pattern", 2.0)
        extent = params.get("extent", 1.0)
        u = (p[..., 0] / extent + 0.5) * scale
        v = (p[..., 1] / extent + 0.5) * scale
        # jnp's % is a floor-mod, as torch.remainder is (fmod is not)
        parity = torch.remainder(torch.floor(u) + torch.floor(v), 2.0)
        rho = torch.where(parity < 1.0, rho_a, rho_b)
    return torch.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / math.pi, 0.0)


# Ross-Thick Li-Sparse-Reciprocal kernel BRDF (reference ``rtls``), the
# MODIS BRDF/albedo kernels (Lucht, Schaaf & Strahler 2000), h/b = 2, b/r = 1.


def _rtls_kernels(mu_i, mu_o, cos_phi, exact=False):
    """``(k_vol, k_geo)``; with ``exact`` a float32 ``mu_i`` (the sampled
    direction's) rounds ``1 - mu_i^2`` once, as XLA:CPU fuses it."""
    sin_i = sqrt_rn(torch.clamp(_one_minus_sq(mu_i, exact), min=0.0))
    sin_o = sqrt_rn(torch.clamp(1.0 - mu_o * mu_o, min=0.0))
    cos_xi = torch.clamp(mu_i * mu_o + sin_i * sin_o * cos_phi, -1.0, 1.0)
    xi = torch.arccos(cos_xi)

    # RossThick volumetric kernel
    k_vol = (
        ((math.pi / 2.0 - xi) * cos_xi + torch.sin(xi)) / torch.clamp(mu_i + mu_o, min=1e-9)
        - math.pi / 4.0
    )

    # LiSparse-Reciprocal geometric kernel (b/r = 1: primed angles equal)
    tan_i = sin_i / torch.clamp(mu_i, min=1e-9)
    tan_o = sin_o / torch.clamp(mu_o, min=1e-9)
    sec_i = 1.0 / torch.clamp(mu_i, min=1e-9)
    sec_o = 1.0 / torch.clamp(mu_o, min=1e-9)
    sin_phi = sqrt_rn(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    D2 = tan_i * tan_i + tan_o * tan_o - 2.0 * tan_i * tan_o * cos_phi
    cross = tan_i * tan_o * sin_phi
    cos_t = torch.clamp(
        2.0 * sqrt_rn(torch.clamp(D2 + cross * cross, min=0.0))  # h/b = 2
        / torch.clamp(sec_i + sec_o, min=1e-9),
        -1.0, 1.0,
    )
    t = torch.arccos(cos_t)
    O = (1.0 / math.pi) * (t - torch.sin(t) * cos_t) * (sec_i + sec_o)
    k_geo = O - sec_i - sec_o + 0.5 * (1.0 + cos_xi) * sec_i * sec_o
    return k_vol, k_geo


def rtls_eval(params, wi, wo, p=None):
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = torch.clamp(mu_i, min=1e-6)
    mu_o = torch.clamp(mu_o, min=1e-6)
    cos_g = torch.clamp(
        wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1] + wi[..., 2] * wo[..., 2],
        -1.0, 1.0,
    )
    exact = _mixed(wi, wo)
    sin_i = sqrt_rn(torch.clamp(_one_minus_sq(mu_i, exact), min=1e-12))
    sin_o = sqrt_rn(torch.clamp(1.0 - mu_o * mu_o, min=1e-12))
    cos_phi = torch.clamp((cos_g - mu_i * mu_o) / (sin_i * sin_o), -1.0, 1.0)
    k_vol, k_geo = _rtls_kernels(mu_i, mu_o, cos_phi, exact)
    brf = params["f_iso"] + params["f_vol"] * k_vol + params["f_geo"] * k_geo
    return torch.where(valid, torch.clamp(brf, min=0.0) / math.pi, 0.0)


# Oceans (reference ``ocean_legacy``, 6SV-style, and ``ocean_grasp``): Cox-Munk
# sun glint, whitecaps and water-leaving underlight. The analytic fallbacks
# serve rows built without the tables' ``n_water`` and ``r_water``.


def _fresnel_unpolarized(cos_i, n, exact=False):
    """Unpolarized Fresnel reflectance at an air/water interface; with
    ``exact`` a float32 ``cos_i`` rounds ``1 - cos_i^2`` once."""
    cos_i = torch.clamp(cos_i, 1e-6, 1.0)
    sin_t2 = torch.clamp(_one_minus_sq(cos_i, exact) / (n * n), 0.0, 1.0)
    cos_t = sqrt_rn(1.0 - sin_t2)
    rs = (cos_i - n * cos_t) / (cos_i + n * cos_t)
    rp = (n * cos_i - cos_t) / (n * cos_i + cos_t)
    return 0.5 * (rs * rs + rp * rp)


def _water_ior(w_nm, chlorinity):
    """Analytic fallback water refractive index (flat-dispersion fit and
    Friedman 1969's salinity term); rows carry the Hale & Querry table's
    value as ``n_water``."""
    n = 1.325 + 6.0 / (w_nm * 1e-2)
    return n + 0.00017 * chlorinity


def _whitecap_fraction(wind_speed):
    """Whitecap coverage, Monahan & O'Muircheartaigh (1980): 2.95e-6 W^3.52."""
    return torch.clamp(2.95e-6 * torch.clamp(wind_speed, min=0.0) ** 3.52, 0.0, 1.0)


def _water_leaving_reflectance(w_nm, pigmentation):
    """Analytic fallback water-leaving reflectance; rows carry the Morel
    case-1 table's value as ``r_water``."""
    chl = torch.clamp(pigmentation, min=1e-3)
    blue = 0.03 * torch.exp(-0.5 * ((w_nm - 440.0) / 60.0) ** 2) * chl ** (-0.3)
    green = 0.015 * torch.exp(-0.5 * ((w_nm - 560.0) / 50.0) ** 2) * chl**0.1
    red_cut = 1.0 / (1.0 + torch.exp((w_nm - 700.0) / 25.0))
    return (blue + green) * red_cut


def _glint(wi, wo, mu_i, mu_o, wind_speed, n_w):
    """Cox & Munk (1954) isotropic glint on the specular facet (the half
    vector of ``wi`` and ``wo``) with its Fresnel reflectance."""
    h = wi + wo
    hn = sqrt_rn(h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1] + h[..., 2] * h[..., 2])
    h = h / torch.clamp(hn, min=1e-12)[..., None]
    cos_beta = torch.clamp(h[..., 2], 1e-6, 1.0)  # facet tilt
    cos_theta_h = torch.clamp(
        wi[..., 0] * h[..., 0] + wi[..., 1] * h[..., 1] + wi[..., 2] * h[..., 2], 1e-6, 1.0
    )
    sigma2 = 0.003 + 0.00512 * wind_speed
    cos2_beta = cos_beta * cos_beta  # jnp's integer powers square, then square again
    tan2_beta = (1.0 - cos2_beta) / cos2_beta
    p_slope = torch.exp(-tan2_beta / sigma2) / (math.pi * sigma2)
    R_F = _fresnel_unpolarized(cos_theta_h, n_w)
    return p_slope * R_F / (4.0 * mu_i * mu_o * (cos2_beta * cos2_beta))


def _ocean(params, wi, wo, n_w, f_wc, R_w):
    """Whitecaps (Lambertian ``f_wc``) over the glint and the underlight
    ``R_w`` transmitted through the interface both ways."""
    wind_speed = params["wind_speed"]
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = torch.clamp(mu_i, min=1e-6)
    mu_o = torch.clamp(mu_o, min=1e-6)
    f_glint = _glint(wi, wo, mu_i, mu_o, wind_speed, n_w)
    F_wc = _whitecap_fraction(wind_speed)
    t_up = 1.0 - _fresnel_unpolarized(mu_o, n_w)
    t_down = 1.0 - _fresnel_unpolarized(mu_i, n_w, _mixed(wi, wo))
    f_water = R_w * t_up * t_down / math.pi
    f = F_wc * f_wc + (1.0 - F_wc) * (f_glint + f_water)
    return torch.where(valid, f, 0.0)


def ocean_legacy_eval(params, wi, wo, p=None):
    """6SV-style ocean: glint, whitecaps of albedo 0.22 dropping in the NIR
    (Koepke 1984) and Lambertian underlight."""
    w_nm = params["wavelength"]
    n_w = params["n_water"] if "n_water" in params else _water_ior(w_nm, params["chlorinity"])
    R_w = (params["r_water"] if "r_water" in params
           else _water_leaving_reflectance(w_nm, params["pigmentation"]))
    a_wc = 0.22 * torch.clamp(1.0 - (w_nm - 900.0) / 2200.0, 0.2, 1.0)
    return _ocean(params, wi, wo, n_w, a_wc / math.pi, R_w)


def ocean_grasp_eval(params, wi, wo, p=None):
    """GRASP-convention ocean: the same glint with the water IOR ``eta``, a
    Lambertian water body ``water_body_reflectance`` and whitecaps of
    albedo 0.22."""
    return _ocean(params, wi, wo, params["eta"], 0.22 / math.pi,
                  params["water_body_reflectance"])


def mqdiffuse_eval(params, wi, wo, p=None):
    """Measured quasi-diffuse BRDF: gridded ``data`` [Nto, Npd, Nti] over
    (theta_o, phi_d, theta_i), trilinear."""
    data = params["data"]
    cos_i = _mu(wi)
    cos_o = _mu(wo)
    valid = (cos_i > 1e-6) & (cos_o > 1e-6)
    theta_i = torch.arccos(torch.clamp(cos_i, 0.0, 1.0))
    theta_o = torch.arccos(torch.clamp(cos_o, 0.0, 1.0))
    phi_d = torch.remainder(
        torch.abs(torch.atan2(wo[..., 1], wo[..., 0]) - torch.atan2(wi[..., 1], wi[..., 0])),
        2.0 * math.pi,
    )
    phi_d = torch.where(phi_d > math.pi, 2.0 * math.pi - phi_d, phi_d)

    def idx(x, xmax, npts):
        u = torch.clamp(x / xmax, 0.0, 1.0) * (npts - 1)
        i0 = torch.clamp(torch.floor(u).long(), 0, npts - 2)
        return i0, u - i0.to(u.dtype)

    io, fo = idx(theta_o, math.pi / 2, data.shape[0])
    ip, fp = idx(phi_d, math.pi, data.shape[1])
    ii, fi = idx(theta_i, math.pi / 2, data.shape[2])
    val = 0.0
    for da, wa in ((0, 1 - fo), (1, fo)):
        for db, wb in ((0, 1 - fp), (1, fp)):
            for dc, wc in ((0, 1 - fi), (1, fi)):
                val = val + wa * wb * wc * data[io + da, ip + db, ii + dc]
    return torch.where(valid, val, 0.0)


# Textures: the map spans [-extent/2, extent/2]^2 of the surface and repeats.


def _bilinear_wrap(data, u, v):
    """Bilinear lookup of ``data`` [H, W] at uv with repeat wrapping
    (Mitsuba's bitmap defaults)."""
    h, w = data.shape
    u = torch.remainder(u, 1.0) * w - 0.5
    v = torch.remainder(v, 1.0) * h - 0.5
    i0 = torch.floor(u).long()
    j0 = torch.floor(v).long()
    fu = u - i0.to(u.dtype)
    fv = v - j0.to(v.dtype)
    i0w, i1w = torch.remainder(i0, w), torch.remainder(i0 + 1, w)
    j0w, j1w = torch.remainder(j0, h), torch.remainder(j0 + 1, h)
    return (
        data[j0w, i0w] * (1 - fu) * (1 - fv)
        + data[j0w, i1w] * fu * (1 - fv)
        + data[j1w, i0w] * (1 - fu) * fv
        + data[j1w, i1w] * fu * fv
    )


def _uv_from_p(p, extent):
    """Surface point to texture uv."""
    return p[..., 0] / extent + 0.5, p[..., 1] / extent + 0.5


def bitmap_eval(params, wi, wo, p=None):
    """Lambertian reflectance from the row's map ``data`` [H, W]."""
    data = params["data"]
    if p is None:
        rho = data.mean().reshape(1)
    else:
        rho = _bilinear_wrap(data, *_uv_from_p(p, params["extent"]))
    return torch.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / math.pi, 0.0)


def _maignan_eval(params, wi, wo, p=None):
    from .bsdf_polarized import maignan_eval

    return maignan_eval(params, wi, wo, p)


def _ocean_mishchenko_eval(params, wi, wo, p=None):
    from .bsdf_polarized import ocean_mishchenko_eval

    return ocean_mishchenko_eval(params, wi, wo, p)


# Composites: the structure is in the ':'-separated kind string, each
# child's rows carry its prefix.


def _sub(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _composite_eval(kind, params, wi, wo, p=None):
    head, *children = kind.split(":")
    if head == "central_patch":
        f_bg = _eval(children[0], _sub(params, "bg_"), wi, wo, p)
        if p is None:
            return f_bg
        f_patch = _eval(children[1], _sub(params, "patch_"), wi, wo, p)
        edge = params["patch_edges"]  # half-extent
        inside = (torch.abs(p[..., 0]) <= edge) & (torch.abs(p[..., 1]) <= edge)
        return torch.where(inside, f_patch, f_bg)
    if head == "opacity_mask":
        f = _eval(children[0], _sub(params, "nested_"), wi, wo, p)
        if p is None:
            return f
        opacity = _bilinear_wrap(params["opacity_map"], *_uv_from_p(p, params["mask_extent"]))
        # opacity < 1 passes light through the plane: lost below an opaque ground
        return f * torch.clamp(opacity, 0.0, 1.0)
    # select
    fs = [_eval(k, _sub(params, f"c{i}_"), wi, wo, p) for i, k in enumerate(children)]
    if p is None:
        return fs[0]
    data = params["index_map"]  # [H, W] float-stored integer indices
    h, w = data.shape
    u, v = _uv_from_p(p, params["select_extent"])
    i = (torch.clamp(u, 0.0, 1.0 - 1e-7) * w).long()
    j = (torch.clamp(v, 0.0, 1.0 - 1e-7) * h).long()
    pick = torch.clamp(torch.round(data[j, i]).long(), 0, len(children) - 1)
    dtype = functools.reduce(torch.promote_types, [f.dtype for f in fs])
    stacked = torch.stack(torch.broadcast_tensors(*[f.to(dtype) for f in fs]), dim=0)
    return torch.gather(stacked, 0, pick.expand(stacked.shape[1:])[None])[0]


#: composite head -> number of children (None: one or more)
_COMPOSITES = {"central_patch": 2, "opacity_mask": 1, "select": None}


def check_kind(kind):
    """Raise ``ValueError`` naming ``kind`` unless it is a kind of
    :data:`SUPPORTED_BSDFS` or a composite of them, as the reference's
    dispatch does (it raises on the first evaluation)."""
    if ":" not in kind:
        if kind not in _EVAL:
            raise ValueError(f"unsupported BSDF kind '{kind}'")
        return
    head, *children = kind.split(":")
    arity = _COMPOSITES.get(head, 0)
    if arity == 0 or (arity is not None and len(children) != arity):
        raise ValueError(f"unsupported composite BSDF kind '{kind}'")
    for child in children:
        if ":" in child or child not in _EVAL:
            raise ValueError(f"unsupported BSDF kind '{child}' in '{kind}'")


def uses_position(kind):
    """Whether ``kind``'s value depends on the surface point: the textures
    and the composites."""
    return ":" in kind or kind in ("bitmap", "checkerboard")


def _strong(params):
    """Per-row scalars as 1-element tensors: torch lets a 0-d float64
    tensor take a float32 operand's dtype (the sampled direction's), where
    JAX promotes the operand to float64; a 1-element tensor promotes as JAX
    does, and broadcasts the same."""
    return {
        k: v.reshape(1) if isinstance(v, torch.Tensor) and v.ndim == 0 else v
        for k, v in params.items()
    }


def _eval(kind, params, wi, wo, p):
    if ":" in kind:
        return _composite_eval(kind, params, wi, wo, p)
    return _EVAL[kind](params, wi, wo, p)


def bsdf_eval(kind, params, wi, wo, p=None):
    """BRDF value f(wi, wo) [1/sr] at the surface points ``p`` [B, 2]
    (None: no position, see the module's docstring)."""
    check_kind(kind)
    return _eval(kind, _strong(params), wi, wo, p)


def bsdf_sample_from_uniforms(kind, params, wo, u, p=None):
    """Cosine-hemisphere continuation from uniforms ``u`` [B, 2] for every
    kind, as the reference samples them; returns ``(w_new, weight)`` with
    weight = f cos / pdf = f pi. Float32 uniforms in float64 path state
    (``wo``) give a float32 direction rounded as the jitted reference's
    (:func:`.fastmath.cosine_hemisphere_xla`)."""
    check_kind(kind)
    if wo.dtype == torch.float64 and u.dtype == torch.float32:
        w_new = cosine_hemisphere_xla(u)
    else:
        w_new = square_to_cosine_hemisphere(u)
    if kind == "black":
        return w_new, torch.zeros_like(wo[..., 0])
    return w_new, bsdf_eval(kind, params, w_new, wo, p) * math.pi


def bilambertian_eval(params, wi, wo, p=None):
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
    (:func:`.fastmath.cosine_hemisphere_xla`).

    The side is chosen from the detached probability and the weight carries
    the reference's likelihood ratio of the chosen side (``p / p.detach()``
    or ``(1 - p) / (1 - p.detach())``, 1 where that probability is 0 or 1),
    so that a forward-mode tangent on rho or tau keeps the choice's boundary
    term; its primal is exactly 1 (x / x in IEEE), so the weight is rho +
    tau bit for bit."""
    rho = params["reflectance"]
    total = rho + params["transmittance"]
    p_ref = rho / torch.clamp(total, min=1e-12)
    p_det = p_ref.detach()
    reflect = u_side < p_det
    ratio = torch.where(
        reflect,
        torch.where(p_det > 0, p_ref / torch.clamp(p_det, min=1e-30), 1.0),
        torch.where(p_det < 1.0, (1.0 - p_ref) / torch.clamp(1.0 - p_det, min=1e-30), 1.0),
    )
    if wo.dtype == torch.float64 and u.dtype == torch.float32:
        w_new = cosine_hemisphere_xla(u)
    else:
        w_new = square_to_cosine_hemisphere(u)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=w_new.dtype, device=w_new.device)
    w_new = torch.where(reflect[..., None], w_new, w_new * flip)
    weight = torch.where(total > 0, total * ratio, 0.0).expand(w_new.shape[:-1])
    return w_new, weight


_EVAL = {
    "lambertian": lambertian_eval,
    "bitmap": bitmap_eval,
    "rpv": rpv_eval,
    "black": black_eval,
    "checkerboard": checkerboard_eval,
    "hapke": hapke_eval,
    "rtls": rtls_eval,
    "bilambertian": bilambertian_eval,
    "ocean_legacy": ocean_legacy_eval,
    "ocean_grasp": ocean_grasp_eval,
    "mqdiffuse": mqdiffuse_eval,
    # the scalar (I-I) components of the polarized surfaces (lazy imports
    # break the module cycle)
    "maignan": _maignan_eval,
    "ocean_mishchenko": _ocean_mishchenko_eval,
}

#: Surface kinds of every tracer (the reference's ``SUPPORTED_BSDFS``).
SUPPORTED_BSDFS = tuple(sorted(_EVAL))
