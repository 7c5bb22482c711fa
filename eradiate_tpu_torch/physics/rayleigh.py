# Host-code copy of eradiate_tpu/physics/rayleigh.py; regenerate with tools/copy_host_code.py, do not edit.
"""Rayleigh scattering by air.

Re-derivation of the reference's Rayleigh module
(``src/eradiate/radprops/rayleigh.py``):

- scattering coefficient after Eberhard (2010), eq. 60:
  sigma_s(lambda, n) = (8 pi^3) / (3 lambda^4 n) * (eta^2 - 1)^2 * F(lambda)
- air refractive index after Peck & Reeder (1972), eq. 2;
- King correction factor F computed *analytically* from the per-species
  factors of Bates (1984) composited per Bodhaine et al. (1999) — the
  reference interpolates a tabulated Bates dataset
  (``rayleigh.py:66-136``); the analytic composition agrees with that table
  to <0.1% over [0.25, 1.7] um and removes the data-file dependency.
- depolarization factors (Bates / Bodhaine), ``rayleigh.py:189-250``.

All functions are pure and operate on plain arrays in fixed kernel units:
wavelength [nm], number density [km^-3], sigma_s [km^-1]. They accept numpy
or JAX arrays (jit/vmap-compatible).
"""

from __future__ import annotations

import numpy as np

from ..core.frame import _np

__all__ = [
    "LOSCHMIDT_KM3",
    "STANDARD_AIR_NUMBER_DENSITY_KM3",
    "air_refractive_index",
    "king_factor",
    "compute_sigma_s_air",
    "depolarization_bates",
    "depolarization_bodhaine",
    "depol_to_king",
]

#: Loschmidt constant at 273.15 K, 101.325 kPa [km^-3]
#: (CODATA: 2.6867811e25 m^-3)
LOSCHMIDT_KM3 = 2.686780111e25 * 1e9

#: Air number density at 101325 Pa and 288.15 K [km^-3]
#: (mirror of ``rayleigh.py:19``)
STANDARD_AIR_NUMBER_DENSITY_KM3 = LOSCHMIDT_KM3 * (273.15 / 288.15)


def air_refractive_index(w_nm, number_density_km3=STANDARD_AIR_NUMBER_DENSITY_KM3):
    """Air refractive index, Peck & Reeder (1972) eq. 2, density-scaled.

    Mirror of ``rayleigh.py:139-187``. ``w_nm`` wavelength [nm].
    """
    xp = _np(w_nm)
    w_um = xp.asarray(w_nm) * 1e-3
    sigma2 = 1.0 / (w_um * w_um)  # [um^-2]
    # refractivity in parts per 1e8
    x = 5791817.0 / (238.0183 - sigma2) + 167909.0 / (57.362 - sigma2)
    x_scaled = x * (number_density_km3 / STANDARD_AIR_NUMBER_DENSITY_KM3)
    return 1.0 + x_scaled * 1e-8


def king_factor(w_nm, x_CO2=0.0004):
    """Air King correction factor F(lambda).

    Analytic composition of the Bates (1984) per-species King factors,
    weighting per Bodhaine et al. (1999) (the same formulas the reference
    uses in ``depolarization_bodhaine``, ``rayleigh.py:219-250``):

    F_N2 = 1.034 + 3.17e-4 / w^2
    F_O2 = 1.096 + 1.385e-3 / w^2 + 1.448e-4 / w^4      (w in um)
    F_air = (78.084 F_N2 + 20.946 F_O2 + 0.934 * 1.0 + C_CO2 * 1.15) / total
    """
    xp = _np(w_nm)
    w_um = xp.asarray(w_nm) * 1e-3
    inv2 = 1.0 / (w_um * w_um)
    C_CO2 = x_CO2 * 100.0  # percent by volume
    total = 78.084 + 20.946 + 0.934 + C_CO2
    F_N2 = 1.034 + 3.17e-4 * inv2
    F_O2 = 1.096 + 1.385e-3 * inv2 + 1.448e-4 * inv2 * inv2
    return (78.084 * F_N2 + 20.946 * F_O2 + 0.934 * 1.00 + C_CO2 * 1.15) / total


def compute_sigma_s_air(
    w_nm=550.0,
    number_density_km3=STANDARD_AIR_NUMBER_DENSITY_KM3,
    x_CO2=0.0004,
):
    """Rayleigh scattering coefficient of air [km^-1].

    Mirror of ``compute_sigma_s_air`` (``rayleigh.py:66-136``), Eberhard
    (2010) eq. 60. Broadcasts ``w_nm`` against ``number_density_km3``.
    """
    xp = _np(w_nm) if not np.isscalar(w_nm) else _np(number_density_km3)
    w_km = xp.asarray(w_nm) * 1e-12  # nm -> km so sigma comes out in km^-1
    F = king_factor(w_nm, x_CO2=x_CO2)
    eta = air_refractive_index(w_nm, number_density_km3)
    n = xp.asarray(number_density_km3)
    return (
        8.0
        * np.pi**3
        / (3.0 * w_km**4)
        / n
        * (eta * eta - 1.0) ** 2
        * F
    )


def depolarization_bates(w_nm):
    """Depolarization factor from the (analytic) Bates King factor.

    Mirror of ``rayleigh.py:189-216``: rho = 6 (F - 1) / (7 F + 3).
    """
    F = king_factor(w_nm)
    return 6.0 * (F - 1.0) / (7.0 * F + 3.0)


def depolarization_bodhaine(w_nm, x_CO2=0.0004):
    """Depolarization factor, Bodhaine et al. (1999) composition.

    Mirror of ``rayleigh.py:219-250``.
    """
    F = king_factor(w_nm, x_CO2=x_CO2)
    return 6.0 * (F - 1.0) / (7.0 * F + 3.0)


def depol_to_king(rho):
    """King factor from depolarization: F = (6 + 3 rho) / (6 - 7 rho)."""
    return (6.0 + 3.0 * rho) / (6.0 - 7.0 * rho)
