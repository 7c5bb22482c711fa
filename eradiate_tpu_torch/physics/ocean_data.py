# Host-code copy of eradiate_tpu/physics/ocean_data.py; regenerate with tools/copy_host_code.py, do not edit.
"""Ocean optical-constant tables (6SV heritage).

Replaces the round-1/2 analytic surrogates behind the ``ocean_legacy``
BSDF (reference plugin ``scenes/bsdfs/_ocean_legacy.py:100``, whose
tables live in the absent Mitsuba C++ fork) with transcriptions of the
public sources 6SV itself draws from:

- ``WATER_N`` / ``WATER_K``: real/imaginary refractive index of pure
  water, Hale & Querry (1973), 0.25-2.5 um;
- ``AW_*``: pure-water absorption coefficient [1/m], Pope & Fry (1997)
  380-700 nm, merged with the Hale & Querry-derived k values
  (a = 4 pi k / lambda) beyond 700 nm where Pope & Fry ends;
- ``AC_*``: chlorophyll-specific absorption shape (normalized to 1 at
  440 nm), Prieur & Sathyendranath (1981) as used by Morel's case-1
  model in 6SV.

Transcription fidelity: values carry the published 3-digit precision;
the >=700 nm water-leaving contribution is radiometrically nil (a_w
rises by 2-4 orders of magnitude), so the a_w tail is coarse.  The
previous analytic fits remain available as documented fallbacks
(:func:`water_ior_analytic` etc. in ``ops.bsdf_ops``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "water_ior",
    "water_ior_imag",
    "water_absorption_m1",
    "chlorophyll_absorption_shape",
    "case1_water_reflectance",
]

# Hale & Querry (1973): wavelength [um], n, k for pure water.
_HQ_UM = np.array([
    0.250, 0.275, 0.300, 0.325, 0.350, 0.375, 0.400, 0.425, 0.450, 0.475,
    0.500, 0.525, 0.550, 0.575, 0.600, 0.625, 0.650, 0.675, 0.700, 0.725,
    0.750, 0.775, 0.800, 0.825, 0.850, 0.875, 0.900, 0.925, 0.950, 0.975,
    1.000, 1.100, 1.200, 1.300, 1.400, 1.500, 1.600, 1.700, 1.800, 1.900,
    2.000, 2.100, 2.200, 2.300, 2.400, 2.500,
])
WATER_N = np.array([
    1.362, 1.354, 1.349, 1.346, 1.343, 1.341, 1.339, 1.338, 1.337, 1.336,
    1.335, 1.334, 1.333, 1.333, 1.332, 1.332, 1.331, 1.331, 1.331, 1.330,
    1.330, 1.330, 1.329, 1.329, 1.329, 1.328, 1.328, 1.328, 1.327, 1.327,
    1.327, 1.326, 1.324, 1.323, 1.321, 1.319, 1.317, 1.315, 1.312, 1.309,
    1.306, 1.301, 1.296, 1.289, 1.279, 1.261,
])
WATER_K = np.array([
    3.35e-8, 2.35e-8, 1.60e-8, 1.08e-8, 6.50e-9, 3.50e-9, 1.86e-9,
    1.30e-9, 1.02e-9, 9.35e-10, 1.00e-9, 1.32e-9, 1.96e-9, 3.60e-9,
    1.09e-8, 1.39e-8, 1.64e-8, 2.23e-8, 3.35e-8, 9.15e-8, 1.56e-7,
    1.48e-7, 1.25e-7, 1.82e-7, 2.93e-7, 3.91e-7, 4.86e-7, 1.06e-6,
    2.93e-6, 3.48e-6, 2.89e-6, 9.89e-6, 9.89e-6, 3.55e-5, 1.38e-4,
    8.55e-5, 8.55e-5, 8.10e-5, 1.15e-4, 1.10e-3, 1.10e-3, 2.89e-4,
    2.89e-4, 9.56e-4, 9.56e-4, 1.93e-3,
])

# Pope & Fry (1997): pure-water absorption [1/m], 380-700 nm (5 nm).
_PF_NM = np.arange(380.0, 701.0, 5.0)
_PF_AW = np.array([
    0.01137, 0.00941, 0.00851, 0.00813, 0.00663, 0.00530, 0.00473,
    0.00444, 0.00454, 0.00478, 0.00495, 0.00530, 0.00635, 0.00751,
    0.00922, 0.00962, 0.00979, 0.01011, 0.01060, 0.01140, 0.01270,
    0.01360, 0.01500, 0.01730, 0.02040, 0.02560, 0.03250, 0.03960,
    0.04090, 0.04170, 0.04340, 0.04520, 0.04740, 0.05110, 0.05650,
    0.05960, 0.06190, 0.06420, 0.06950, 0.07720, 0.08960, 0.11000,
    0.13510, 0.16720, 0.22240, 0.25770, 0.26440, 0.26780, 0.27550,
    0.28100, 0.29160, 0.30470, 0.31080, 0.32200, 0.34000, 0.37100,
    0.41000, 0.42900, 0.43900, 0.44800, 0.46500, 0.48600, 0.51600,
    0.55900, 0.62400,
])
assert _PF_AW.size == _PF_NM.size

# Prieur & Sathyendranath (1981) chlorophyll-specific absorption shape,
# normalized to 1 at 440 nm (the A_c(lambda) of Morel's case-1 model).
_AC_NM = np.arange(400.0, 701.0, 10.0)
_AC = np.array([
    0.687, 0.828, 0.913, 0.973, 1.000, 0.944, 0.917, 0.870, 0.798,
    0.750, 0.668, 0.618, 0.528, 0.474, 0.416, 0.357, 0.294, 0.276,
    0.291, 0.282, 0.236, 0.252, 0.276, 0.317, 0.334, 0.356, 0.441,
    0.595, 0.502, 0.329, 0.215,
])
assert _AC.size == _AC_NM.size


def water_ior(w_nm, chlorinity=19.0):
    """Real refractive index of sea water: Hale & Querry pure-water table
    + the Friedman (1969) salinity/chlorinity correction used by 6SV."""
    w_um = np.asarray(w_nm, dtype=np.float64) / 1e3
    n = np.interp(w_um, _HQ_UM, WATER_N)
    return n + 0.00017 * np.asarray(chlorinity, dtype=np.float64)


def water_ior_imag(w_nm):
    """Imaginary refractive index of pure water (Hale & Querry),
    log-interpolated (k spans 7 decades over the table range)."""
    w_um = np.asarray(w_nm, dtype=np.float64) / 1e3
    return np.exp(np.interp(w_um, _HQ_UM, np.log(WATER_K)))


def water_absorption_m1(w_nm):
    """Pure-water absorption coefficient [1/m]: Pope & Fry below 700 nm,
    4 pi k / lambda from the Hale & Querry k table above."""
    w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
    a_pf = np.interp(w, _PF_NM, _PF_AW)
    k = water_ior_imag(w)
    a_hq = 4.0 * np.pi * k / (w * 1e-9)  # 1/m
    return np.where(w <= 700.0, a_pf, a_hq)


def chlorophyll_absorption_shape(w_nm):
    """A_c(lambda), 1 at 440 nm; 0 outside 400-700 nm (phytoplankton
    pigments do not absorb appreciably outside the visible)."""
    w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
    return np.where(
        (w >= 400.0) & (w <= 700.0), np.interp(w, _AC_NM, _AC), 0.0
    )


def case1_water_reflectance(w_nm, pigment_mg_m3):
    """Lambertian-equivalent water-leaving reflectance of a Morel case-1
    ocean (the 6SV underlight model, table-driven):

    - total absorption ``a = a_w + 0.06 A_c(lambda) C^0.65`` [1/m];
    - pure-water scattering ``b_w = 0.00288 (lambda/500)^-4.32``;
    - particle scattering ``b_p = 0.30 C^0.62`` with backscatter ratio
      ``0.002 + 0.02 (0.5 - 0.25 log10 C) (550/lambda)``;
    - subsurface irradiance reflectance ``R(0-) = 0.33 b_b / a``;
    - above-surface Lambertian equivalent ``~0.54 R(0-) / Q``, Q = pi/f
      absorbed into the 0.165 front factor below (upwelling radiance-to-
      irradiance conversion + internal-reflection loss, the standard
      Morel-Gentili factors 6SV applies).
    """
    w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
    C = float(np.maximum(pigment_mg_m3, 1e-3))
    a = water_absorption_m1(w) + 0.06 * chlorophyll_absorption_shape(w) * C**0.65
    b_w = 0.00288 * (w / 500.0) ** (-4.32)
    b_p = 0.30 * C**0.62
    bb_ratio = 0.002 + 0.02 * (0.5 - 0.25 * np.log10(C)) * (550.0 / w)
    b_b = 0.5 * b_w + bb_ratio * b_p
    r0 = 0.33 * b_b / np.maximum(a, 1e-9)
    # water-leaving lambertian equivalent seen above the surface (before
    # the caller's explicit interface transmission factors)
    return 0.165 * b_b / np.maximum(a, 1e-9) / (1.0 - 1.56 * np.minimum(r0, 0.3))
