# Host-code copy of eradiate_tpu/physics/afgl1986_data.py; regenerate with tools/copy_host_code.py, do not edit.
"""AFGL 1986 atmospheric-model tabulations.

Temperature profiles of the six AFGL 1986 model atmospheres (Anderson et
al., *AFGL Atmospheric Constituent Profiles (0-120 km)*, AFGL-TR-86-0110,
1986 — the tables behind ``joseki.make("afgl_1986-*")`` in the reference,
``src/eradiate/scenes/atmosphere/_molecular.py:80-84``) on the standard
50-level AFGL altitude grid, plus surface pressures and trace-gas column
parameters.

Provenance & fidelity: the temperature tables are transcribed from the
published AFGL-TR-86-0110 model atmospheres as reproduced across public
radiative-transfer packages. Pressures are NOT transcribed — they are
reconstructed by hydrostatic integration from the tabulated T(z) and the
surface pressure (the published tables are hydrostatically consistent, so
the reconstruction agrees with them to <~0.5%; it also guarantees the
profile is exactly hydrostatic for the solver).

Gas mole-fraction profiles (ppmv), confidence tiers:

- ``AFGL_H2O_PPMV`` — per variant; the tropospheric values (0–13 km,
  which carry >99% of the water column) are transcribed per variant from
  the published tables; stratosphere/mesosphere values follow the AFGL
  mid-atmosphere curve (4–6 ppmv band, shared above 30 km where the
  published variants converge). The profile is then scaled by a
  near-unity factor so the precipitable-water column matches the
  published per-variant value exactly (``AFGL_GAS['pwv_cm']``).
- ``AFGL_O3_PPMV`` — per variant, full-profile transcription of the
  published shapes (surface value, tropospheric gradient, stratospheric
  peak altitude/amplitude, mesospheric tail with the secondary maximum),
  scaled to match the published Dobson column exactly
  (``AFGL_GAS['o3_du']``).
- ``AFGL_MINOR_PPMV`` (CO2, N2O, CO, CH4, O2, N2) — single shared
  profiles (the AFGL per-variant differences for these gases are
  confined to the stratospheric fall-off and are small relative to the
  H2O/O3 variability); values above ~85 km are smoothed where the
  transcription source was uncertain — radiometrically negligible
  (<1e-5 of the column).
- ``AFGL_UV_TRACE_PPMV`` (NO, NO2, HNO3, SO2) and
  ``AFGL_SINGLE_TRACE_PPMV`` (the 16 further species completing
  joseki's 28-molecule set) — approximated-shape tiers; see each
  table's own provenance note.

Users needing byte-exact published tables load them with
:func:`eradiate_tpu.data.netcdf.load_thermoprops_netcdf` or
:meth:`ThermoProfile.from_arrays`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "AFGL_Z_KM",
    "AFGL_TEMPERATURE",
    "AFGL_SURFACE",
    "AFGL_GAS",
    "AFGL_H2O_PPMV",
    "AFGL_O3_PPMV",
    "AFGL_MINOR_PPMV",
    "AFGL_UV_TRACE_PPMV",
    "AFGL_SINGLE_TRACE_PPMV",
]

#: Standard AFGL altitude grid [km]: 0..25 by 1, 27.5..50 by 2.5, 55..120 by 5
AFGL_Z_KM = np.concatenate(
    [
        np.arange(0.0, 26.0, 1.0),
        np.arange(27.5, 51.0, 2.5),
        np.arange(55.0, 121.0, 5.0),
    ]
)
assert AFGL_Z_KM.size == 50

#: Temperature [K] at AFGL_Z_KM per variant.
AFGL_TEMPERATURE = {
    # model 1
    "tropical": np.array([
        299.7, 293.7, 287.7, 283.7, 277.0, 270.3, 263.6, 257.0, 250.3,
        243.6, 237.0, 230.1, 223.6, 217.0, 210.3, 203.7, 197.0, 194.8,
        198.8, 202.7, 206.7, 210.7, 214.6, 217.0, 219.2, 221.4,
        227.0, 232.3, 237.7, 243.1, 248.5, 254.0, 259.4, 264.8, 269.6,
        270.2,
        263.4, 253.1, 236.0, 218.9, 201.8, 184.8, 177.1, 177.0, 184.3,
        190.7, 212.0, 241.6, 299.7, 380.0,
    ]),
    # model 2
    "midlatitude_summer": np.array([
        294.2, 289.7, 285.2, 279.2, 273.2, 267.2, 261.2, 254.7, 248.2,
        241.7, 235.3, 228.8, 222.3, 215.8, 215.7, 215.7, 215.7, 215.7,
        216.8, 217.9, 219.2, 220.4, 221.6, 222.8, 223.9, 225.1,
        228.5, 233.7, 239.0, 245.2, 251.3, 257.5, 263.7, 269.9, 275.2,
        275.7,
        269.3, 257.1, 240.1, 218.1, 196.1, 174.1, 165.1, 165.0, 178.3,
        190.5, 222.2, 262.4, 316.8, 380.0,
    ]),
    # model 3
    "midlatitude_winter": np.array([
        272.2, 268.7, 265.2, 261.7, 255.7, 249.7, 243.7, 237.7, 231.7,
        225.7, 219.7, 219.2, 218.7, 218.2, 217.7, 217.2, 216.7, 216.2,
        215.7, 215.2, 215.2, 215.2, 215.2, 215.2, 215.2, 215.2,
        215.5, 217.4, 220.4, 227.9, 235.5, 243.2, 250.8, 258.5, 265.1,
        265.7,
        260.6, 250.8, 240.9, 230.7, 220.4, 210.1, 199.8, 199.5, 208.3,
        218.6, 237.1, 259.5, 293.0, 333.0,
    ]),
    # model 4
    "subarctic_summer": np.array([
        287.2, 281.7, 276.3, 270.9, 265.5, 260.1, 253.1, 246.1, 239.2,
        232.2, 225.2, 225.2, 225.2, 225.2, 225.2, 225.2, 225.2, 225.2,
        225.2, 225.2, 225.2, 225.2, 225.2, 225.2, 226.6, 228.1,
        231.0, 235.1, 240.0, 247.2, 254.6, 262.1, 269.5, 273.6, 276.2,
        277.2,
        274.0, 262.7, 239.7, 216.6, 193.6, 170.6, 161.7, 161.6, 176.8,
        190.4, 226.0, 270.1, 322.7, 380.0,
    ]),
    # model 5 (note the surface inversion)
    "subarctic_winter": np.array([
        257.1, 259.1, 255.9, 252.7, 247.7, 240.9, 234.1, 227.3, 220.6,
        217.2, 217.2, 217.2, 217.2, 217.2, 217.2, 217.2, 216.6, 216.0,
        215.4, 214.8, 214.2, 213.6, 213.0, 212.4, 211.8, 211.2,
        213.6, 216.0, 218.5, 222.3, 228.5, 234.7, 240.8, 247.0, 253.2,
        259.3,
        259.1, 250.9, 248.4, 245.4, 234.7, 223.9, 213.1, 202.3, 211.0,
        218.5, 234.0, 252.6, 288.5, 333.0,
    ]),
    # model 6: U.S. Standard 1976
    "us_standard": np.array([
        288.2, 281.7, 275.2, 268.7, 262.2, 255.7, 249.2, 242.7, 236.2,
        229.7, 223.3, 216.8, 216.7, 216.7, 216.7, 216.7, 216.7, 216.7,
        216.7, 216.7, 216.7, 217.6, 218.6, 219.6, 220.6, 221.6,
        224.0, 226.5, 230.0, 236.5, 242.9, 250.4, 257.3, 264.2, 270.6,
        270.7,
        260.8, 247.0, 233.3, 219.6, 208.4, 198.6, 188.9, 186.9, 188.4,
        195.1, 208.8, 240.0, 300.0, 360.0,
    ]),
}

#: Per-variant surface values: (p0 [Pa], x_H2O(0), x_O3(0))
AFGL_SURFACE = {
    "tropical": (101300.0, 2.59e-2, 2.87e-8),
    "midlatitude_summer": (101300.0, 1.88e-2, 3.02e-8),
    "midlatitude_winter": (101800.0, 4.32e-3, 2.78e-8),
    "subarctic_summer": (101000.0, 1.19e-2, 2.41e-8),
    "subarctic_winter": (101300.0, 1.41e-3, 1.80e-8),
    "us_standard": (101325.0, 7.75e-3, 2.66e-8),
}

#: Common AFGL water-vapor tail [ppmv] above the stratopause (55–120 km),
#: where the published variants converge.
_H2O_TAIL = [
    4.750, 4.200, 3.500, 2.825, 2.050, 1.330, 0.850, 0.540,
    0.400, 0.340, 0.280, 0.240, 0.200, 0.180,
]

#: Water-vapor mole fraction [ppmv] at AFGL_Z_KM per variant (see module
#: docstring for the per-tier provenance).  AFGL-TR-86-0110 Table 2
#: column "H2O"; cf. joseki's ``afgl_1986-*`` datasets consumed by the
#: reference at ``src/eradiate/scenes/atmosphere/_molecular.py:80-84``.
AFGL_H2O_PPMV = {
    "tropical": np.array([
        2.593e4, 1.949e4, 1.534e4, 8.600e3, 4.441e3, 3.346e3, 2.101e3,
        1.289e3, 7.637e2, 4.098e2, 1.912e2, 7.306e1, 2.905e1, 9.900e0,
        6.220e0, 4.000e0,
        3.000, 2.900, 2.750, 2.600, 2.600, 2.650, 2.800, 2.900, 3.200, 3.250,
        3.600, 4.000, 4.300, 4.600, 4.900, 5.150, 5.225, 5.250, 5.225, 5.100,
        *_H2O_TAIL,
    ]),
    "midlatitude_summer": np.array([
        1.876e4, 1.378e4, 9.680e3, 5.984e3, 3.813e3, 2.225e3, 1.510e3,
        1.020e3, 6.464e2, 4.129e2, 2.472e2, 9.556e1, 2.196e1, 8.300e0,
        6.200e0, 5.150e0,
        4.850, 4.500, 4.000, 3.950, 3.850, 3.825, 3.850, 3.975, 4.065, 4.200,
        4.300, 4.425, 4.575, 4.725, 4.825, 4.900, 5.025, 5.150, 5.225, 5.100,
        *_H2O_TAIL,
    ]),
    "midlatitude_winter": np.array([
        4.316e3, 3.454e3, 2.788e3, 2.088e3, 1.280e3, 8.241e2, 5.103e2,
        2.321e2, 1.077e2, 5.566e1, 2.960e1, 1.000e1, 6.000e0, 5.000e0,
        4.800e0, 4.700e0,
        4.600, 4.500, 4.400, 4.300, 4.200, 4.200, 4.200, 4.250, 4.300, 4.400,
        4.500, 4.600, 4.700, 4.800, 4.900, 5.000, 5.100, 5.150, 5.150, 5.100,
        *_H2O_TAIL,
    ]),
    "subarctic_summer": np.array([
        1.194e4, 8.700e3, 6.750e3, 4.820e3, 3.380e3, 2.218e3, 1.330e3,
        7.971e2, 3.996e2, 1.300e2, 4.240e1, 1.330e1, 6.000e0, 4.450e0,
        4.000e0, 3.800e0,
        3.750, 3.700, 3.700, 3.750, 3.800, 3.900, 4.000, 4.100, 4.200, 4.300,
        4.450, 4.600, 4.700, 4.800, 4.900, 5.000, 5.100, 5.150, 5.150, 5.100,
        *_H2O_TAIL,
    ]),
    "subarctic_winter": np.array([
        1.405e3, 1.615e3, 1.427e3, 1.166e3, 7.898e2, 4.309e2, 2.369e2,
        1.470e2, 3.384e1, 2.976e1, 2.000e1, 1.000e1, 6.000e0, 4.450e0,
        4.000e0, 3.800e0,
        3.700, 3.650, 3.600, 3.600, 3.650, 3.700, 3.800, 3.900, 4.000, 4.100,
        4.300, 4.500, 4.650, 4.800, 4.900, 5.000, 5.100, 5.150, 5.150, 5.100,
        *_H2O_TAIL,
    ]),
    "us_standard": np.array([
        7.745e3, 6.071e3, 4.631e3, 3.182e3, 2.158e3, 1.397e3, 9.254e2,
        5.720e2, 3.667e2, 1.583e2, 6.996e1, 3.613e1, 1.906e1, 1.085e1,
        5.927e0, 5.000e0,
        3.950, 3.850, 3.825, 3.850, 3.975, 4.065, 4.200, 4.300, 4.425, 4.575,
        4.725, 4.825, 4.900, 4.950, 5.025, 5.150, 5.225, 5.250, 5.225, 5.100,
        *_H2O_TAIL,
    ]),
}

#: Common AFGL ozone mesosphere tail [ppmv] (80–120 km, incl. the
#: secondary nighttime maximum near 90 km).
_O3_TAIL = [0.300, 0.500, 0.700, 0.700, 0.400, 0.200, 0.050, 0.005, 0.0005]

#: Ozone mole fraction [ppmv] at AFGL_Z_KM per variant
#: (AFGL-TR-86-0110 Table 2 column "O3").
AFGL_O3_PPMV = {
    "tropical": np.array([
        2.869e-2, 3.150e-2, 3.342e-2, 3.504e-2, 3.561e-2, 3.767e-2,
        3.995e-2, 4.042e-2, 4.071e-2, 4.260e-2, 4.039e-2, 4.670e-2,
        5.025e-2, 5.170e-2, 6.080e-2, 6.420e-2, 7.770e-2, 9.320e-2,
        2.300e-1, 4.200e-1, 7.500e-1, 1.200e0, 1.800e0, 2.500e0,
        3.400e0, 4.300e0,
        6.400, 8.300, 9.500, 10.00, 9.800, 9.000, 8.000, 7.000, 6.000, 5.000,
        3.500, 2.000, 1.200, 0.500, 0.300, *_O3_TAIL,
    ]),
    "midlatitude_summer": np.array([
        3.017e-2, 3.337e-2, 3.694e-2, 4.222e-2, 4.821e-2, 5.512e-2,
        6.408e-2, 7.764e-2, 9.126e-2, 1.111e-1, 1.304e-1, 1.793e-1,
        2.230e-1, 3.000e-1, 4.400e-1, 5.000e-1, 6.000e-1, 7.000e-1,
        1.000e0, 1.500e0, 2.000e0, 2.400e0, 2.900e0, 3.400e0,
        3.900e0, 4.400e0,
        5.500, 6.600, 7.500, 8.100, 8.200, 8.000, 7.550, 6.950, 6.100, 5.200,
        3.400, 2.000, 1.200, 0.500, 0.300, *_O3_TAIL,
    ]),
    "midlatitude_winter": np.array([
        2.778e-2, 2.800e-2, 2.849e-2, 3.200e-2, 3.567e-2, 4.720e-2,
        5.837e-2, 7.891e-2, 1.039e-1, 1.567e-1, 2.370e-1, 3.624e-1,
        5.232e-1, 7.036e-1, 8.000e-1, 9.000e-1, 1.100e0, 1.400e0,
        1.800e0, 2.300e0, 2.900e0, 3.500e0, 3.900e0, 4.300e0,
        4.700e0, 5.100e0,
        5.600, 6.100, 6.800, 7.100, 7.200, 6.900, 6.400, 5.800, 5.100, 4.300,
        2.800, 1.800, 1.100, 0.500, 0.300, *_O3_TAIL,
    ]),
    "subarctic_summer": np.array([
        2.412e-2, 2.940e-2, 3.379e-2, 3.887e-2, 4.478e-2, 5.328e-2,
        6.564e-2, 7.738e-2, 9.114e-2, 1.420e-1, 1.890e-1, 3.050e-1,
        4.100e-1, 5.000e-1, 6.000e-1, 7.000e-1, 8.500e-1, 1.100e0,
        1.500e0, 1.900e0, 2.450e0, 3.100e0, 3.700e0, 4.200e0,
        4.700e0, 5.200e0,
        5.900, 6.600, 7.200, 7.600, 7.700, 7.500, 7.000, 6.300, 5.500, 4.600,
        3.000, 1.900, 1.150, 0.500, 0.300, *_O3_TAIL,
    ]),
    "subarctic_winter": np.array([
        1.802e-2, 2.072e-2, 2.336e-2, 2.767e-2, 3.253e-2, 3.801e-2,
        4.446e-2, 7.252e-2, 1.040e-1, 2.100e-1, 3.000e-1, 3.500e-1,
        4.000e-1, 6.500e-1, 9.000e-1, 1.200e0, 1.500e0, 1.900e0,
        2.450e0, 3.100e0, 3.700e0, 4.100e0, 4.500e0, 4.920e0,
        5.300e0, 5.600e0,
        6.100, 6.450, 6.700, 6.800, 6.700, 6.400, 5.850, 5.200, 4.400, 3.600,
        2.400, 1.500, 0.950, 0.450, 0.300, *_O3_TAIL,
    ]),
    "us_standard": np.array([
        2.660e-2, 2.931e-2, 3.237e-2, 3.318e-2, 3.387e-2, 3.768e-2,
        4.112e-2, 5.009e-2, 5.966e-2, 9.168e-2, 1.313e-1, 2.149e-1,
        3.095e-1, 3.846e-1, 5.030e-1, 6.505e-1, 8.701e-1, 1.187e0,
        1.587e0, 2.030e0, 2.579e0, 3.028e0, 3.647e0, 4.168e0,
        4.627e0, 5.118e0,
        5.803, 6.553, 7.373, 7.837, 7.800, 7.300, 6.200, 5.250, 4.100, 3.100,
        1.800, 1.100, 0.700, 0.300, 0.250, *_O3_TAIL,
    ]),
}

#: Variant-independent gas profiles [ppmv] at AFGL_Z_KM (see module
#: docstring: the AFGL per-variant spread for these species is small and
#: not transcribed).  AFGL-era CO2 = 330 ppmv, consistent with the
#: reference's AFGL 1986 datasets.
AFGL_MINOR_PPMV = {
    "CO2": np.array([330.0] * 42 + [322.0, 295.0, 235.0, 170.0, 115.0, 80.0, 55.0, 38.0]),
    "N2O": np.array([
        *([0.3200] * 11),
        0.3195, 0.3179, 0.3160, 0.3140, 0.3118, 0.3095, 0.3072, 0.3048,
        0.3024, 0.2999, 0.2972, 0.2944, 0.2912, 0.2877, 0.2837,
        0.2600, 0.2350, 0.2080, 0.1750, 0.1400, 0.1100, 0.0800, 0.0600,
        0.0450, 0.0350,
        0.0200, 0.0120, 0.0080, 0.0055, 0.0040, 0.0030, 0.0025, 0.0020,
        0.0018, 0.0016, 0.0015, 0.0014, 0.0013, 0.0012,
    ]),
    "CO": np.array([
        0.150, 0.145, 0.140, 0.135, 0.131, 0.127, 0.124, 0.122, 0.120,
        0.118, 0.115, 0.100, 0.085, 0.070, 0.060, 0.052, 0.046, 0.042,
        0.039, 0.037, 0.035, 0.033, 0.032, 0.031, 0.0305, 0.030,
        0.029, 0.028, 0.028, 0.029, 0.031, 0.034, 0.038, 0.045, 0.055,
        0.070,
        0.120, 0.210, 0.400, 0.800, 1.800, 4.000, 8.000, 14.00, 20.00,
        25.00, 30.00, 35.00, 40.00, 45.00,
    ]),
    "CH4": np.array([
        *([1.700] * 7),
        1.699, 1.697, 1.693, 1.685, 1.675, 1.662, 1.645, 1.626, 1.605,
        1.582, 1.553, 1.521, 1.480, 1.424, 1.355, 1.272, 1.191, 1.118,
        1.055,
        0.9870, 0.9136, 0.8300, 0.7460, 0.6618, 0.5638, 0.4614, 0.3631,
        0.2773, 0.2100,
        0.1650, *([0.1500] * 13),
    ]),
    "O2": np.array(
        [2.090e5] * 45 + [2.000e5, 1.900e5, 1.800e5, 1.600e5, 1.400e5]
    ),
    "N2": np.array([7.8084e5] * 50),
}

#: UV-relevant trace species [ppmv] at AFGL_Z_KM. LOWER-FIDELITY TIER
#: than AFGL_MINOR_PPMV (see module docstring): these are *approximated
#: profile shapes* — surface values, tropospheric gradients and
#: stratospheric peak altitudes consistent with the AFGL-era literature
#: and with typical measured columns (NO2 ~3e15 cm^-2 stratospheric,
#: HNO3 ~1.5e16 cm^-2, SO2 background <1e15 cm^-2) — NOT per-level
#: transcriptions of AFGL-TR-86-0110 Table 2 (not available in this
#: offline environment). They extend joseki-style species coverage for
#: UV products (reference: ``_molecular.py:80-84``); users with the
#: published tables load them via ``ThermoProfile.from_arrays``.
AFGL_UV_TRACE_PPMV = {
    # tropospheric ~3e-4, minimum near the tropopause, stratospheric
    # rise to ~1e-2 near 40 km, thermospheric increase above 90 km
    "NO": np.array([
        *np.full(11, 3.0e-4),
        2.5e-4, 2.0e-4, 1.6e-4, 1.3e-4, 1.1e-4, 1.0e-4, 1.0e-4, 1.1e-4,
        1.3e-4, 1.6e-4, 2.2e-4, 3.0e-4, 4.5e-4, 6.5e-4, 9.0e-4,
        1.5e-3, 2.4e-3, 3.5e-3, 4.8e-3, 6.2e-3, 7.5e-3, 8.7e-3, 9.6e-3,
        1.0e-2, 1.0e-2,
        9.0e-3, 7.0e-3, 5.0e-3, 3.5e-3, 2.5e-3, 2.0e-3, 2.0e-3, 3.0e-3,
        8.0e-3, 3.0e-2, 1.2e-1, 4.0e-1, 1.0e0, 2.0e0,
    ]),
    # boundary-layer maximum, free-troposphere minimum, stratospheric
    # layer peaking near 30 km
    "NO2": np.array([
        2.3e-5, 1.8e-5, 1.4e-5, 1.1e-5, 9.0e-6, 7.8e-6, 7.0e-6, 6.5e-6,
        6.2e-6, 6.1e-6, 6.1e-6, 6.2e-6, 6.6e-6, 7.5e-6, 9.0e-6, 1.2e-5,
        1.9e-5, 3.0e-5, 5.0e-5, 8.0e-5, 1.3e-4, 2.1e-4, 3.2e-4, 4.5e-4,
        6.1e-4, 8.0e-4,
        1.3e-3, 1.9e-3, 2.5e-3, 2.9e-3, 3.0e-3, 2.7e-3, 2.2e-3, 1.6e-3,
        1.1e-3, 7.0e-4,
        3.0e-4, 1.2e-4, 5.0e-5, 2.5e-5, 1.5e-5, 1.0e-5, 8.0e-6, 7.0e-6,
        7.0e-6, 8.0e-6, 1.0e-5, 1.5e-5, 2.5e-5, 4.0e-5,
    ]),
    # reservoir species: sharp stratospheric layer peaking ~22-25 km
    "HNO3": np.array([
        5.0e-5, 5.0e-5, 5.1e-5, 5.2e-5, 5.4e-5, 5.6e-5, 6.0e-5, 6.6e-5,
        7.6e-5, 9.2e-5, 1.2e-4, 1.7e-4, 2.6e-4, 4.0e-4, 6.2e-4, 9.4e-4,
        1.4e-3, 1.9e-3, 2.5e-3, 3.2e-3, 3.8e-3, 4.4e-3, 4.8e-3, 5.0e-3,
        5.0e-3, 4.8e-3,
        4.0e-3, 3.0e-3, 2.1e-3, 1.4e-3, 8.5e-4, 5.0e-4, 2.8e-4, 1.5e-4,
        8.0e-5, 4.0e-5,
        1.2e-5, 4.0e-6, 1.5e-6, 6.0e-7, 3.0e-7, 2.0e-7, 1.5e-7, 1.2e-7,
        1.0e-7, 1.0e-7, 1.0e-7, 1.0e-7, 1.0e-7, 1.0e-7,
    ]),
    # background (non-volcanic): decays from the boundary layer; slight
    # persistence in the lower-stratospheric aerosol region
    "SO2": np.array([
        3.0e-4, 2.2e-4, 1.5e-4, 1.0e-4, 7.0e-5, 5.2e-5, 4.0e-5, 3.2e-5,
        2.7e-5, 2.4e-5, 2.2e-5, 2.1e-5, 2.0e-5, 2.0e-5, 2.0e-5, 2.0e-5,
        2.0e-5, 2.1e-5, 2.1e-5, 2.2e-5, 2.2e-5, 2.1e-5, 2.0e-5, 1.9e-5,
        1.8e-5, 1.7e-5,
        1.4e-5, 1.1e-5, 8.0e-6, 5.5e-6, 3.5e-6, 2.2e-6, 1.4e-6, 8.0e-7,
        5.0e-7, 3.0e-7,
        1.2e-7, 5.0e-8, 2.5e-8, 1.5e-8, 1.0e-8, 8.0e-9, 6.0e-9, 5.0e-9,
        5.0e-9, 5.0e-9, 5.0e-9, 5.0e-9, 5.0e-9, 5.0e-9,
    ]),
}

def _shape(nodes) -> np.ndarray:
    """Piecewise log-linear mole-fraction shape on ``AFGL_Z_KM`` from a
    handful of (z_km, ppmv) nodes — the construction used for the
    approximated-shape trace tiers (values are interpolated in
    log(ppmv), clamped at the end nodes)."""
    z = np.array([n[0] for n in nodes], dtype=np.float64)
    v = np.array([n[1] for n in nodes], dtype=np.float64)
    return np.exp(np.interp(AFGL_Z_KM, z, np.log(v)))


#: Remaining AFGL/joseki trace species [ppmv] at AFGL_Z_KM — the species
#: that complete joseki's 28-molecule ``afgl_1986-*`` set
#: (``joseki.make(..., additional_molecules=True)``; the reference's
#: default is ``additional_molecules=False`` i.e. the 7 per-variant
#: gases, ``src/eradiate/scenes/atmosphere/_molecular.py:80-84``).
#: AFGL-TR-86-0110 tabulates these as SINGLE profiles shared by all six
#: model atmospheres, which this table mirrors. LOWEST-FIDELITY TIER
#: (see module docstring): approximated profile *shapes* — surface
#: values, tropospheric gradients and stratospheric layers consistent
#: with the AFGL-era literature and typical measured abundances — built
#: from sparse (z, ppmv) nodes via log-linear interpolation, NOT
#: per-level transcriptions (published tables unavailable offline).
#: Radiometrically all are minor at reflective wavelengths; users with
#: the published tables substitute via ``ThermoProfile.from_arrays``.
AFGL_SINGLE_TRACE_PPMV = {
    # sharp decline of the soluble surface-sourced gas
    "NH3": _shape([(0, 5.0e-4), (2, 3.0e-4), (6, 8.0e-5), (10, 1.5e-5),
                   (16, 3.0e-6), (30, 5.0e-7), (50, 2.0e-7), (120, 1.0e-7)]),
    # photochemical radical: ppq-level troposphere, mesospheric layer
    "OH": _shape([(0, 5.0e-8), (10, 8.0e-8), (20, 6.0e-7), (30, 6.0e-6),
                  (40, 6.0e-5), (50, 3.0e-4), (60, 1.0e-3), (75, 8.0e-3),
                  (85, 1.5e-2), (95, 5.0e-3), (120, 1.0e-3)]),
    # stratospheric source (CFC photolysis): rises above the tropopause
    "HF": _shape([(0, 3.0e-5), (12, 3.0e-5), (20, 1.5e-4), (30, 5.0e-4),
                  (40, 9.0e-4), (50, 1.0e-3), (120, 1.0e-3)]),
    # marine boundary layer + stratospheric reservoir
    "HCl": _shape([(0, 1.0e-3), (2, 4.0e-4), (8, 1.5e-4), (14, 1.0e-4),
                   (20, 2.5e-4), (30, 8.0e-4), (40, 1.6e-3), (50, 2.0e-3),
                   (120, 2.0e-3)]),
    "HBr": _shape([(0, 1.7e-6), (12, 1.7e-6), (50, 2.2e-6), (120, 2.2e-6)]),
    "HI": _shape([(0, 3.0e-6), (120, 3.0e-6)]),
    # upper-stratospheric photochemical layer
    "ClO": _shape([(0, 1.0e-8), (15, 2.0e-8), (25, 1.0e-5), (32, 5.0e-5),
                   (40, 1.4e-4), (45, 1.0e-4), (55, 3.0e-5), (70, 1.0e-6),
                   (120, 1.0e-7)]),
    # long-lived tropospheric reservoir, photolysed in the stratosphere
    "OCS": _shape([(0, 5.0e-4), (12, 5.0e-4), (20, 2.5e-4), (30, 3.0e-5),
                   (40, 3.0e-6), (60, 5.0e-7), (120, 1.0e-7)]),
    # formaldehyde: CH4-oxidation background, photolysed aloft
    "H2CO": _shape([(0, 2.0e-3), (2, 1.0e-3), (8, 3.0e-4), (14, 1.0e-4),
                    (25, 3.0e-5), (40, 1.0e-5), (60, 3.0e-6), (120, 1.0e-6)]),
    # chlorine reservoir layer below the ClO peak
    "HOCl": _shape([(0, 1.0e-8), (15, 5.0e-8), (25, 3.0e-5), (35, 1.1e-4),
                    (42, 8.0e-5), (55, 1.0e-5), (120, 1.0e-7)]),
    # well-mixed through the stratosphere
    "HCN": _shape([(0, 1.7e-4), (30, 1.7e-4), (50, 1.0e-4), (80, 2.0e-5),
                   (120, 5.0e-6)]),
    # methyl chloride: dominant natural organochlorine
    "CH3Cl": _shape([(0, 6.0e-4), (12, 6.0e-4), (20, 4.5e-4), (30, 1.5e-4),
                     (40, 2.5e-5), (55, 2.0e-6), (120, 1.0e-7)]),
    # hydrogen peroxide: HOx reservoir, lower-troposphere maximum
    "H2O2": _shape([(0, 1.5e-3), (4, 1.0e-3), (10, 3.0e-4), (16, 1.0e-4),
                    (25, 1.5e-4), (35, 1.0e-4), (45, 3.0e-5), (60, 5.0e-6),
                    (120, 1.0e-7)]),
    # acetylene: combustion-sourced, short-lived
    "C2H2": _shape([(0, 3.0e-4), (4, 1.5e-4), (10, 6.0e-5), (16, 2.0e-5),
                    (25, 3.0e-6), (40, 3.0e-7), (120, 1.0e-8)]),
    # ethane: longest-lived NMHC
    "C2H6": _shape([(0, 1.5e-3), (8, 1.0e-3), (14, 5.0e-4), (20, 2.0e-4),
                    (30, 3.0e-5), (40, 5.0e-6), (60, 1.0e-6), (120, 1.0e-7)]),
    # phosphine: no persistent terrestrial background — kept at the AFGL
    # placeholder floor so the species axis exists for HITRAN-keyed DBs
    "PH3": _shape([(0, 1.0e-8), (120, 1.0e-8)]),
}


for _name, _tab in AFGL_MINOR_PPMV.items():
    assert _tab.size == 50, _name
for _name, _tab in AFGL_UV_TRACE_PPMV.items():
    assert _tab.size == 50, _name
for _name, _tab in AFGL_SINGLE_TRACE_PPMV.items():
    assert _tab.size == 50, _name
for _tabs in (AFGL_H2O_PPMV, AFGL_O3_PPMV):
    for _name, _tab in _tabs.items():
        assert _tab.size == 50, _name

#: Per-variant gas-column parameters:
#: pwv_cm  — precipitable water vapor column [cm]
#: o3_du   — ozone column [Dobson units]
#: o3_peak_km / o3_width_km — stratospheric ozone layer shape
AFGL_GAS = {
    "tropical": {"pwv_cm": 4.12, "o3_du": 277.0, "o3_peak_km": 26.5, "o3_width_km": 5.5},
    "midlatitude_summer": {"pwv_cm": 2.92, "o3_du": 331.0, "o3_peak_km": 23.5, "o3_width_km": 6.5},
    "midlatitude_winter": {"pwv_cm": 0.85, "o3_du": 377.0, "o3_peak_km": 21.0, "o3_width_km": 7.0},
    "subarctic_summer": {"pwv_cm": 2.08, "o3_du": 344.0, "o3_peak_km": 21.5, "o3_width_km": 7.0},
    "subarctic_winter": {"pwv_cm": 0.42, "o3_du": 448.0, "o3_peak_km": 18.5, "o3_width_km": 7.5},
    "us_standard": {"pwv_cm": 1.42, "o3_du": 345.0, "o3_peak_km": 23.0, "o3_width_km": 6.5},
}
