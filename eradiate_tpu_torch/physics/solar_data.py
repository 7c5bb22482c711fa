# Host-code copy of eradiate_tpu/physics/solar_data.py; regenerate with tools/copy_host_code.py, do not edit.
"""Packaged coarse solar spectral irradiance table.

Replaces the Planck-5772K fallback (VERDICT r1, Missing #3c) with a real
solar *shape*: an AM0 anchor table at coarse (10-100 nm) resolution
following the standard extraterrestrial references (ASTM E490 / Thuillier
2003 family — the reference's default is ``coddington_2021-1_nm``,
``src/eradiate/scenes/spectra/_solar_irradiance.py:129``), renormalized so
the in-band [250, 3125] nm integral equals 98% of the 1361 W/m^2 total
solar irradiance (the Planck fraction outside the band).

Fidelity: anchors carry ~±5% per-point uncertainty (coarse sampling
smooths Fraunhofer structure); absolute calibration is pinned by the TSI
normalization. For line-resolved or mission-grade spectra install a real
dataset (``solar/<id>.npz`` with ``w`` [nm], ``ssi`` [W/m^2/nm], e.g.
imported from a reference NetCDF with
:func:`eradiate_tpu.data.netcdf.load_solar_netcdf`). Unlike the Planck
fallback this table reproduces the UV falloff (Planck overestimates
250-300 nm by 2-4x) and the Fraunhofer-depressed blue — which matter for
absolute radiance products (BRF-like outputs are irradiance-normalized
and insensitive to the choice).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "COARSE_AM0_W_NM",
    "COARSE_AM0_SSI",
    "FINE_AM0_W_NM",
    "FINE_AM0_SSI",
    "TSI_W_M2",
]

#: Total solar irradiance [W/m^2] at 1 AU
TSI_W_M2 = 1361.0

#: Anchor wavelengths [nm]
COARSE_AM0_W_NM = np.array([
    250.0, 260.0, 270.0, 280.0, 290.0, 300.0, 310.0, 320.0, 330.0,
    340.0, 350.0, 360.0, 370.0, 380.0, 390.0, 400.0, 410.0, 420.0,
    430.0, 440.0, 450.0, 460.0, 470.0, 480.0, 490.0, 500.0, 520.0,
    540.0, 550.0, 570.0, 600.0, 650.0, 700.0, 750.0, 800.0, 850.0,
    900.0, 950.0, 1000.0, 1100.0, 1200.0, 1300.0, 1400.0, 1500.0,
    1600.0, 1700.0, 1800.0, 1900.0, 2000.0, 2100.0, 2200.0, 2300.0,
    2400.0, 2500.0, 2700.0, 3000.0, 3125.0,
])

#: Spectral solar irradiance anchors [W/m^2/nm] (pre-normalization shape)
_SSI_RAW = np.array([
    0.064, 0.130, 0.232, 0.222, 0.482, 0.514, 0.689, 0.830, 1.059,
    1.074, 0.961, 0.967, 1.160, 1.112, 1.098, 1.700, 1.750, 1.750,
    1.640, 1.830, 2.060, 2.050, 2.040, 2.070, 1.950, 1.940, 1.830,
    1.870, 1.860, 1.810, 1.770, 1.530, 1.430, 1.280, 1.120, 0.970,
    0.900, 0.830, 0.740, 0.610, 0.500, 0.410, 0.340, 0.290, 0.240,
    0.200, 0.160, 0.130, 0.105, 0.090, 0.078, 0.068, 0.060, 0.052,
    0.041, 0.030, 0.026,
])

# Normalize: in-band integral = TSI x in-band Planck fraction (0.98)
_norm = 0.98 * TSI_W_M2 / np.trapezoid(_SSI_RAW, COARSE_AM0_W_NM)
COARSE_AM0_SSI = _SSI_RAW * _norm


# ---------------------------------------------------------------------------
# Band-anchored fine table (round 3, VERDICT r2 task #9)

#: Fine-grid AM0 wavelengths [nm]: 5 nm over 250-1100, 10 nm to 1800,
#: 25 nm to 2500, coarse tail to 3125.
FINE_AM0_W_NM = np.array([
    250, 255, 260, 265, 270, 275, 280,
    285, 290, 295, 300, 305, 310, 315,
    320, 325, 330, 335, 340, 345, 350,
    355, 360, 365, 370, 375, 380, 385,
    390, 395, 400, 405, 410, 415, 420,
    425, 430, 435, 440, 445, 450, 455,
    460, 465, 470, 475, 480, 485, 490,
    495, 500, 505, 510, 515, 520, 525,
    530, 535, 540, 545, 550, 555, 560,
    565, 570, 575, 580, 585, 590, 595,
    600, 605, 610, 615, 620, 625, 630,
    635, 640, 645, 650, 655, 660, 665,
    670, 675, 680, 685, 690, 695, 700,
    705, 710, 715, 720, 725, 730, 735,
    740, 745, 750, 755, 760, 765, 770,
    775, 780, 785, 790, 795, 800, 805,
    810, 815, 820, 825, 830, 835, 840,
    845, 850, 855, 860, 865, 870, 875,
    880, 885, 890, 895, 900, 905, 910,
    915, 920, 925, 930, 935, 940, 945,
    950, 955, 960, 965, 970, 975, 980,
    985, 990, 995, 1000, 1005, 1010, 1015,
    1020, 1025, 1030, 1035, 1040, 1045, 1050,
    1055, 1060, 1065, 1070, 1075, 1080, 1085,
    1090, 1095, 1100, 1110, 1120, 1130, 1140,
    1150, 1160, 1170, 1180, 1190, 1200, 1210,
    1220, 1230, 1240, 1250, 1260, 1270, 1280,
    1290, 1300, 1310, 1320, 1330, 1340, 1350,
    1360, 1370, 1380, 1390, 1400, 1410, 1420,
    1430, 1440, 1450, 1460, 1470, 1480, 1490,
    1500, 1510, 1520, 1530, 1540, 1550, 1560,
    1570, 1580, 1590, 1600, 1610, 1620, 1630,
    1640, 1650, 1660, 1670, 1680, 1690, 1700,
    1710, 1720, 1730, 1740, 1750, 1760, 1770,
    1780, 1790, 1800, 1825, 1850, 1875, 1900,
    1925, 1950, 1975, 2000, 2025, 2050, 2075,
    2100, 2125, 2150, 2175, 2200, 2225, 2250,
    2275, 2300, 2325, 2350, 2375, 2400, 2425,
    2450, 2475, 2500, 2700, 3000, 3125,
])

#: Fine-grid AM0 solar spectral irradiance [W/m^2/nm].
#:
#: Construction & provenance: the coarse anchor shape above, refined onto
#: the fine grid and then calibrated by a smooth multiplicative spline so
#: the band-integrated irradiance over each of the packaged Sentinel-2A
#: MSI SRFs (round-5 flat-tops from published center/FWHM,
#: data/store/srf/make_srf.py) matches the published ESA band solar
#: irradiances to <0.1%
#: (asserted by tests/unit/test_solar_table.py) — the band-integrated
#: values are the product-relevant quantity; the shape BETWEEN anchors
#: remains smooth (individual Fraunhofer lines are not resolved; install
#: a measured dataset, e.g. Coddington 2021 via
#: ``data.netcdf.load_solar_netcdf``, for line-resolved work).  The
#: 250-3125 nm integral is 1355 W/m^2 = 99.6% of TSI, consistent with the
#: E490 in-band fraction within the unanchored UV/IR tail uncertainty.
FINE_AM0_SSI = np.array([
    0.06494, 0.09842, 0.13190, 0.18366, 0.23540, 0.23033, 0.22526,
    0.35716, 0.48907, 0.50530, 0.52154, 0.61032, 0.69910, 0.77064,
    0.84217, 0.95835, 1.07458, 1.08218, 1.08979, 1.03247, 0.97510,
    0.97814, 0.98119, 1.07908, 1.17701, 1.15270, 1.12830, 1.12119,
    1.11409, 1.41947, 1.72495, 1.75026, 1.77567, 1.77567, 1.77567,
    1.71985, 1.66404, 1.76046, 1.85689, 1.97066, 2.08071, 2.06912,
    2.05757, 2.04607, 2.03461, 2.04301, 2.05138, 1.98556, 1.92010,
    1.91302, 1.90971, 1.88416, 1.85848, 1.83288, 1.80717, 1.81842,
    1.82973, 1.84098, 1.85228, 1.84874, 1.84504, 1.83398, 1.82287,
    1.81177, 1.80066, 1.79528, 1.78999, 1.78460, 1.77922, 1.77383,
    1.76844, 1.74570, 1.72296, 1.70022, 1.67738, 1.65444, 1.63160,
    1.60866, 1.58571, 1.56267, 1.53962, 1.53072, 1.52172, 1.51263,
    1.50229, 1.49196, 1.48164, 1.47134, 1.46105, 1.45078, 1.44051,
    1.42438, 1.40455, 1.38490, 1.36533, 1.34584, 1.32643, 1.30719,
    1.28804, 1.27366, 1.25984, 1.24505, 1.23017, 1.21531, 1.20037,
    1.18545, 1.17054, 1.15635, 1.14327, 1.13005, 1.11677, 1.10446,
    1.09201, 1.07951, 1.06698, 1.05430, 1.04158, 1.02741, 1.01139,
    0.99538, 0.97936, 0.97142, 0.96347, 0.95543, 0.94624, 0.93708,
    0.92795, 0.91885, 0.90979, 0.90076, 0.89177, 0.88280, 0.87387,
    0.86497, 0.85610, 0.84726, 0.83847, 0.82970, 0.82095, 0.81225,
    0.80588, 0.79759, 0.78929, 0.78100, 0.77268, 0.76435, 0.75603,
    0.74768, 0.73933, 0.73096, 0.72259, 0.71665, 0.71070, 0.70475,
    0.69879, 0.69282, 0.68684, 0.68086, 0.67487, 0.66887, 0.66287,
    0.65685, 0.65084, 0.64481, 0.63877, 0.63273, 0.62668, 0.62063,
    0.61456, 0.60850, 0.60242, 0.59222, 0.58201, 0.57176, 0.56148,
    0.55119, 0.54087, 0.53053, 0.52016, 0.50976, 0.49935, 0.49091,
    0.48244, 0.47397, 0.46547, 0.45694, 0.44840, 0.43985, 0.43126,
    0.42266, 0.41404, 0.40742, 0.40079, 0.39414, 0.38747, 0.38079,
    0.37409, 0.36738, 0.36065, 0.35391, 0.34715, 0.34242, 0.33767,
    0.33293, 0.32816, 0.32339, 0.31860, 0.31380, 0.30899, 0.30418,
    0.29935, 0.29450, 0.28965, 0.28479, 0.27992, 0.27502, 0.27013,
    0.26522, 0.26030, 0.25537, 0.25042, 0.24652, 0.24255, 0.23855,
    0.23455, 0.23053, 0.22651, 0.22248, 0.21846, 0.21442, 0.21037,
    0.20632, 0.20226, 0.19820, 0.19413, 0.19004, 0.18597, 0.18188,
    0.17778, 0.17368, 0.16957, 0.16192, 0.15426, 0.14655, 0.13882,
    0.13238, 0.12594, 0.11946, 0.11296, 0.10913, 0.10528, 0.10142,
    0.09755, 0.09447, 0.09138, 0.08828, 0.08517, 0.08245, 0.07972,
    0.07699, 0.07426, 0.07208, 0.06989, 0.06771, 0.06552, 0.06334,
    0.06116, 0.05897, 0.05679, 0.04477, 0.03276, 0.02839,
])
