# Host-code copy of eradiate_tpu/physics/thermoprops.py; regenerate with tools/copy_host_code.py, do not edit.
"""Thermophysical atmosphere profiles.

Replaces the reference's external ``joseki`` dependency
(``src/eradiate/scenes/atmosphere/_molecular.py:80-84`` builds
``joseki.make("afgl_1986-us_standard")``): provides altitude profiles of
pressure, temperature, air number density and species mole fractions.

Implementation notes
--------------------
- The ``us_standard`` profile is computed **analytically** from the
  U.S. Standard Atmosphere 1976 hydrostatic equations (geopotential layers
  with piecewise-linear temperature up to 84.852 km', isothermal extension
  above — where the atmosphere holds <4e-6 of its mass, so the deviation
  from the tabulated USSA thermosphere is radiometrically negligible).
- AFGL 1986 seasonal variants (tropical, midlatitude/subarctic
  summer/winter) are provided as temperature/humidity re-parameterizations
  of the same hydrostatic solver; they approximate (not reproduce bit-exact)
  the AFGL tabulations, which ship with the external data distribution the
  reference downloads at runtime. Loaders accept user-provided tabulated
  profiles (`from_arrays`) for exact data.
- Trace-gas mole fraction profiles (H2O, O3, ...) use standard analytic
  parameterizations; they only matter when molecular absorption is enabled,
  which requires an absorption database.

Units: altitude km, pressure Pa, temperature K, number density km^-3.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ThermoProfile", "ussa1976", "afgl_1986", "make_profile"]

# Physical constants (CODATA)
K_BOLTZMANN = 1.380649e-23  # J/K
G0 = 9.80665  # m/s^2
M_AIR = 0.0289644  # kg/mol
R_STAR = 8.31432  # J/(mol K)  (USSA76 value)
R_EARTH_KM = 6356.766  # USSA76 effective Earth radius for geopotential [km]

# USSA76 geopotential layer table: (h_base [km'], T_base [K], L [K/km'])
_USSA_LAYERS = [
    (0.0, 288.15, -6.5),
    (11.0, 216.65, 0.0),
    (20.0, 216.65, 1.0),
    (32.0, 228.65, 2.8),
    (47.0, 270.65, 0.0),
    (51.0, 270.65, -2.8),
    (71.0, 214.65, -2.0),
    (84.852, 186.946, 0.0),  # isothermal extension (see module docstring)
]
_P0 = 101325.0  # Pa

# Dry-air composition (AFGL-era CO2 at 330 ppmv, matching AFGL 1986 tables)
_DRY_AIR = {"N2": 0.78084, "O2": 0.209476, "Ar": 0.00934, "CO2": 0.000330}


def _geometric_to_geopotential(z_km):
    return R_EARTH_KM * z_km / (R_EARTH_KM + z_km)


def _ussa_p_T(h_km):
    """Pressure [Pa] and temperature [K] at geopotential altitudes h [km']."""
    h = np.atleast_1d(np.asarray(h_km, dtype=np.float64))
    p = np.empty_like(h)
    T = np.empty_like(h)
    gmr = G0 * M_AIR / R_STAR * 1e3  # K/km' exponent scale: g0 M / R*
    # Precompute base pressures
    bases = [(_USSA_LAYERS[0][0], _P0)]
    for i in range(1, len(_USSA_LAYERS)):
        h_b, T_b, L_b = _USSA_LAYERS[i - 1]
        h_t = _USSA_LAYERS[i][0]
        p_b = bases[-1][1]
        if L_b == 0.0:
            p_t = p_b * np.exp(-gmr * (h_t - h_b) / T_b)
        else:
            p_t = p_b * (T_b / (T_b + L_b * (h_t - h_b))) ** (gmr / L_b)
        bases.append((h_t, p_t))
    h_bases = np.array([b[0] for b in bases])
    idx = np.clip(np.searchsorted(h_bases, h, side="right") - 1, 0, len(bases) - 1)
    for i in range(len(_USSA_LAYERS)):
        sel = idx == i
        if not np.any(sel):
            continue
        h_b, T_b, L_b = _USSA_LAYERS[i]
        p_b = bases[i][1]
        dh = h[sel] - h_b
        if L_b == 0.0:
            T[sel] = T_b
            p[sel] = p_b * np.exp(-gmr * dh / T_b)
        else:
            T[sel] = T_b + L_b * dh
            p[sel] = p_b * (T_b / T[sel]) ** (gmr / L_b)
    return p, T


def _x_h2o(z_km, surface_x=7.75e-3, scale_km=2.3, strat_x=4.0e-6):
    """Analytic water-vapor mole fraction: exponential decay to a
    stratospheric floor."""
    return np.maximum(surface_x * np.exp(-np.asarray(z_km) / scale_km), strat_x)


def _x_o3(z_km, peak_x=8.0e-6, peak_km=35.0, width_km=10.0, surface_x=3.0e-8):
    """Analytic ozone mole fraction: Gaussian stratospheric layer + floor."""
    z = np.asarray(z_km)
    return surface_x + peak_x * np.exp(-0.5 * ((z - peak_km) / width_km) ** 2)


@dataclass(frozen=True)
class ThermoProfile:
    """Thermophysical profile sampled at altitude *levels*.

    Fields: ``z`` [km], ``p`` [Pa], ``t`` [K], ``n`` [km^-3] (air number
    density), ``x`` mapping species name -> mole fraction profile.
    """

    z: np.ndarray
    p: np.ndarray
    t: np.ndarray
    n: np.ndarray
    x: dict = field(default_factory=dict)
    id: str = "custom"

    @classmethod
    def from_arrays(cls, z_km, p_pa, t_k, x=None, id="custom"):
        z = np.asarray(z_km, dtype=np.float64)
        p = np.asarray(p_pa, dtype=np.float64)
        t = np.asarray(t_k, dtype=np.float64)
        # number density n = p/(kT) in m^-3; convert to km^-3 (1 m^-3 = 1e9 km^-3)
        n = p / (K_BOLTZMANN * t) * 1e9
        return cls(z, p, t, n, dict(x or {}), id=id)

    def interp(self, z_km) -> "ThermoProfile":
        """Linear-in-log-p interpolation onto new altitudes (mirror of the
        reference's profile regridding, ``radprops/_atmosphere.py:149-157``)."""
        z_new = np.atleast_1d(np.asarray(z_km, dtype=np.float64))
        logp = np.interp(z_new, self.z, np.log(self.p))
        t = np.interp(z_new, self.z, self.t)
        p = np.exp(logp)
        n = p / (K_BOLTZMANN * t) * 1e9
        x = {k: np.interp(z_new, self.z, v) for k, v in self.x.items()}
        return ThermoProfile(z_new, p, t, n, x, id=self.id)


def ussa1976(z_km=None) -> ThermoProfile:
    """U.S. Standard Atmosphere 1976 analytic profile at altitudes z [km]."""
    if z_km is None:
        z_km = np.linspace(0.0, 120.0, 121)
    z = np.atleast_1d(np.asarray(z_km, dtype=np.float64))
    h = _geometric_to_geopotential(z)
    p, T = _ussa_p_T(h)
    n = p / (K_BOLTZMANN * T) * 1e9  # km^-3
    x = dict(_DRY_AIR)
    x = {k: np.full_like(z, v) for k, v in x.items()}
    x["H2O"] = _x_h2o(z)
    x["O3"] = _x_o3(z)
    return ThermoProfile(z, p, T, n, x, id="ussa_1976")


def _hydrostatic_pressure(z_km, t_k, p0_pa):
    """Integrate dp/dz = -g(z) p M / (R T) over the level grid.

    Trapezoidal integration of 1/T in log-pressure with altitude-dependent
    gravity g(z) = g0 (R_E / (R_E + z))^2 — the construction rule of the
    published AFGL tables, so the reconstruction matches them closely
    (module docstring: Provenance & fidelity).
    """
    z_m = np.asarray(z_km, dtype=np.float64) * 1e3
    t = np.asarray(t_k, dtype=np.float64)
    g = G0 * (R_EARTH_KM / (R_EARTH_KM + np.asarray(z_km))) ** 2
    integrand = g * M_AIR / (R_STAR * t)  # d(ln p)/dz [1/m]
    dlnp = -0.5 * (integrand[1:] + integrand[:-1]) * np.diff(z_m)
    return p0_pa * np.exp(np.concatenate([[0.0], np.cumsum(dlnp)]))


_M_H2O = 0.018015  # kg/mol
_N_AVOGADRO = 6.02214076e23
_RHO_WATER = 1000.0  # kg/m^3
_DU = 2.6867e20  # molecules/m^2 per Dobson unit


def _column_pwv_cm(z_km, n_m3, x_h2o):
    """Precipitable water [cm] of a mole-fraction profile."""
    rho_v = x_h2o * n_m3 * _M_H2O / _N_AVOGADRO  # kg/m^3
    col = np.trapezoid(rho_v, z_km * 1e3)  # kg/m^2
    return col / _RHO_WATER * 100.0


def afgl_1986(identifier: str = "us_standard", z_km=None) -> ThermoProfile:
    """AFGL 1986 model atmospheres (Anderson et al. 1986).

    Temperatures and gas mole fractions come from the tabulated profiles
    (:mod:`eradiate_tpu.physics.afgl1986_data` — per-variant H2O and O3
    tables plus the shared CO2/N2O/CO/CH4/O2/N2 profiles, transcribed
    from AFGL-TR-86-0110; see that module's provenance note); pressures
    are hydrostatically integrated from the tabulated T(z) and surface
    pressure.  The H2O and O3 profiles are scaled by a near-unity factor
    so the precipitable-water / Dobson columns match the published
    per-variant values exactly.  ``identifier`` may be the bare variant
    name or the reference-style ``afgl_1986-<variant>`` id
    (``src/eradiate/scenes/atmosphere/_molecular.py:80-84``).
    """
    from .afgl1986_data import (
        AFGL_GAS,
        AFGL_H2O_PPMV,
        AFGL_MINOR_PPMV,
        AFGL_O3_PPMV,
        AFGL_SINGLE_TRACE_PPMV,
        AFGL_SURFACE,
        AFGL_TEMPERATURE,
        AFGL_UV_TRACE_PPMV,
        AFGL_Z_KM,
    )

    ident = identifier.replace("afgl_1986-", "")
    if ident not in AFGL_TEMPERATURE:
        raise ValueError(
            f"unknown AFGL 1986 variant '{identifier}'; "
            f"available: {sorted(AFGL_TEMPERATURE)}"
        )

    z_tab = AFGL_Z_KM
    t_tab = AFGL_TEMPERATURE[ident]
    p0, _x_h2o_s, _x_o3_s = AFGL_SURFACE[ident]
    gas = AFGL_GAS[ident]

    p_tab = _hydrostatic_pressure(z_tab, t_tab, p0)
    n_tab = p_tab / (K_BOLTZMANN * t_tab)  # m^-3

    # Tabulated H2O / O3, column-calibrated (scale factors stay within a
    # few percent of 1; asserted by tests/unit/test_afgl_gases.py).
    x_h2o_tab = AFGL_H2O_PPMV[ident] * 1e-6
    x_h2o_tab = x_h2o_tab * (
        gas["pwv_cm"] / _column_pwv_cm(z_tab, n_tab, x_h2o_tab)
    )
    x_o3_tab = AFGL_O3_PPMV[ident] * 1e-6
    o3_col_du = np.trapezoid(x_o3_tab * n_tab, z_tab * 1e3) / _DU
    x_o3_tab = x_o3_tab * (gas["o3_du"] / o3_col_du)

    x = {k: v * 1e-6 for k, v in AFGL_MINOR_PPMV.items()}
    # Trace extension tiers (approximated shapes; see the provenance
    # notes on afgl1986_data.AFGL_UV_TRACE_PPMV / AFGL_SINGLE_TRACE_PPMV).
    # Together with the tables above these complete joseki's 28-molecule
    # afgl_1986 species set (joseki.make(..., additional_molecules=True);
    # the reference default is the 7-molecule set,
    # src/eradiate/scenes/atmosphere/_molecular.py:80-84).
    x.update({k: v * 1e-6 for k, v in AFGL_UV_TRACE_PPMV.items()})
    x.update({k: v * 1e-6 for k, v in AFGL_SINGLE_TRACE_PPMV.items()})
    x["Ar"] = np.full_like(z_tab, _DRY_AIR["Ar"])
    x["H2O"] = x_h2o_tab
    x["O3"] = x_o3_tab

    prof = ThermoProfile(
        z_tab, p_tab, t_tab, n_tab * 1e9, x, id=f"afgl_1986-{ident}"
    )
    return prof if z_km is None else prof.interp(z_km)


def make_profile(identifier, z_km=None) -> ThermoProfile:
    """Profile factory: 'afgl_1986-*', 'ussa_1976', or a ThermoProfile."""
    if isinstance(identifier, ThermoProfile):
        return identifier if z_km is None else identifier.interp(z_km)
    if isinstance(identifier, dict):
        return ThermoProfile.from_arrays(
            identifier["z"],
            identifier["p"],
            identifier["t"],
            identifier.get("x"),
            id=identifier.get("id", "custom"),
        )
    if identifier.startswith("afgl_1986"):
        return afgl_1986(identifier, z_km)
    if identifier in ("ussa_1976", "ussa1976", "us76"):
        return ussa1976(z_km)
    raise ValueError(f"unknown thermophysical profile '{identifier}'")
