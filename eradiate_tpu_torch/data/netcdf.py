# Host-code copy of eradiate_tpu/data/netcdf.py; regenerate with tools/copy_host_code.py, do not edit.
"""NetCDF-4 dataset import (via h5py).

The reference distributes its datasets as NetCDF (SRFs, solar irradiance,
aerosol single-scattering properties, thermophysical profiles, absorption
databases). netCDF4/xarray are unavailable in this environment, but
NetCDF-4 files are HDF5 containers, so h5py reads them directly. Classic
NetCDF-3 files are not supported (convert with ``nccopy -k nc4`` upstream).

Converters map the reference's dataset conventions onto this package's
native structures so users can point the framework at an existing Eradiate
data store.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "read_netcdf",
    "load_srf_netcdf",
    "load_solar_netcdf",
    "load_aerosol_netcdf",
    "load_thermoprops_netcdf",
]

_UNIT_TO_NM = {
    "nm": 1.0,
    "nanometer": 1.0,
    "nanometers": 1.0,
    "um": 1e3,
    "micron": 1e3,
    "micrometer": 1e3,
    "angstrom": 0.1,
    "m": 1e9,
}


def read_netcdf(path) -> dict:
    """Read a NetCDF-4 file -> {"variables": {name: (data, attrs)},
    "attrs": {...}}."""
    import h5py

    out = {"variables": {}, "attrs": {}}

    def decode(v):
        if isinstance(v, bytes):
            return v.decode(errors="replace")
        if isinstance(v, np.ndarray) and v.dtype.kind == "S":
            return v.astype(str)
        return v

    with h5py.File(path, "r") as f:
        out["attrs"] = {k: decode(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                attrs = {k: decode(v) for k, v in obj.attrs.items()}
                out["variables"][name] = (np.asarray(obj[()]), attrs)

        f.visititems(visit)
    return out


def _wavelength_to_nm(values, attrs):
    units = str(attrs.get("units", "nm")).strip().lower()
    factor = _UNIT_TO_NM.get(units)
    if factor is None:
        raise ValueError(f"unsupported wavelength units '{units}'")
    return np.asarray(values, dtype=np.float64) * factor


def _find_var(ds, candidates):
    for name in candidates:
        for full, payload in ds["variables"].items():
            if full.split("/")[-1] == name:
                return payload
    raise KeyError(f"none of {candidates} found; have {list(ds['variables'])}")


def load_srf_netcdf(path):
    """Load a reference-format SRF dataset (variables ``w``/``wavelength``
    + ``srf``) -> BandSRF."""
    from ..spectral.response import BandSRF

    ds = read_netcdf(path)
    w, wa = _find_var(ds, ["w", "wavelength"])
    srf, _ = _find_var(ds, ["srf", "response", "values"])
    return BandSRF(_wavelength_to_nm(w, wa), np.asarray(srf, dtype=np.float64))


def load_solar_netcdf(path):
    """Load a solar irradiance spectrum dataset -> (w_nm, ssi W/m^2/nm)."""
    ds = read_netcdf(path)
    w, wa = _find_var(ds, ["w", "wavelength"])
    ssi, sa = _find_var(ds, ["ssi", "irradiance", "spectral_irradiance"])
    w_nm = _wavelength_to_nm(w, wa)
    ssi = np.asarray(ssi, dtype=np.float64).squeeze()
    units = str(sa.get("units", "W/m^2/nm")).lower().replace(" ", "")
    if "micron" in units or "um" in units:
        ssi = ssi / 1e3
    return w_nm, ssi


def load_aerosol_netcdf(path, ident="netcdf"):
    """Load a reference aerosol single-scattering dataset -> ParticleDataset.

    Expects variables sigma_t (w), albedo (w), phase (w, mu[, i, j]).
    """
    from ..scenes.atmosphere.aerosols import ParticleDataset

    ds = read_netcdf(path)
    w, wa = _find_var(ds, ["w", "wavelength"])
    sigma_t, _ = _find_var(ds, ["sigma_t", "sigma_t_ref", "extinction"])
    albedo, _ = _find_var(ds, ["albedo", "ssa", "single_scattering_albedo"])
    phase, _ = _find_var(ds, ["phase", "p"])
    mu, _ = _find_var(ds, ["mu", "cos_theta"])
    phase = np.asarray(phase, dtype=np.float64)
    while phase.ndim > 2:
        phase = phase[..., 0]  # unpolarized component (i=j=0)
    w_nm = _wavelength_to_nm(w, wa)
    order = np.argsort(w_nm)
    return ParticleDataset(
        id=ident,
        w=w_nm[order],
        sigma_t=np.asarray(sigma_t, dtype=np.float64)[order],
        albedo=np.asarray(albedo, dtype=np.float64)[order],
        mu=np.asarray(mu, dtype=np.float64),
        phase=phase[order],
    )


def load_thermoprops_netcdf(path, ident="netcdf"):
    """Load a joseki-format thermophysical profile -> ThermoProfile.

    Expects z [km or m], p [Pa], t [K] and mole fractions ``x_<M>``.
    """
    from ..physics.thermoprops import ThermoProfile

    ds = read_netcdf(path)
    z, za = _find_var(ds, ["z", "altitude"])
    p, _ = _find_var(ds, ["p", "pressure"])
    t, _ = _find_var(ds, ["t", "temperature"])
    z = np.asarray(z, dtype=np.float64)
    if str(za.get("units", "km")).strip().lower() in ("m", "meter", "metre"):
        z = z / 1e3
    x = {}
    for full, (data, _a) in ds["variables"].items():
        name = full.split("/")[-1]
        if name.startswith("x_"):
            x[name[2:]] = np.asarray(data, dtype=np.float64).squeeze()
    return ThermoProfile.from_arrays(
        z, np.asarray(p, np.float64).squeeze(), np.asarray(t, np.float64).squeeze(),
        x, id=ident,
    )
