# Host-code copy of eradiate_tpu/data/io.py; regenerate with tools/copy_host_code.py, do not edit.
"""Data import converters.

Mirror of ``src/eradiate/data/io.py``: convert libRadtran NetCDF aerosol
files (effective-radius- or humidity-indexed) into the particle dataset
format consumed by :class:`~eradiate_tpu.scenes.atmosphere.ParticleLayer`
(``sigma_t`` [w], ``albedo`` [w], ``phase`` [w, mu, i, j]).

Works against this package's :mod:`eradiate_tpu.xr` mini-dataset (real
``xarray.Dataset`` objects duck-type the same API). Paths load through the
h5py-based NetCDF reader with the canonical libRadtran dimension order
``(nlam[, nhum|nreff], nphamat, nthetamax)``.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.units import to_quantity
from .. import xr

__all__ = ["load_aerosol_libradtran"]

#: phase-matrix component layout (reference ``data/io.py:201-230``):
#: libRadtran stores the independent Mueller components along ``nphamat``;
#: spherical particles have 4 (P11=P22, P12=P21, P33=P44, P34=-P43),
#: spheroidal have 6 (P22 and P44 independent)
_SPHERICAL_NPHAMAT = {
    (0, 0): 0, (1, 1): 0, (0, 1): 1, (1, 0): 1,
    (2, 2): 2, (3, 3): 2, (2, 3): 3, (3, 2): 3,
}
_SPHEROIDAL_NPHAMAT = {
    (0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 4,
    (2, 2): 2, (2, 3): 3, (3, 2): 3, (3, 3): 5,
}

_UNIT_ALIASES = {"per cent": "percent"}


def _get_units(ds, var, fallback_units):
    units = ds[var].attrs.get("units")
    if units is None and fallback_units:
        units = fallback_units.get(var)
    if units is None:
        raise ValueError(
            f"load_aerosol_libradtran(): no units for variable '{var}'; "
            "pass them via 'fallback_units'"
        )
    return _UNIT_ALIASES.get(units, units)


def _wavelength_nm(values, units):
    scale = {
        "nm": 1.0,
        "nanometer": 1.0,
        "um": 1e3,
        "micron": 1e3,
        "micrometer": 1e3,
        "mum": 1e3,
        "m": 1e9,
        "meter": 1e9,
    }.get(units)
    if scale is None:
        raise ValueError(f"unsupported wavelength units '{units}'")
    return np.asarray(values, dtype=np.float64) * scale


def _ext_per_km(values, units):
    scale = {"1/km": 1.0, "km^-1": 1.0, "1/m": 1e3, "m^-1": 1e3}.get(units)
    if scale is None:
        raise ValueError(f"unsupported extinction units '{units}'")
    return np.asarray(values, dtype=np.float64) * scale


_CANONICAL_DIMS = {
    1: ("nlam",),
    2: ("nlam", "naux"),
    3: ("nlam", "nphamat", "nthetamax"),
    4: ("nlam", "naux", "nphamat", "nthetamax"),
}


def _from_path(path):
    """Load a libRadtran NetCDF file into a mini-xr Dataset, assigning
    canonical dimension names by rank (``naux`` resolves to nhum/nreff)."""
    from .netcdf import read_netcdf

    raw = read_netcdf(path)
    aux_name = "nhum" if "hum" in raw["variables"] else "nreff"
    ds = xr.Dataset(attrs=raw["attrs"])
    for name, (values, attrs) in raw["variables"].items():
        values = np.asarray(values)
        dims = tuple(
            aux_name if d == "naux" else d
            for d in _CANONICAL_DIMS.get(values.ndim, ())
        )
        if name in ("hum", "reff"):
            dims = (aux_name,)
        ds[name] = xr.DataArray(values, dims, attrs=attrs, name=name)
    return ds


def load_aerosol_libradtran(
    data,
    particle_shape=None,
    tolerance=None,
    wbounds=(None, None),
    fallback_units=None,
    **kwargs,
):
    """Convert a libRadtran NetCDF aerosol file to the particle dataset
    format (mirror of ``data/io.py:40-270``).

    Parameters mirror the reference: ``data`` is a path or dataset;
    ``particle_shape`` in {"spherical", "spheroidal"} (inferred from the
    ``nphamat`` length when unset); ``reff`` (micrometers) / ``hum``
    (percent) keyword arguments select the coordinate point (nearest
    neighbour, optional per-key ``tolerance``); ``wbounds`` restricts the
    spectral domain (nm by default).

    Returns a dataset with ``sigma_t`` [w] (1/km), ``albedo`` [w],
    ``phase`` [w, mu, i, j].
    """
    if isinstance(data, (str,)) or hasattr(data, "__fspath__"):
        from . import resolve_data

        path = resolve_data(str(data)) or str(data)
        data = _from_path(path)

    tolerance = tolerance or {}
    kwarg_units = {"reff": "micrometer", "hum": "percent"}

    # select on humidity / effective radius (nearest neighbour): build the
    # per-dimension index, then apply it to every variable carrying the dim
    sel_idx = {}
    for var in ("hum", "reff"):
        if var not in data:
            continue
        da = data[var]
        dim = da.dims[0]
        values = np.atleast_1d(np.asarray(da.values, dtype=np.float64))
        if values.size > 1 and var not in kwargs:
            raise TypeError(
                f"load_aerosol_libradtran() is missing keyword argument "
                f"'{var}' (allowed: {values})"
            )
        if var in kwargs:
            wanted = float(
                to_quantity(kwargs.pop(var), kwarg_units[var]).m_as(
                    _get_units(data, var, fallback_units)
                )
            )
        else:
            wanted = float(values[0])
        idx = int(np.argmin(np.abs(values - wanted)))
        if var in tolerance:
            tol = float(
                to_quantity(tolerance[var], kwarg_units[var]).m_as(
                    _get_units(data, var, fallback_units)
                )
            )
            if abs(values[idx] - wanted) > tol:
                raise KeyError(
                    f"no '{var}' grid point within {tol} of {wanted} "
                    f"(nearest: {values[idx]})"
                )
        sel_idx[dim] = idx

    if kwargs:
        warnings.warn(
            "load_aerosol_libradtran() got unexpected keyword arguments "
            f"{list(kwargs.keys())}, which were not used"
        )

    def var_sel(name, **extra):
        da = data[name]
        idx = {d: i for d, i in {**sel_idx, **extra}.items() if d in da.dims}
        return da.isel(idx) if idx else da

    w_units = _get_units(data, "wavelen", fallback_units)
    w_nm = _wavelength_nm(np.asarray(data["wavelen"].values).ravel(), w_units)

    # spectral-domain restriction
    wmin, wmax = wbounds
    keep = np.ones(w_nm.shape, dtype=bool)
    if wmin is not None:
        keep &= w_nm >= float(to_quantity(wmin, "nm").m_as("nm"))
    if wmax is not None:
        keep &= w_nm <= float(to_quantity(wmax, "nm").m_as("nm"))
    lam_idx = np.flatnonzero(keep)
    w_nm = w_nm[lam_idx]

    phase_da = data["phase"]
    n_phamat = phase_da.shape[phase_da.dims.index("nphamat")]
    if particle_shape is None:
        particle_shape = {4: "spherical", 6: "spheroidal"}.get(n_phamat)
        if particle_shape is None:
            raise ValueError("Could not detect particle shape type")
    ij_to_nphamat = {
        "spherical": _SPHERICAL_NPHAMAT,
        "spheroidal": _SPHEROIDAL_NPHAMAT,
    }[particle_shape]

    # union angular grid at the highest available resolution
    theta_all = np.asarray(var_sel("theta").values, dtype=np.float64)
    mus = np.cos(np.deg2rad(theta_all.ravel()))
    mus = np.unique(mus[~np.isnan(mus)])

    phase_np = np.zeros((w_nm.size, mus.size, 4, 4))
    for out_i, i_lam in enumerate(lam_idx):
        for (i, j), nphamat in ij_to_nphamat.items():
            fp = np.asarray(
                var_sel("phase", nlam=int(i_lam), nphamat=nphamat).values,
                dtype=np.float64,
            ).ravel()
            th = np.asarray(
                var_sel("theta", nlam=int(i_lam), nphamat=nphamat).values,
                dtype=np.float64,
            ).ravel()
            n = min(th.size, fp.size)
            ok = ~np.isnan(th[:n]) & ~np.isnan(fp[:n])
            xp = np.cos(np.deg2rad(th[:n][ok]))
            fpv = fp[:n][ok]
            order = np.argsort(xp)
            phase_np[out_i, :, i, j] = np.interp(mus, xp[order], fpv[order])

    sigma_t = _ext_per_km(
        np.asarray(var_sel("ext").values, dtype=np.float64).ravel()[lam_idx],
        _get_units(data, "ext", fallback_units),
    )
    albedo = np.asarray(var_sel("ssa").values, dtype=np.float64).ravel()[lam_idx]

    out = xr.Dataset(
        coords={
            "w": w_nm,
            "mu": mus,
            "i": np.arange(4),
            "j": np.arange(4),
        },
        attrs={"source": "libradtran", "particle_shape": particle_shape},
    )
    out["sigma_t"] = xr.DataArray(sigma_t, ("w",), attrs={"units": "1/km"})
    out["albedo"] = xr.DataArray(albedo, ("w",), attrs={"units": ""})
    out["phase"] = xr.DataArray(phase_np, ("w", "mu", "i", "j"))
    return out
