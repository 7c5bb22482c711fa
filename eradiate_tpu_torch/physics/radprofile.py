# Host-code copy of eradiate_tpu/physics/radprofile.py; regenerate with tools/copy_host_code.py, do not edit.
"""Radiative property profiles.

Mirror of ``src/eradiate/radprops/_core.py`` / ``_atmosphere.py`` /
``_array.py``: a RadProfile evaluates collision coefficients on a
:class:`~eradiate_tpu.physics.zgrid.ZGrid` for a batch of spectral indices.

TPU-first difference: evaluation is *batched over the spectral axis* — every
``eval_*`` takes a wavelength array ``w_nm`` of shape (S,) and returns
(S, Nz) arrays, ready to be fed to the device-resident spectral loop
(the reference evaluates one spectral index at a time inside its serial
Python loop, ``kernel/_render.py:433-468``).

Units: wavelengths nm, sigma km^-1, altitudes km.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .rayleigh import compute_sigma_s_air, depolarization_bates, depolarization_bodhaine
from .thermoprops import ThermoProfile, make_profile
from .zgrid import ZGrid

__all__ = ["RadProfile", "AtmosphereRadProfile", "ArrayRadProfile"]


class RadProfile:
    """Base interface for radiative property profiles."""

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        raise NotImplementedError

    def eval_sigma_a(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        raise NotImplementedError

    def eval_sigma_t(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self.eval_sigma_s(w_nm, zgrid) + self.eval_sigma_a(w_nm, zgrid)

    def eval_albedo(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        sigma_s = self.eval_sigma_s(w_nm, zgrid)
        sigma_t = sigma_s + self.eval_sigma_a(w_nm, zgrid)
        return np.where(sigma_t > 0.0, sigma_s / np.where(sigma_t > 0, sigma_t, 1.0), 1.0)

    def eval_depolarization(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        """Rayleigh depolarization factor per (S, Nz); default 0."""
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return np.zeros((w.size, zgrid.n_layers))


@dataclass
class AtmosphereRadProfile(RadProfile):
    """Molecular atmosphere radiative properties.

    Mirror of ``radprops/_atmosphere.py:31``: Rayleigh scattering computed
    from air number density; absorption interpolated from an absorption
    database at the layer (p, T, x) state.
    """

    thermoprops: ThermoProfile | str = "afgl_1986-us_standard"
    absorption_data: object | None = None  # AbsorptionDatabase or None
    has_scattering: bool = True
    has_absorption: bool = True
    #: 'bates' | 'bodhaine' | scalar | array of shape (Nz,)
    rayleigh_depolarization: object = "bates"

    def __post_init__(self):
        if not isinstance(self.thermoprops, ThermoProfile):
            self.thermoprops = make_profile(self.thermoprops)
        self._interp_cache: dict = {}

    def _layers(self, zgrid: ZGrid) -> ThermoProfile:
        key = hash(zgrid)
        if key not in self._interp_cache:
            # Evaluate the thermophysical state at layer midpoints
            self._interp_cache[key] = self.thermoprops.interp(zgrid.layers)
        return self._interp_cache[key]

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        if not self.has_scattering:
            return np.zeros((w.size, zgrid.n_layers))
        tp = self._layers(zgrid)
        # (S, 1) x (1, Nz) broadcast
        return compute_sigma_s_air(w[:, None], tp.n[None, :])

    def eval_sigma_a(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        if not self.has_absorption or self.absorption_data is None:
            return np.zeros((w.size, zgrid.n_layers))
        tp = self._layers(zgrid)
        return self.absorption_data.eval_sigma_a(w, tp)

    def eval_depolarization(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        nz = zgrid.n_layers
        mode = self.rayleigh_depolarization
        if isinstance(mode, str):
            if mode == "bates":
                rho = depolarization_bates(w)  # (S,)
                return np.broadcast_to(rho[:, None], (w.size, nz)).copy()
            if mode == "bodhaine":
                tp = self._layers(zgrid)
                x_co2 = tp.x.get("CO2", np.full(nz, 0.000330))
                return depolarization_bodhaine(w[:, None], x_co2[None, :])
            raise ValueError(f"unknown depolarization model '{mode}'")
        arr = np.atleast_1d(np.asarray(mode, dtype=np.float64))
        if arr.size == 1:
            return np.full((w.size, nz), float(arr.reshape(())))
        if arr.size != nz:
            raise ValueError(
                f"depolarization array has size {arr.size}, expected {nz}"
            )
        return np.broadcast_to(arr[None, :], (w.size, nz)).copy()


@dataclass
class ArrayRadProfile(RadProfile):
    """User-provided collision-coefficient profiles.

    Mirror of ``radprops/_array.py:22``: wavelength-indexed tables of
    sigma_t / albedo on a fixed altitude grid; nearest/linear interpolation
    in wavelength, linear in altitude.
    """

    w_nm: np.ndarray
    sigma_t: np.ndarray  # (W, Nz_src)
    albedo: np.ndarray  # (W, Nz_src)
    z_levels_km: np.ndarray  # (Nz_src + 1,)

    def __post_init__(self):
        self.w_nm = np.atleast_1d(np.asarray(self.w_nm, dtype=np.float64))
        self.sigma_t = np.atleast_2d(np.asarray(self.sigma_t, dtype=np.float64))
        self.albedo = np.atleast_2d(np.asarray(self.albedo, dtype=np.float64))
        self.z_levels_km = np.asarray(self.z_levels_km, dtype=np.float64)

    def _interp_w(self, table, w) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w, dtype=np.float64))
        out = np.empty((w.size, table.shape[1]))
        for j in range(table.shape[1]):
            out[:, j] = np.interp(w, self.w_nm, table[:, j])
        return out

    def _regrid(self, values, zgrid: ZGrid) -> np.ndarray:
        """Piecewise-constant source layers resampled onto target layers."""
        src_mid = 0.5 * (self.z_levels_km[1:] + self.z_levels_km[:-1])
        tgt = zgrid.layers
        idx = np.clip(
            np.searchsorted(self.z_levels_km, tgt, side="right") - 1,
            0,
            src_mid.size - 1,
        )
        inside = (tgt >= self.z_levels_km[0]) & (tgt <= self.z_levels_km[-1])
        out = values[:, idx]
        out[:, ~inside] = 0.0
        return out

    def eval_sigma_t(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self._regrid(self._interp_w(self.sigma_t, w_nm), zgrid)

    def eval_albedo(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self._regrid(self._interp_w(self.albedo, w_nm), zgrid)

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self.eval_sigma_t(w_nm, zgrid) * self.eval_albedo(w_nm, zgrid)

    def eval_sigma_a(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self.eval_sigma_t(w_nm, zgrid) * (1.0 - self.eval_albedo(w_nm, zgrid))
