# Host-code copy of eradiate_tpu/scenes/spectra/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Spectra: spectrally-dependent scene parameters.

Mirror of ``src/eradiate/scenes/spectra/`` (uniform, interpolated,
solar_irradiance, air_scattering_coefficient, multi_delta). A Spectrum
evaluates to kernel-unit values on a batch of wavelengths; CKD evaluation
uses bin-center wavelengths (the g dependence lives in the absorption data,
not in scene spectra).
"""

from __future__ import annotations

import attrs
import numpy as np

from ...core.units import to_quantity
from ..core import Factory, SceneElement

__all__ = [
    "Spectrum",
    "UniformSpectrum",
    "InterpolatedSpectrum",
    "SolarIrradianceSpectrum",
    "AirScatteringCoefficientSpectrum",
    "MultiDeltaSpectrum",
    "spectrum_factory",
    "converter",
]

spectrum_factory = Factory("spectrum")

#: kernel units per physical quantity (reference: ``unit_context_kernel``)
_KERNEL_UNITS = {
    "dimensionless": "dimensionless",
    "reflectance": "dimensionless",
    "transmittance": "dimensionless",
    "albedo": "dimensionless",
    "angle": "rad",
    "collision_coefficient": "km^-1",
    "irradiance": "W/m^2/nm",
    "radiance": "W/m^2/sr/nm",
    # point-source intensity; the engine's r^2 falloff applies the
    # km^2 -> m^2 factor when converting to kernel irradiance
    "intensity": "W/sr/nm",
    "wavelength": "nm",
    "length": "km",
}


@attrs.define(eq=False, slots=False)
class Spectrum(SceneElement):
    """Base spectrum; subclasses implement ``eval(w_nm) -> np.ndarray``."""

    quantity: str = attrs.field(default="dimensionless", kw_only=True)

    def eval(self, w_nm) -> np.ndarray:
        raise NotImplementedError

    @property
    def kernel_units(self) -> str:
        return _KERNEL_UNITS.get(self.quantity, "dimensionless")


@spectrum_factory.register("uniform")
@attrs.define(eq=False, slots=False)
class UniformSpectrum(Spectrum):
    """Wavelength-independent value (``scenes/spectra/_uniform.py:18``)."""

    value: float = 1.0

    def __attrs_post_init__(self):
        q = to_quantity(self.value, self.kernel_units)
        self.value = float(np.asarray(q.m_as(self.kernel_units)))

    def eval(self, w_nm) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return np.full(w.shape, self.value)


@spectrum_factory.register("interpolated")
@attrs.define(eq=False, slots=False)
class InterpolatedSpectrum(Spectrum):
    """Linearly interpolated tabulated spectrum
    (``scenes/spectra/_interpolated.py:22``)."""

    wavelengths: np.ndarray = attrs.field(default=None)
    values: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        wq = to_quantity(self.wavelengths, "nm")
        vq = to_quantity(self.values, self.kernel_units)
        w = np.atleast_1d(np.asarray(wq.m_as("nm"), dtype=np.float64))
        v = np.atleast_1d(np.asarray(vq.m_as(self.kernel_units), dtype=np.float64))
        order = np.argsort(w)
        self.wavelengths = w[order]
        self.values = v[order]

    def eval(self, w_nm) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return np.interp(w, self.wavelengths, self.values, left=0.0, right=0.0)


@spectrum_factory.register("multi_delta")
@attrs.define(eq=False, slots=False)
class MultiDeltaSpectrum(Spectrum):
    """Delta spikes at given wavelengths; used as SRF stand-in
    (``scenes/spectra/_core.py``)."""

    wavelengths: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        wq = to_quantity(self.wavelengths, "nm")
        self.wavelengths = np.sort(
            np.atleast_1d(np.asarray(wq.m_as("nm"), dtype=np.float64))
        )

    def eval(self, w_nm) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return np.where(np.isin(w, self.wavelengths), 1.0, 0.0)


# Planck constants for the analytic solar fallback
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23
_T_SUN = 5772.0
_SOLAR_SCALE_GEOM = 2.1636e-5  # (R_sun / 1 AU)^2


@spectrum_factory.register("solar_irradiance")
@attrs.define(eq=False, slots=False)
class SolarIrradianceSpectrum(Spectrum):
    """Solar irradiance spectrum (``scenes/spectra/_solar_irradiance.py:73``).

    ``dataset``: id resolved through the data store (``solar/<id>.npz`` with
    ``w`` [nm], ``ssi`` [W/m^2/nm]; import reference NetCDF datasets with
    :func:`eradiate_tpu.data.netcdf.load_solar_netcdf`). Packaged defaults:
    ``coarse_am0`` (default) — a real AM0-shaped anchor table normalized to
    TSI 1361 W/m^2 (:mod:`eradiate_tpu.physics.solar_data`); and
    ``blackbody_sun`` — the Planck 5772 K analytic fallback. BRF-like
    outputs are irradiance-normalized, so the choice only affects absolute
    radiance products.
    ``scale``: multiplicative factor; ``datetime`` adjusts the Earth-Sun
    distance seasonally.
    """

    dataset: str = "fine_am0"
    scale: float = 1.0
    datetime: str | None = None

    quantity: str = attrs.field(default="irradiance", kw_only=True)
    _table: tuple | None = attrs.field(default=None, init=False, repr=False)

    def __attrs_post_init__(self):
        from ...data import resolve_data

        path = resolve_data(f"solar/{self.dataset}.npz")
        if path is not None:
            d = np.load(path)
            self._table = (d["w"], d["ssi"])
        elif self.dataset == "fine_am0":
            # default: the band-anchored fine table (Sentinel-2A band
            # irradiances reproduced to <0.3%; see physics.solar_data)
            from ...physics.solar_data import FINE_AM0_SSI, FINE_AM0_W_NM

            self._table = (FINE_AM0_W_NM, FINE_AM0_SSI)
        elif self.dataset == "coarse_am0":
            from ...physics.solar_data import COARSE_AM0_SSI, COARSE_AM0_W_NM

            self._table = (COARSE_AM0_W_NM, COARSE_AM0_SSI)
        elif self.dataset != "blackbody_sun":
            raise FileNotFoundError(
                f"solar irradiance dataset '{self.dataset}' not found on the "
                f"data path; install solar/{self.dataset}.npz (e.g. import a "
                f"reference NetCDF with data.netcdf.load_solar_netcdf) or "
                f"use 'fine_am0' / 'coarse_am0' / 'blackbody_sun'"
            )

    def _distance_factor(self) -> float:
        if self.datetime is None:
            return 1.0
        # Earth-Sun distance correction: (d/AU)^-2 ~ 1 + 0.0334 cos(2 pi (doy - 3)/365)
        import datetime as _dt

        doy = _dt.datetime.fromisoformat(self.datetime).timetuple().tm_yday
        return 1.0 + 0.0334 * np.cos(2.0 * np.pi * (doy - 3) / 365.25)

    def eval(self, w_nm) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        if self._table is not None:
            val = np.interp(w, self._table[0], self._table[1], left=0.0, right=0.0)
        else:
            lam = w * 1e-9
            b = (
                2.0 * _H * _C**2 / lam**5
                / np.expm1(_H * _C / (lam * _KB * _T_SUN))
            )  # W / m^3 / sr
            val = np.pi * b * _SOLAR_SCALE_GEOM * 1e-9  # -> W/m^2/nm
        return val * self.scale * self._distance_factor()


@spectrum_factory.register("air_scattering_coefficient")
@attrs.define(eq=False, slots=False)
class AirScatteringCoefficientSpectrum(Spectrum):
    """Rayleigh sigma_s of standard air
    (``scenes/spectra/_air_scattering_coefficient.py``)."""

    quantity: str = attrs.field(default="collision_coefficient", kw_only=True)

    def eval(self, w_nm) -> np.ndarray:
        from ...physics.rayleigh import compute_sigma_s_air

        return np.atleast_1d(
            compute_sigma_s_air(np.asarray(w_nm, dtype=np.float64))
        )


def converter(quantity: str):
    """Field converter: number -> UniformSpectrum, dict -> factory, spectrum
    passthrough (mirror of ``SpectrumFactory.converter``,
    ``scenes/spectra/_core.py:21-111``)."""

    def _convert(value):
        if isinstance(value, Spectrum):
            return value
        if isinstance(value, dict):
            d = dict(value)
            d.setdefault("quantity", quantity)
            return spectrum_factory.convert(d)
        if isinstance(value, (int, float)) or hasattr(value, "units"):
            return UniformSpectrum(value=value, quantity=quantity)
        if isinstance(value, (list, tuple, np.ndarray)):
            raise ValueError(
                "array spectra must be given as "
                "{'type': 'interpolated', 'wavelengths': ..., 'values': ...}"
            )
        raise TypeError(f"cannot convert {type(value)} to Spectrum")

    return _convert
