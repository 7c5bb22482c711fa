# Host-code copy of eradiate_tpu/spectral/response.py; regenerate with tools/copy_host_code.py, do not edit.
"""Spectral response functions (SRFs).

Mirror of ``src/eradiate/spectral/response.py``: Uniform, Delta and Band
SRFs select the spectral points at which a measure is evaluated and weight
the band aggregation in post-processing. Wavelengths in nm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["SpectralResponseFunction", "UniformSRF", "DeltaSRF", "BandSRF", "make_gaussian_srf", "srf_converter"]


class SpectralResponseFunction:
    """Base SRF interface."""

    def eval(self, w_nm) -> np.ndarray:
        raise NotImplementedError

    @property
    def support(self) -> tuple[float, float]:
        raise NotImplementedError


@dataclass(frozen=True)
class UniformSRF(SpectralResponseFunction):
    """Uniform response over [wmin, wmax] (mirror of ``response.py:120``)."""

    wmin: float = 300.0
    wmax: float = 2500.0
    value: float = 1.0

    def eval(self, w_nm) -> np.ndarray:
        w = np.asarray(w_nm, dtype=np.float64)
        return np.where((w >= self.wmin) & (w <= self.wmax), self.value, 0.0)

    @property
    def support(self):
        return (self.wmin, self.wmax)


@dataclass(frozen=True)
class DeltaSRF(SpectralResponseFunction):
    """Delta response at discrete wavelengths (mirror of the reference's
    ``DeltaSRF``; the default measure SRF is DeltaSRF at 550 nm,
    ``scenes/measure/_core.py``)."""

    wavelengths: np.ndarray = field(default_factory=lambda: np.array([550.0]))

    def __post_init__(self):
        object.__setattr__(
            self,
            "wavelengths",
            np.sort(np.atleast_1d(np.asarray(self.wavelengths, dtype=np.float64))),
        )

    def eval(self, w_nm) -> np.ndarray:
        # Delta SRFs have measure-zero support; eval is not meaningful.
        w = np.asarray(w_nm, dtype=np.float64)
        return np.where(np.isin(w, self.wavelengths), 1.0, 0.0)

    @property
    def support(self):
        return (float(self.wavelengths[0]), float(self.wavelengths[-1]))

    def __eq__(self, other):
        return isinstance(other, DeltaSRF) and np.array_equal(
            self.wavelengths, other.wavelengths
        )

    def __hash__(self):
        return hash(self.wavelengths.tobytes())


@dataclass(frozen=True)
class BandSRF(SpectralResponseFunction):
    """Tabulated band response (mirror of ``BandSRF``, ``response.py``).

    ``w`` and ``srf`` are matching 1D arrays; linear interpolation in
    between, zero outside.
    """

    w: np.ndarray
    srf: np.ndarray
    id: str | None = None

    def __post_init__(self):
        w = np.atleast_1d(np.asarray(self.w, dtype=np.float64))
        v = np.atleast_1d(np.asarray(self.srf, dtype=np.float64))
        if w.shape != v.shape:
            raise ValueError("w and srf must have identical shapes")
        order = np.argsort(w)
        object.__setattr__(self, "w", w[order])
        object.__setattr__(self, "srf", v[order])

    def eval(self, w_nm) -> np.ndarray:
        return np.interp(np.asarray(w_nm, dtype=np.float64), self.w, self.srf, left=0.0, right=0.0)

    def integrate(self, wmin=None, wmax=None) -> float:
        """Integral of the SRF over [wmin, wmax] (trapezoidal on the union
        grid, mirror of ``BandSRF.integrate``)."""
        wmin = self.w[0] if wmin is None else wmin
        wmax = self.w[-1] if wmax is None else wmax
        grid = np.union1d(self.w, [wmin, wmax])
        grid = grid[(grid >= wmin) & (grid <= wmax)]
        if grid.size < 2:
            return 0.0
        return float(np.trapezoid(self.eval(grid), grid))

    def integrate_cumulative(self, w_nm) -> np.ndarray:
        w = np.asarray(w_nm, dtype=np.float64)
        v = self.eval(w)
        return np.concatenate([[0.0], np.cumsum(0.5 * (v[1:] + v[:-1]) * np.diff(w))])

    @property
    def support(self):
        nz = np.nonzero(self.srf > 0.0)[0]
        if nz.size == 0:
            return (float(self.w[0]), float(self.w[-1]))
        lo = max(0, nz[0] - 1)
        hi = min(self.w.size - 1, nz[-1] + 1)
        return (float(self.w[lo]), float(self.w[hi]))

    def __eq__(self, other):
        return (
            isinstance(other, BandSRF)
            and np.array_equal(self.w, other.w)
            and np.array_equal(self.srf, other.srf)
        )

    def __hash__(self):
        return hash((self.w.tobytes(), self.srf.tobytes()))


def make_gaussian_srf(wl_center_nm: float, fwhm_nm: float, pad: bool = True, cutoff: float = 3.0, n: int = 81) -> BandSRF:
    """Gaussian band SRF (mirror of ``srf_tools.make_gaussian``,
    ``src/eradiate/srf_tools.py:1003``)."""
    sigma = fwhm_nm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    half = cutoff * sigma
    w = np.linspace(wl_center_nm - half, wl_center_nm + half, n)
    v = np.exp(-0.5 * ((w - wl_center_nm) / sigma) ** 2)
    if pad:
        w = np.concatenate([[w[0] - (w[1] - w[0])], w, [w[-1] + (w[1] - w[0])]])
        v = np.concatenate([[0.0], v, [0.0]])
    return BandSRF(w, v, id=f"gaussian-{wl_center_nm}-{fwhm_nm}")


def srf_converter(value) -> SpectralResponseFunction:
    """Convert a user value to an SRF (mirror of ``response.py:37-98``).

    Accepts SRF instances, dicts with a ``type`` key, scalars/arrays
    (-> DeltaSRF), and dataset-id strings (resolved via the data store).
    """
    if isinstance(value, SpectralResponseFunction):
        return value
    if isinstance(value, dict):
        d = dict(value)
        t = d.pop("type", "delta")
        if t in ("uniform",):
            return UniformSRF(**d)
        if t in ("delta", "multi_delta"):
            return DeltaSRF(**d)
        if t in ("band",):
            return BandSRF(**d)
        raise ValueError(f"unknown SRF type '{t}'")
    if isinstance(value, str):
        from ..data import load_srf

        return load_srf(value)
    # scalar / array -> delta
    return DeltaSRF(np.atleast_1d(np.asarray(value, dtype=np.float64)))
