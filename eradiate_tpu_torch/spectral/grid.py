# Host-code copy of eradiate_tpu/spectral/grid.py; regenerate with tools/copy_host_code.py, do not edit.
"""Spectral grids.

Mirror of ``src/eradiate/spectral/grid.py``: a spectral grid holds the
spectral discretization driven by the operational mode —

- :class:`MonoSpectralGrid`: a set of wavelengths (``grid.py:160``);
- :class:`CKDSpectralGrid`: a set of bins (wmin/wmax/wcenter) each carrying a
  g-point quadrature (``grid.py:324``).

``select`` restricts the grid to an SRF's support; ``walk_indices`` yields
the full list of spectral indexes, which the TPU spectral loop batches
into device-resident arrays (unlike the reference's serial context loop).
Wavelengths in nm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.quad import Quad
from .ckd_quad import CKDQuadConfig
from .index import CKDSpectralIndex, MonoSpectralIndex, SpectralIndex
from .response import BandSRF, DeltaSRF, SpectralResponseFunction, UniformSRF

__all__ = ["SpectralGrid", "MonoSpectralGrid", "CKDSpectralGrid"]


class SpectralGrid:
    """Base spectral grid (mirror of ``grid.py:33``)."""

    @staticmethod
    def default() -> "SpectralGrid":
        from ..core.modes import mode

        if mode().is_mono:
            return MonoSpectralGrid.default()
        return CKDSpectralGrid.default()

    @staticmethod
    def arange(start_nm, stop_nm, step_nm) -> "SpectralGrid":
        from ..core.modes import mode

        if mode().is_mono:
            return MonoSpectralGrid(np.arange(start_nm, stop_nm, step_nm))
        return CKDSpectralGrid.arange(start_nm, stop_nm, step_nm)

    def select(self, srf) -> "SpectralGrid":
        raise NotImplementedError

    def walk_indices(self, **kwargs):
        raise NotImplementedError


@dataclass(frozen=True)
class MonoSpectralGrid(SpectralGrid):
    """Monochromatic grid: a sorted set of wavelengths [nm]."""

    wavelengths: np.ndarray

    def __post_init__(self):
        w = np.unique(np.atleast_1d(np.asarray(self.wavelengths, dtype=np.float64)))
        object.__setattr__(self, "wavelengths", w)

    @classmethod
    def default(cls) -> "MonoSpectralGrid":
        # Reference default: the absorption DB coverage; without a DB we use
        # a single 550 nm point (the measure SRF drives the real selection).
        return cls(np.array([550.0]))

    def select(self, srf: SpectralResponseFunction) -> "MonoSpectralGrid":
        """Restrict to the SRF support (mirror of ``grid.py:96-121``)."""
        if isinstance(srf, DeltaSRF):
            # The delta SRF *defines* the grid points.
            return MonoSpectralGrid(srf.wavelengths)
        lo, hi = srf.support
        w = self.wavelengths
        sel = w[(w >= lo) & (w <= hi)]
        if isinstance(srf, BandSRF):
            sel = sel[srf.eval(sel) > 0.0] if sel.size else sel
        if sel.size == 0:
            raise ValueError(
                f"SRF support [{lo}, {hi}] nm does not intersect spectral grid"
            )
        return MonoSpectralGrid(sel)

    def merge(self, other: "MonoSpectralGrid") -> "MonoSpectralGrid":
        return MonoSpectralGrid(np.union1d(self.wavelengths, other.wavelengths))

    def walk_indices(self, **kwargs):
        for w in self.wavelengths:
            yield MonoSpectralIndex(w=float(w))

    def __len__(self):
        return self.wavelengths.size


@dataclass(frozen=True)
class CKDSpectralGrid(SpectralGrid):
    """CKD grid: bins with bounds and per-bin quadratures."""

    wmins: np.ndarray
    wmaxs: np.ndarray
    wcenters: np.ndarray = None
    quads: tuple = field(default=None)  # per-bin Quad; filled by walk_quads

    def __post_init__(self):
        wmins = np.atleast_1d(np.asarray(self.wmins, dtype=np.float64))
        wmaxs = np.atleast_1d(np.asarray(self.wmaxs, dtype=np.float64))
        if self.wcenters is None:
            wcenters = 0.5 * (wmins + wmaxs)
        else:
            wcenters = np.atleast_1d(np.asarray(self.wcenters, dtype=np.float64))
        order = np.argsort(wcenters)
        object.__setattr__(self, "wmins", wmins[order])
        object.__setattr__(self, "wmaxs", wmaxs[order])
        object.__setattr__(self, "wcenters", wcenters[order])
        if self.quads is not None and len(self.quads) == wcenters.size:
            object.__setattr__(
                self, "quads", tuple(self.quads[i] for i in order)
            )

    @classmethod
    def arange(cls, start_nm, stop_nm, step_nm) -> "CKDSpectralGrid":
        edges = np.arange(start_nm, stop_nm + 0.5 * step_nm, step_nm)
        return cls(edges[:-1], edges[1:])

    @classmethod
    def default(cls) -> "CKDSpectralGrid":
        # 10 nm bins over the solar reflective range [250, 3125] nm
        # (reference spectral range, ``constants.py``).
        return cls.arange(250.0, 3130.0, 10.0)

    def __len__(self):
        return self.wcenters.size

    def select(self, srf) -> "CKDSpectralGrid":
        """Restrict bins to those covering the SRF (``grid.py:548-595``)."""
        if isinstance(srf, DeltaSRF):
            # Select bins containing each delta wavelength
            mask = np.zeros(len(self), dtype=bool)
            for w in srf.wavelengths:
                hit = (self.wmins <= w) & (w < self.wmaxs)
                if not hit.any():
                    # fall back: closest bin
                    hit = np.zeros_like(mask)
                    hit[np.argmin(np.abs(self.wcenters - w))] = True
                mask |= hit
        elif isinstance(srf, UniformSRF):
            mask = (self.wmaxs > srf.wmin) & (self.wmins < srf.wmax)
        elif isinstance(srf, BandSRF):
            lo, hi = srf.support
            mask = (self.wmaxs > lo) & (self.wmins < hi)
            # drop bins where the SRF integrates to zero
            for i in np.nonzero(mask)[0]:
                if srf.integrate(self.wmins[i], self.wmaxs[i]) <= 0.0:
                    mask[i] = False
        else:
            raise ValueError(f"unsupported SRF type {type(srf).__name__}")
        if not mask.any():
            raise ValueError("SRF does not intersect CKD spectral grid")
        quads = (
            tuple(q for q, m in zip(self.quads, mask) if m)
            if self.quads is not None
            else None
        )
        return CKDSpectralGrid(
            self.wmins[mask], self.wmaxs[mask], self.wcenters[mask], quads
        )

    def merge(self, other: "CKDSpectralGrid") -> "CKDSpectralGrid":
        """Union of bins, deduplicated by center (``grid.py:597``)."""
        wc = np.concatenate([self.wcenters, other.wcenters])
        wmin = np.concatenate([self.wmins, other.wmins])
        wmax = np.concatenate([self.wmaxs, other.wmaxs])
        _, idx = np.unique(wc, return_index=True)
        return CKDSpectralGrid(wmin[idx], wmax[idx], wc[idx])

    def walk_quads(self, ckd_quad_config=None, abs_db=None) -> "CKDSpectralGrid":
        """Attach a per-bin quadrature (mirror of ``grid.py:618-656``)."""
        cfg = CKDQuadConfig.convert(ckd_quad_config or CKDQuadConfig())
        quads = []
        for i in range(len(self)):
            error_data = None
            if abs_db is not None and hasattr(abs_db, "error_data"):
                error_data = abs_db.error_data(self.wcenters[i])
            quads.append(cfg.get_quad(error_data))
        return CKDSpectralGrid(self.wmins, self.wmaxs, self.wcenters, tuple(quads))

    def quad_for_bin(self, i: int) -> Quad:
        if self.quads is not None:
            return self.quads[i]
        return CKDQuadConfig().get_quad()

    def walk_indices(self, **kwargs):
        for i in range(len(self)):
            quad = self.quad_for_bin(i)
            for g in quad.eval_nodes((0.0, 1.0)):
                yield CKDSpectralIndex(w=float(self.wcenters[i]), g=float(g))
