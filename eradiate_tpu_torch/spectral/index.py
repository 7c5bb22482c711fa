# Host-code copy of eradiate_tpu/spectral/index.py; regenerate with tools/copy_host_code.py, do not edit.
"""Spectral indexes.

Mirror of ``src/eradiate/spectral/index.py``: a spectral index identifies a
single spectral evaluation point — a wavelength for mono modes, a
(bin center wavelength, g quadrature node) pair for CKD modes. Hashable; used
as result keys. Wavelengths in nm.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SpectralIndex", "MonoSpectralIndex", "CKDSpectralIndex"]


class SpectralIndex:
    """Base spectral index (mirror of ``index.py:45``)."""

    @staticmethod
    def new(**kwargs) -> "SpectralIndex":
        from ..core.modes import mode

        if mode().is_mono:
            return MonoSpectralIndex(**kwargs)
        return CKDSpectralIndex(**kwargs)

    @property
    def as_hashable(self):
        raise NotImplementedError


@dataclass(frozen=True)
class MonoSpectralIndex(SpectralIndex):
    """Monochromatic index: a single wavelength [nm] (``index.py:127``)."""

    w: float = 550.0

    @property
    def as_hashable(self) -> float:
        return float(self.w)

    @property
    def formatted_repr(self) -> str:
        return f"{self.w:g} nm"


@dataclass(frozen=True)
class CKDSpectralIndex(SpectralIndex):
    """CKD index: bin center wavelength [nm] + g node in [0, 1]
    (``index.py:167``)."""

    w: float = 550.0
    g: float = 0.0

    @property
    def as_hashable(self) -> tuple[float, float]:
        return (float(self.w), float(self.g))

    @property
    def formatted_repr(self) -> str:
        return f"{self.w:g} nm, g={self.g:g}"
