# Host-code copy of eradiate_tpu/physics/zgrid.py; regenerate with tools/copy_host_code.py, do not edit.
"""Altitude grids.

Mirror of ``ZGrid`` (``src/eradiate/radprops/_core.py:166``): a regular
altitude grid defined by its *levels* (layer boundaries); layers are the
intervals between consecutive levels. All altitudes in kernel length units
[km].
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ZGrid"]


@dataclass(frozen=True)
class ZGrid:
    """A 1D altitude grid (levels in km, ascending)."""

    levels: np.ndarray = field()

    def __post_init__(self):
        levels = np.atleast_1d(np.asarray(self.levels, dtype=np.float64))
        if levels.ndim != 1 or levels.size < 2:
            raise ValueError("ZGrid requires at least 2 levels")
        if not np.all(np.diff(levels) > 0):
            raise ValueError("ZGrid levels must be strictly increasing")
        object.__setattr__(self, "levels", levels)

    @classmethod
    def regular(cls, bottom_km: float, top_km: float, step_km: float = 0.1) -> "ZGrid":
        """Regular grid with the reference's default 100 m step
        (``scenes/geometry.py:22-97``)."""
        n = int(round((top_km - bottom_km) / step_km))
        return cls(np.linspace(bottom_km, top_km, n + 1))

    @property
    def bottom(self) -> float:
        return float(self.levels[0])

    @property
    def top(self) -> float:
        return float(self.levels[-1])

    @property
    def n_layers(self) -> int:
        return self.levels.size - 1

    @property
    def n_levels(self) -> int:
        return self.levels.size

    @property
    def layers(self) -> np.ndarray:
        """Layer midpoint altitudes [km]."""
        return 0.5 * (self.levels[1:] + self.levels[:-1])

    @property
    def layer_height(self) -> np.ndarray:
        """Layer thicknesses [km]."""
        return np.diff(self.levels)

    @property
    def total_height(self) -> float:
        return float(self.levels[-1] - self.levels[0])

    def __eq__(self, other):
        return isinstance(other, ZGrid) and np.array_equal(self.levels, other.levels)

    def __hash__(self):
        return hash(self.levels.tobytes())
