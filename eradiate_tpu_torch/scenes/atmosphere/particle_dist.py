# Host-code copy of eradiate_tpu/scenes/atmosphere/particle_dist.py; regenerate with tools/copy_host_code.py, do not edit.
"""Particle vertical distributions.

Mirror of ``src/eradiate/scenes/atmosphere/_particle_dist.py``: normalized
shape functions f(x) on the unit interval x in [0, 1] mapping
[bottom, top] -> [0, 1].
"""

from __future__ import annotations

import attrs
import numpy as np

from ..core import Factory

__all__ = [
    "ParticleDistribution",
    "UniformParticleDistribution",
    "ExponentialParticleDistribution",
    "GaussianParticleDistribution",
    "ArrayParticleDistribution",
    "particle_distribution_factory",
]

particle_distribution_factory = Factory("particle_distribution")


@attrs.define(eq=False, slots=False)
class ParticleDistribution:
    def eval_fraction(self, x: np.ndarray) -> np.ndarray:
        """Unnormalized shape on x in [0, 1] (layer calibration renormalizes)."""
        raise NotImplementedError


@particle_distribution_factory.register("uniform")
@attrs.define(eq=False, slots=False)
class UniformParticleDistribution(ParticleDistribution):
    """Uniform (``_particle_dist.py:54``)."""

    def eval_fraction(self, x):
        return np.ones_like(np.asarray(x, dtype=np.float64))


@particle_distribution_factory.register("exponential")
@attrs.define(eq=False, slots=False)
class ExponentialParticleDistribution(ParticleDistribution):
    """Exponential decay from the bottom (``_particle_dist.py:104``)."""

    rate: float = 5.0

    def eval_fraction(self, x):
        return np.exp(-self.rate * np.asarray(x, dtype=np.float64))


@particle_distribution_factory.register("gaussian")
@attrs.define(eq=False, slots=False)
class GaussianParticleDistribution(ParticleDistribution):
    """Gaussian bump (``_particle_dist.py:161``)."""

    mean: float = 0.5
    std: float = 0.25

    def eval_fraction(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.exp(-0.5 * ((x - self.mean) / self.std) ** 2)


@particle_distribution_factory.register("array")
@attrs.define(eq=False, slots=False)
class ArrayParticleDistribution(ParticleDistribution):
    """Tabulated shape (``_particle_dist.py:206``)."""

    values: np.ndarray = attrs.field(default=None)
    coords: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        self.values = np.atleast_1d(np.asarray(self.values, dtype=np.float64))
        if self.coords is None:
            self.coords = np.linspace(0.0, 1.0, self.values.size)
        else:
            self.coords = np.asarray(self.coords, dtype=np.float64)

    def eval_fraction(self, x):
        return np.interp(np.asarray(x, dtype=np.float64), self.coords, self.values)
