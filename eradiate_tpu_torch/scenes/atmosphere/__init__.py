# Host-code copy of eradiate_tpu/scenes/atmosphere/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Atmosphere scene elements.

Mirror of ``src/eradiate/scenes/atmosphere/`` (factory at
``_core.py:38-63``): homogeneous / molecular / particle-layer /
heterogeneous atmospheres. An atmosphere compiles — batched over the
spectral axis — to the layered-medium arrays consumed by the engine
(sigma_t, albedo, blended phase), the functional replacement for the
reference's gridvolume + medium + phase kernel-dict expansion
(``scenes/atmosphere/_core.py:643-810``).
"""

from __future__ import annotations

import attrs
import numpy as np

from ...core.units import to_quantity
from ...physics.radprofile import AtmosphereRadProfile
from ...physics.zgrid import ZGrid
from ..core import Factory, SceneElement
from ..phase import (
    BlendPhaseFunction,
    PhaseFunction,
    RayleighPhaseFunction,
    TabulatedPhaseFunction,
    phase_function_factory,
)
from ..spectra import Spectrum, converter as spectrum_converter
from .particle_dist import ParticleDistribution, particle_distribution_factory

__all__ = [
    "Atmosphere",
    "HomogeneousAtmosphere",
    "MolecularAtmosphere",
    "ParticleLayer",
    "HeterogeneousAtmosphere",
    "atmosphere_factory",
]

atmosphere_factory = Factory("atmosphere")


@attrs.define(eq=False, slots=False)
class Atmosphere(SceneElement):
    """Base atmosphere (``scenes/atmosphere/_core.py:66``)."""

    scale: float | None = None

    def eval_sigma_t(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        raise NotImplementedError

    def eval_albedo(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        raise NotImplementedError

    def eval_phase(self, w_nm, zgrid: ZGrid):
        """Return (kinds, params_tuple, weights [S, C, L])."""
        raise NotImplementedError

    def eval_transmittance(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        """Vertical transmittance per spectral index
        (mirror of ``_core.py:592-637``)."""
        sig = self.eval_sigma_t(w_nm, g, zgrid)
        return np.exp(-np.sum(sig * zgrid.layer_height, axis=-1))

    def _apply_scale(self, sigma):
        return sigma if self.scale is None else sigma * self.scale


@atmosphere_factory.register("homogeneous")
@attrs.define(eq=False, slots=False)
class HomogeneousAtmosphere(Atmosphere):
    """Uniform-property atmosphere
    (``scenes/atmosphere/_homogeneous.py``)."""

    bottom: float = 0.0  # km
    top: float = 10.0  # km
    sigma_s: Spectrum = attrs.field(
        default=None,
        converter=attrs.converters.optional(
            spectrum_converter("collision_coefficient")
        ),
    )
    sigma_a: Spectrum = attrs.field(
        default=0.0, converter=spectrum_converter("collision_coefficient")
    )
    phase: PhaseFunction = attrs.field(
        factory=RayleighPhaseFunction,
        converter=lambda v: phase_function_factory.convert(v, PhaseFunction),
    )

    def __attrs_post_init__(self):
        self.bottom = float(np.asarray(to_quantity(self.bottom, "km").m_as("km")))
        self.top = float(np.asarray(to_quantity(self.top, "km").m_as("km")))
        if self.sigma_s is None:
            from ..spectra import AirScatteringCoefficientSpectrum

            self.sigma_s = AirScatteringCoefficientSpectrum()

    def _mask(self, zgrid: ZGrid) -> np.ndarray:
        z = zgrid.layers
        return ((z >= self.bottom) & (z < self.top)).astype(np.float64)

    def eval_sigma_t(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        sig = (self.sigma_s.eval(w) + self.sigma_a.eval(w))[:, None] * self._mask(
            zgrid
        )[None, :]
        return self._apply_scale(sig)

    def eval_albedo(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        s = self.sigma_s.eval(w)
        t = s + self.sigma_a.eval(w)
        alb = np.where(t > 0, s / np.where(t > 0, t, 1.0), 1.0)
        return np.broadcast_to(alb[:, None], (w.size, zgrid.n_layers)).copy()

    def eval_phase(self, w_nm, zgrid: ZGrid):
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        kind, params = self.phase.compile(w, zgrid.n_layers)
        weights = np.ones((w.size, 1, zgrid.n_layers))
        return (kind,), (params,), weights


@atmosphere_factory.register("molecular")
@attrs.define(eq=False, slots=False)
class MolecularAtmosphere(Atmosphere):
    """Molecular atmosphere: Rayleigh scattering + optional absorption DB
    (``scenes/atmosphere/_molecular.py:27``)."""

    thermoprops: object = "afgl_1986-us_standard"
    absorption_data: object = None
    has_scattering: bool = True
    has_absorption: bool = True
    rayleigh_depolarization: object = "bates"

    _radprofile: AtmosphereRadProfile = attrs.field(default=None, init=False, repr=False)

    def __attrs_post_init__(self):
        from ...physics.absorption import absdb_converter

        self.absorption_data = absdb_converter(self.absorption_data)
        self._radprofile = AtmosphereRadProfile(
            thermoprops=self.thermoprops,
            absorption_data=self.absorption_data,
            has_scattering=self.has_scattering,
            has_absorption=self.has_absorption and self.absorption_data is not None,
            rayleigh_depolarization=self.rayleigh_depolarization,
        )

    @property
    def radprofile(self) -> AtmosphereRadProfile:
        return self._radprofile

    def _eval_sigma_a(self, w, g, zgrid):
        rp = self._radprofile
        if not rp.has_absorption or rp.absorption_data is None:
            return np.zeros((w.size, zgrid.n_layers))
        tp = rp._layers(zgrid)
        if rp.absorption_data.kind == "ckd":
            gv = np.zeros_like(w) if g is None else np.asarray(g)
            return rp.absorption_data.eval_sigma_a_bin_g(w, gv, tp)
        return rp.absorption_data.eval_sigma_a(w, tp)

    def eval_sigma_t(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        sig = self._radprofile.eval_sigma_s(w, zgrid) + self._eval_sigma_a(
            w, g, zgrid
        )
        return self._apply_scale(sig)

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        return self._apply_scale(
            self._radprofile.eval_sigma_s(
                np.atleast_1d(np.asarray(w_nm, dtype=np.float64)), zgrid
            )
        )

    def eval_albedo(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        s = self._radprofile.eval_sigma_s(w, zgrid)
        t = s + self._eval_sigma_a(w, g, zgrid)
        return np.where(t > 0, s / np.where(t > 0, t, 1.0), 1.0)

    def eval_phase(self, w_nm, zgrid: ZGrid):
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        depol = self._radprofile.eval_depolarization(w, zgrid)
        params = {"depol": depol}
        weights = np.ones((w.size, 1, zgrid.n_layers))
        return ("rayleigh",), (params,), weights


@atmosphere_factory.register("particle_layer")
@attrs.define(eq=False, slots=False)
class ParticleLayer(Atmosphere):
    """Aerosol/particle layer (``scenes/atmosphere/_particle_layer.py:51``).

    The vertical extinction profile follows ``distribution`` over
    [bottom, top], calibrated so the optical thickness at ``w_ref`` equals
    ``tau_ref`` (``_particle_layer.py:294-343``). Spectral shape (sigma_t,
    albedo) and the tabulated phase function come from ``dataset``.
    """

    bottom: float = 0.0  # km
    top: float = 1.0  # km
    distribution: ParticleDistribution = attrs.field(
        default=None,
        converter=lambda v: particle_distribution_factory.convert(v)
        if isinstance(v, dict)
        else v,
    )
    tau_ref: float = 0.15
    w_ref: float = 550.0  # nm
    dataset: object = "govaerts_2021-continental"

    def __attrs_post_init__(self):
        from .particle_dist import UniformParticleDistribution
        from .aerosols import load_particle_dataset

        self.bottom = float(np.asarray(to_quantity(self.bottom, "km").m_as("km")))
        self.top = float(np.asarray(to_quantity(self.top, "km").m_as("km")))
        self.w_ref = float(np.asarray(to_quantity(self.w_ref, "nm").m_as("nm")))
        if self.distribution is None:
            self.distribution = UniformParticleDistribution()
        if isinstance(self.dataset, str):
            self.dataset = load_particle_dataset(self.dataset)
        elif hasattr(self.dataset, "data_vars"):
            # xarray particle dataset (e.g. from load_aerosol_libradtran)
            from .aerosols import particle_dataset_from_xarray

            self.dataset = particle_dataset_from_xarray(self.dataset)

    def _shape_profile(self, zgrid: ZGrid) -> np.ndarray:
        """Normalized vertical profile f(z) with unit integral [1/km]."""
        z = zgrid.layers
        inside = (z >= self.bottom) & (z < self.top)
        x = np.clip((z - self.bottom) / max(self.top - self.bottom, 1e-9), 0.0, 1.0)
        f = np.where(inside, self.distribution.eval_fraction(x), 0.0)
        integral = np.sum(f * zgrid.layer_height)
        return f / max(integral, 1e-30)

    def eval_sigma_t(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        spectral = self.dataset.eval_sigma_t_ratio(w, self.w_ref)  # [S]
        profile = self._shape_profile(zgrid)  # [L], integrates to 1
        sig = self.tau_ref * spectral[:, None] * profile[None, :]
        return self._apply_scale(sig)

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return self.eval_sigma_t(w, None, zgrid) * self.dataset.eval_albedo(w)[
            :, None
        ]

    def eval_albedo(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        alb = self.dataset.eval_albedo(w)
        return np.broadcast_to(alb[:, None], (w.size, zgrid.n_layers)).copy()

    def eval_phase(self, w_nm, zgrid: ZGrid):
        from ...core.modes import mode
        from ..phase import TabulatedPolarizedPhaseFunction

        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        ds = self.dataset
        if mode().is_polarized and getattr(ds, "phase_12", None) is not None:
            # polarized modes consume the dataset's Mueller rows (Mie
            # datasets ship 12/33/34; spheres: m22 = m11, m44 = m33)
            tab = TabulatedPolarizedPhaseFunction(
                mu=ds.mu,
                m11=ds.phase,
                m12=ds.phase_12,
                m33=ds.phase_33,
                m34=ds.phase_34,
                wavelengths=ds.w,
            )
        else:
            tab = TabulatedPhaseFunction(
                mu=ds.mu,
                data=ds.phase,
                wavelengths=ds.w,
            )
        kind, params = tab.compile(w, zgrid.n_layers)
        weights = np.ones((w.size, 1, zgrid.n_layers))
        return (kind,), (params,), weights


@atmosphere_factory.register("heterogeneous")
@attrs.define(eq=False, slots=False)
class HeterogeneousAtmosphere(Atmosphere):
    """Molecular + N particle layers on a shared grid
    (``scenes/atmosphere/_heterogeneous.py:63``): collision coefficients
    sum; the phase function is the sigma_s-weighted blend
    (``_heterogeneous.py:277-298``)."""

    molecular_atmosphere: MolecularAtmosphere | None = attrs.field(default=None)
    particle_layers: list = attrs.field(factory=list)

    def __attrs_post_init__(self):
        if isinstance(self.molecular_atmosphere, dict):
            self.molecular_atmosphere = atmosphere_factory.convert(
                self.molecular_atmosphere
            )
        if isinstance(self.particle_layers, dict):
            self.particle_layers = [self.particle_layers]
        self.particle_layers = [
            atmosphere_factory.convert(p) if isinstance(p, dict) else p
            for p in self.particle_layers
        ]

    @property
    def components(self) -> list:
        comps = []
        if self.molecular_atmosphere is not None:
            comps.append(self.molecular_atmosphere)
        comps.extend(self.particle_layers)
        return comps

    def eval_sigma_t(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        total = np.zeros((w.size, zgrid.n_layers))
        for c in self.components:
            total += c.eval_sigma_t(w, g, zgrid)
        return self._apply_scale(total)

    def eval_albedo(self, w_nm, g, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        sigma_s = np.zeros((w.size, zgrid.n_layers))
        sigma_t = np.zeros((w.size, zgrid.n_layers))
        for c in self.components:
            st = c.eval_sigma_t(w, g, zgrid)
            sa = c.eval_albedo(w, g, zgrid)
            sigma_s += st * sa
            sigma_t += st
        return np.where(sigma_t > 0, sigma_s / np.where(sigma_t > 0, sigma_t, 1.0), 1.0)

    def eval_phase(self, w_nm, zgrid: ZGrid):
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        kinds, params, weights = [], [], []
        for c in self.components:
            k, p, _ = c.eval_phase(w, zgrid)
            assert len(k) == 1, "nested blends not supported"
            kinds.append(k[0])
            params.append(p[0])
            # weight by scattering coefficient (mirror of
            # ``_heterogeneous.py:277-298``)
            weights.append(c.eval_sigma_s(w, zgrid))
        wt = np.stack(weights, axis=1)  # [S, C, L]
        norm = np.sum(wt, axis=1, keepdims=True)
        C = len(kinds)
        wt = np.divide(wt, norm, out=np.full_like(wt, 1.0 / C), where=norm > 0)
        return tuple(kinds), tuple(params), wt

    def eval_sigma_s(self, w_nm, zgrid: ZGrid) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        total = np.zeros((w.size, zgrid.n_layers))
        for c in self.components:
            total += c.eval_sigma_s(w, zgrid)
        return total
