# Host-code copy of eradiate_tpu/scenes/illumination/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Illumination scene elements.

Mirror of ``src/eradiate/scenes/illumination/`` (factory at
``_core.py:29-36``: constant, directional, spot, astro_object).
"""

from __future__ import annotations

import attrs
import numpy as np

from ...core.frame import AzimuthConvention, angles_to_direction
from ...core.units import to_quantity
from ..core import Factory, SceneElement
from ..spectra import SolarIrradianceSpectrum, Spectrum, converter as spectrum_converter

__all__ = [
    "Illumination",
    "DirectionalIllumination",
    "AstroObjectIllumination",
    "ConstantIllumination",
    "SpotIllumination",
    "illumination_factory",
]

illumination_factory = Factory("illumination")


def _irradiance_converter(value):
    if isinstance(value, Spectrum):
        return value
    if isinstance(value, dict):
        from ..spectra import spectrum_factory

        d = dict(value)
        d.setdefault("quantity", "irradiance")
        return spectrum_factory.convert(d)
    return spectrum_converter("irradiance")(value)


@attrs.define(eq=False, slots=False)
class Illumination(SceneElement):
    """Base illumination element."""


@attrs.define(eq=False, slots=False)
class AbstractDirectionalIllumination(Illumination):
    """Common zenith/azimuth parametrization
    (``scenes/illumination/_core.py:73``). Angles in degrees at the config
    surface."""

    zenith: float = 0.0
    azimuth: float = 0.0
    azimuth_convention: str = "east_right"
    irradiance: Spectrum = attrs.field(
        factory=SolarIrradianceSpectrum, converter=_irradiance_converter
    )

    def __attrs_post_init__(self):
        self.zenith = float(np.asarray(to_quantity(self.zenith, "deg").m_as("deg")))
        self.azimuth = float(np.asarray(to_quantity(self.azimuth, "deg").m_as("deg")))

    @property
    def direction(self) -> np.ndarray:
        """Propagation direction of the light (unit, pointing down)."""
        return angles_to_direction(
            [np.deg2rad(self.zenith), np.deg2rad(self.azimuth)],
            azimuth_convention=AzimuthConvention.convert(
                self.azimuth_convention.upper()
                if isinstance(self.azimuth_convention, str)
                else self.azimuth_convention
            ),
            flip=True,
        )[0]

    @property
    def cos_sza(self) -> float:
        return float(np.cos(np.deg2rad(self.zenith)))

    def eval_irradiance(self, w_nm) -> np.ndarray:
        return self.irradiance.eval(w_nm)


@illumination_factory.register("directional")
@attrs.define(eq=False, slots=False)
class DirectionalIllumination(AbstractDirectionalIllumination):
    """Ideal directional (delta) emitter
    (``scenes/illumination/_directional.py:19``)."""

    @property
    def cos_cutoff(self) -> float:
        return 1.0


@illumination_factory.register("astro_object")
@attrs.define(eq=False, slots=False)
class AstroObjectIllumination(AbstractDirectionalIllumination):
    """Directional emitter with finite angular diameter (sun disk);
    reference ``astroobject`` plugin
    (``scenes/illumination/_astro_object.py:17-79``)."""

    angular_diameter: float = 0.5334  # deg

    def __attrs_post_init__(self):
        super().__attrs_post_init__()
        self.angular_diameter = float(
            np.asarray(to_quantity(self.angular_diameter, "deg").m_as("deg"))
        )

    @property
    def cos_cutoff(self) -> float:
        return float(np.cos(np.deg2rad(self.angular_diameter / 2.0)))


@illumination_factory.register("spot")
@attrs.define(eq=False, slots=False)
class SpotIllumination(Illumination):
    """Spot (point) light with a conical beam (reference ``spot`` plugin
    wrapper, ``scenes/illumination/_spot.py:38-143``).

    The beam is modeled as a top-hat cone of half-angle ``beam_width``
    around the ``origin -> target`` axis with intensity ``intensity``
    [W/sr/nm]. Supported by the canopy tracer (lab/close-range scenes) —
    point sources are meaningless for TOA radiometer banks.
    """

    origin: np.ndarray = attrs.field(factory=lambda: np.array([1.0, 1.0, 1.0]))
    target: np.ndarray = attrs.field(factory=lambda: np.zeros(3))
    up: np.ndarray = attrs.field(factory=lambda: np.array([0.0, 0.0, 1.0]))
    beam_width: float = 10.0  # deg, half-angle
    intensity: Spectrum = attrs.field(
        default=1.0, converter=spectrum_converter("intensity")
    )

    def __attrs_post_init__(self):
        self.origin = np.asarray(
            to_quantity(self.origin, "km").m_as("km"), dtype=np.float64
        )
        self.target = np.asarray(
            to_quantity(self.target, "km").m_as("km"), dtype=np.float64
        )
        self.up = np.asarray(self.up, dtype=np.float64)
        self.beam_width = float(
            np.asarray(to_quantity(self.beam_width, "deg").m_as("deg"))
        )
        if np.allclose(self.origin, self.target):
            raise ValueError("spot origin and target must not coincide")

    @classmethod
    def from_size_at_target(
        cls, target, direction, spot_radius, beam_width, **kwargs
    ) -> "SpotIllumination":
        """Place the origin so the beam cone subtends ``spot_radius``
        around ``target`` (reference ``_spot.py:from_size_at_target``)."""
        target = np.asarray(to_quantity(target, "km").m_as("km"), dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        direction = direction / np.linalg.norm(direction)
        radius = float(np.asarray(to_quantity(spot_radius, "km").m_as("km")))
        bw = float(np.asarray(to_quantity(beam_width, "deg").m_as("deg")))
        dist = radius / np.tan(np.deg2rad(bw))
        return cls(
            origin=target - direction * dist,
            target=target,
            beam_width=bw,
            **kwargs,
        )

    @property
    def direction(self) -> np.ndarray:
        """Beam axis (unit, origin -> target)."""
        d = self.target - self.origin
        return d / np.linalg.norm(d)

    @property
    def cos_cutoff(self) -> float:
        return float(np.cos(np.deg2rad(self.beam_width)))

    def eval_intensity(self, w_nm) -> np.ndarray:
        return self.intensity.eval(w_nm)


@illumination_factory.register("constant")
@attrs.define(eq=False, slots=False)
class ConstantIllumination(Illumination):
    """Uniform sky radiance (``scenes/illumination/_constant.py:35``)."""

    radiance: Spectrum = attrs.field(
        default=1.0, converter=spectrum_converter("radiance")
    )
