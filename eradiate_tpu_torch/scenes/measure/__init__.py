# Host-code copy of eradiate_tpu/scenes/measure/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Measure (sensor) scene elements.

Mirror of ``src/eradiate/scenes/measure/`` (factory at ``_core.py:18-63``):
distant radiometer banks and their angular layouts. A measure compiles to a
:class:`~eradiate_tpu.ops.scene_state.SensorArrays` bank — one pixel per
direction — plus angular metadata consumed by the post-processing pipeline.

Angles at the config surface are degrees; directions are unit vectors
pointing from the scene toward the sensor.
"""

from __future__ import annotations

import attrs
import numpy as np

from ...core.frame import AzimuthConvention, angles_to_direction, direction_to_angles
from ...core.units import to_quantity
from ...core.warp import square_to_uniform_hemisphere
from ...spectral.response import DeltaSRF, SpectralResponseFunction, srf_converter
from ..core import Factory, SceneElement

__all__ = [
    "Measure",
    "MultiDistantMeasure",
    "DistantMeasure",
    "MultiPixelDistantMeasure",
    "HemisphericalDistantMeasure",
    "DistantFluxMeasure",
    "RadiancemeterMeasure",
    "MultiRadiancemeterMeasure",
    "PerspectiveCameraMeasure",
    "Target",
    "TargetPoint",
    "TargetRectangle",
    "measure_factory",
]

measure_factory = Factory("measure")


# ---------------------------------------------------------------------------
# Targets (mirror of ``scenes/measure/_distant.py:30-228``)
# ---------------------------------------------------------------------------


@attrs.define(eq=False, slots=False)
class Target:
    @staticmethod
    def convert(value):
        if value is None or isinstance(value, Target):
            return value
        if isinstance(value, dict):
            d = dict(value)
            t = d.pop("type")
            return {"point": TargetPoint, "rectangle": TargetRectangle}[t](**d)
        # bare sequence -> point
        return TargetPoint(xyz=np.asarray(value, dtype=np.float64))


@attrs.define(eq=False, slots=False)
class TargetPoint(Target):
    xyz: np.ndarray = attrs.field(factory=lambda: np.zeros(3))

    def __attrs_post_init__(self):
        self.xyz = np.asarray(
            to_quantity(self.xyz, "km").m_as("km"), dtype=np.float64
        )


@attrs.define(eq=False, slots=False)
class TargetRectangle(Target):
    xmin: float = -1.0
    xmax: float = 1.0
    ymin: float = -1.0
    ymax: float = 1.0
    z: float = 0.0

    def __attrs_post_init__(self):
        for f in ("xmin", "xmax", "ymin", "ymax", "z"):
            setattr(
                self,
                f,
                float(np.asarray(to_quantity(getattr(self, f), "km").m_as("km"))),
            )


# ---------------------------------------------------------------------------
# Measure base
# ---------------------------------------------------------------------------


@attrs.define(eq=False, slots=False)
class Measure(SceneElement):
    """Base measure (``scenes/measure/_core.py``): SRF (default delta at
    550 nm), sample count, target."""

    srf: SpectralResponseFunction = attrs.field(
        factory=lambda: DeltaSRF(np.array([550.0])), converter=srf_converter
    )
    spp: int = attrs.field(default=1000, converter=int)
    target: Target | None = attrs.field(default=None, converter=Target.convert)

    @spp.validator
    def _spp_validator(self, attribute, value):
        # mirror of the reference's single-precision warning
        # (scenes/measure/_core.py:177-184); the TPU engine's f32 noise
        # floor is quantified in tests/system/test_cross_gates.py
        # (TestF32NoiseFloor: <1e-5 at spp 131072 on deterministic scenes)
        import warnings

        from ...core.modes import get_mode_or_none

        mode = get_mode_or_none()
        if (
            value > 100000
            and mode is not None
            and mode.is_single_precision
        ):
            warnings.warn(
                f"Measure {getattr(self, 'id', '?')} is defined with a "
                "sample count greater than 1e5, but the selected mode is "
                "single-precision: accumulation error may become visible "
                "(measured floor <1e-5 relative at spp 1.3e5)."
            )
    sampler: str = attrs.field(
        default="independent",
        validator=attrs.validators.in_(
            ("independent", "stratified", "multijitter", "orthogonal", "ldsampler")
        ),
    )

    #: results slot filled by Experiment.process (mirror of ``mi_results``)
    results: dict = attrs.field(factory=dict, init=False, repr=False)

    @property
    def is_distant(self) -> bool:
        return False

    @property
    def viewing_angles(self) -> np.ndarray:
        """[N, 2] (zenith, azimuth) degrees for each pixel."""
        raise NotImplementedError

    def sensor_directions(self) -> np.ndarray:
        """[N, 3] unit directions from scene toward the sensor."""
        raise NotImplementedError

    @property
    def film_shape(self) -> tuple:
        return (len(self.sensor_directions()),)


def _as_deg_array(value):
    return np.atleast_1d(
        np.asarray(to_quantity(value, "deg").m_as("deg"), dtype=np.float64)
    )


# ---------------------------------------------------------------------------
# Multi-distant measure + layouts (``_multi_distant.py:402-639``)
# ---------------------------------------------------------------------------


@measure_factory.register("mdistant", aliases=("multi_distant",))
@attrs.define(eq=False, slots=False)
class MultiDistantMeasure(Measure):
    """Array of distant radiancemeters, one film pixel per direction
    (reference ``mdistant`` plugin, ``_multi_distant.py:640-660``).

    Construct via explicit angles/directions or the classmethod layouts:
    ``hplane``, ``aring``, ``grid``, ``from_angles``, ``from_directions``.
    """

    #: [N, 2] (zenith, azimuth) in degrees
    angles: np.ndarray = attrs.field(default=None)
    #: direction of the hemisphere plane for hplane layouts (deg) or None
    hplane_azimuth: float | None = attrs.field(default=None)
    azimuth_convention: str = "east_right"
    #: optional explicit directions [N, 3] (toward sensor); overrides angles
    directions: np.ndarray = attrs.field(default=None)
    ray_offset: float | None = attrs.field(default=None)

    def __attrs_post_init__(self):
        if self.directions is not None:
            self.directions = np.atleast_2d(
                np.asarray(self.directions, dtype=np.float64)
            )
        if self.angles is not None:
            self.angles = np.atleast_2d(_as_deg_array(self.angles).reshape(-1, 2))

    # -- constructors ------------------------------------------------------
    @classmethod
    def hplane(cls, zeniths, azimuth=0.0, **kwargs):
        """Hemisphere-plane layout: signed zeniths at a fixed azimuth
        (``_multi_distant.py:402``)."""
        zeniths = _as_deg_array(zeniths)
        az = float(_as_deg_array(azimuth)[0])
        angles = np.stack([zeniths, np.full(zeniths.shape, az)], axis=-1)
        return cls(angles=angles, hplane_azimuth=az, **kwargs)

    @classmethod
    def aring(cls, zenith, azimuths, **kwargs):
        """Azimuth-ring layout (``_multi_distant.py``)."""
        azimuths = _as_deg_array(azimuths)
        z = float(_as_deg_array(zenith)[0])
        angles = np.stack([np.full(azimuths.shape, z), azimuths], axis=-1)
        return cls(angles=angles, **kwargs)

    @classmethod
    def grid(cls, zeniths, azimuths, **kwargs):
        """Outer-product grid layout."""
        zeniths = _as_deg_array(zeniths)
        azimuths = _as_deg_array(azimuths)
        zz, aa = np.meshgrid(zeniths, azimuths, indexing="ij")
        angles = np.stack([zz.ravel(), aa.ravel()], axis=-1)
        return cls(angles=angles, **kwargs)

    @classmethod
    def from_angles(cls, angles, **kwargs):
        return cls(angles=np.asarray(angles), **kwargs)

    @classmethod
    def from_directions(cls, directions, **kwargs):
        return cls(directions=np.asarray(directions), **kwargs)

    # -- interface ---------------------------------------------------------
    @property
    def is_distant(self) -> bool:
        return True

    @property
    def viewing_angles(self) -> np.ndarray:
        if self.angles is not None:
            return self.angles
        ang = direction_to_angles(self.directions)
        return np.rad2deg(ang)

    def sensor_directions(self) -> np.ndarray:
        if self.directions is not None:
            d = self.directions
            return d / np.linalg.norm(d, axis=-1, keepdims=True)
        conv = AzimuthConvention.convert(self.azimuth_convention.upper())
        return angles_to_direction(
            np.deg2rad(self.angles), azimuth_convention=conv
        )


@measure_factory.register("mpdistant", aliases=("multipixel_distant",))
@attrs.define(eq=False, slots=False)
class MultiPixelDistantMeasure(Measure):
    """Multi-pixel distant measure (reference ``mpdistant`` plugin,
    ``scenes/measure/_distant.py:500-639``): a single viewing direction with
    a (W, H) film where each pixel images one subcell of the rectangular
    target — a distant orthographic imager. Pixels jitter their ray origins
    uniformly within their subcell.
    """

    direction: np.ndarray = attrs.field(factory=lambda: np.array([0.0, 0.0, 1.0]))
    film_resolution: tuple = (32, 32)
    azimuth_convention: str = "east_right"
    ray_offset: float | None = None

    def __attrs_post_init__(self):
        self.direction = np.asarray(self.direction, dtype=np.float64)
        self.direction = self.direction / np.linalg.norm(self.direction)

    @classmethod
    def from_angles(cls, angles, **kwargs):
        angles = np.deg2rad(_as_deg_array(angles).reshape(2))
        conv = AzimuthConvention.convert(
            kwargs.get("azimuth_convention", "east_right").upper()
        )
        direction = np.squeeze(
            angles_to_direction(angles[None, :], azimuth_convention=conv)
        )
        return cls(direction=direction, **kwargs)

    @property
    def is_distant(self) -> bool:
        return True

    @property
    def film_shape(self) -> tuple:
        return tuple(self.film_resolution)

    def sensor_directions(self) -> np.ndarray:
        n = int(np.prod(self.film_resolution))
        return np.broadcast_to(self.direction, (n, 3)).copy()

    @property
    def viewing_angles(self) -> np.ndarray:
        ang = np.rad2deg(direction_to_angles(self.direction[None, :]))
        n = int(np.prod(self.film_resolution))
        return np.broadcast_to(ang, (n, 2)).copy()

    def pixel_targets(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Per-pixel target subcell centers [N, 3] and the (shared) subcell
        extent [2], x-major ravel order matching ``sensor_directions``.
        Requires a rectangle target; point targets return None."""
        if not isinstance(self.target, TargetRectangle):
            return None
        nx, ny = self.film_resolution
        r = self.target
        dx = (r.xmax - r.xmin) / nx
        dy = (r.ymax - r.ymin) / ny
        xs = r.xmin + (np.arange(nx) + 0.5) * dx
        ys = r.ymin + (np.arange(ny) + 0.5) * dy
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        centers = np.stack(
            [xx.ravel(), yy.ravel(), np.full(nx * ny, r.z)], axis=-1
        )
        return centers, np.array([dx, dy])


@measure_factory.register("distant")
@attrs.define(eq=False, slots=False)
class DistantMeasure(Measure):
    """Single-direction distant radiometer (reference ``distant`` plugin,
    ``scenes/measure/_distant.py:365-484``)."""

    zenith: float = 0.0
    azimuth: float = 0.0
    azimuth_convention: str = "east_right"
    ray_offset: float | None = None

    @property
    def is_distant(self) -> bool:
        return True

    @property
    def viewing_angles(self) -> np.ndarray:
        return np.array(
            [[float(_as_deg_array(self.zenith)[0]), float(_as_deg_array(self.azimuth)[0])]]
        )

    def sensor_directions(self) -> np.ndarray:
        conv = AzimuthConvention.convert(self.azimuth_convention.upper())
        return angles_to_direction(
            np.deg2rad(self.viewing_angles), azimuth_convention=conv
        )


@measure_factory.register("hdistant", aliases=("hemispherical_distant",))
@attrs.define(eq=False, slots=False)
class HemisphericalDistantMeasure(Measure):
    """Hemispherical distant sensor: film is a square map of the hemisphere
    (reference ``hdistant`` plugin,
    ``scenes/measure/_hemispherical_distant.py:146``)."""

    film_resolution: tuple = (32, 32)
    azimuth_convention: str = "east_right"

    @property
    def is_distant(self) -> bool:
        return True

    @property
    def film_shape(self) -> tuple:
        return tuple(self.film_resolution)

    def sensor_directions(self) -> np.ndarray:
        nx, ny = self.film_resolution
        # pixel centers on the unit square -> uniform hemisphere mapping
        u = (np.arange(nx) + 0.5) / nx
        v = (np.arange(ny) + 0.5) / ny
        uu, vv = np.meshgrid(u, v, indexing="ij")
        s = np.stack([uu.ravel(), vv.ravel()], axis=-1)
        return square_to_uniform_hemisphere(s)

    @property
    def viewing_angles(self) -> np.ndarray:
        return np.rad2deg(direction_to_angles(self.sensor_directions()))


@measure_factory.register("distant_flux", aliases=("distantflux",))
@attrs.define(eq=False, slots=False)
class DistantFluxMeasure(HemisphericalDistantMeasure):
    """Distant flux (sector radiosity) measure: hemisphere sectors
    (reference ``distantflux``, ``scenes/measure/_distant_flux.py:128``).

    Post-processing integrates the hemispherical radiance map into exitant
    flux (radiosity); the sensor bank is the same hemisphere sampling as
    ``hdistant``.
    """

    @property
    def flux_weights(self) -> np.ndarray:
        """Per-pixel cos-weighted solid angle for radiosity integration.

        Uniform hemisphere map -> d_omega = 2 pi / N per pixel; weights are
        renormalized to integrate the cosine exactly (sum = pi), removing
        the O(1/N) quadrature bias of the pixel-center rule.
        """
        d = self.sensor_directions()
        n = d.shape[0]
        w = 2.0 * np.pi / n * np.maximum(d[:, 2], 0.0)
        return w * (np.pi / w.sum())


@measure_factory.register("perspective")
@attrs.define(eq=False, slots=False)
class PerspectiveCameraMeasure(Measure):
    """Pinhole perspective camera (reference ``perspective`` plugin wrapper,
    ``scenes/measure/_perspective.py:19-160``).

    Positioned by ``origin``/``target``/``up`` look-at vectors with a field
    of view ``fov`` (degrees) applied along the film **width** axis (Mitsuba
    ``fov_axis='x'`` default).

    Reconstruction filters (the reference's film/rfilter stack,
    ``scenes/measure/_core.py:156-168``): ``rfilter='box'`` (default)
    shoots one radiometer ray per pixel center; ``'tent'`` (radius 1) and
    ``'gaussian'`` (sigma 0.5, radius 2 — the Mitsuba defaults) render an
    ``rfilter_oversample``x finer stratified sub-pixel grid and assemble
    the film by kernel-weighted downsampling — the deterministic
    stratified form of Mitsuba's jittered-sample splatting, which fits
    the wavefront engine's fixed (pixel, sample) lane partition.

    ``far_clip`` is structurally unnecessary here: the analytic tracers
    terminate rays on scene exit rather than on a clip plane.
    """

    film_resolution: tuple = (32, 32)
    origin: np.ndarray = attrs.field(factory=lambda: np.array([1.0, 1.0, 1.0]))
    target: np.ndarray = attrs.field(factory=lambda: np.zeros(3))
    up: np.ndarray = attrs.field(factory=lambda: np.array([0.0, 0.0, 1.0]))
    fov: float = 50.0
    rfilter: str = "box"
    rfilter_oversample: int = 2

    def __attrs_post_init__(self):
        self.origin = np.asarray(
            to_quantity(self.origin, "km").m_as("km"), dtype=np.float64
        )
        tgt = self.target.xyz if isinstance(self.target, TargetPoint) else self.target
        self.target = np.asarray(
            to_quantity(tgt, "km").m_as("km"), dtype=np.float64
        )
        self.up = np.asarray(self.up, dtype=np.float64)
        self.fov = float(_as_deg_array(self.fov)[0])
        if np.allclose(self.target, self.origin):
            raise ValueError(
                f"origin and target must not be equal, got target = "
                f"{self.target}, origin = {self.origin}"
            )
        if np.allclose(np.cross(self.target - self.origin, self.up), 0.0):
            raise ValueError(
                f"up direction must not be colinear with the viewing "
                f"direction, got up = {self.up}, direction = "
                f"{self.target - self.origin}"
            )
        if self.rfilter not in ("box", "tent", "gaussian"):
            raise ValueError(
                f"unknown rfilter '{self.rfilter}'; "
                "available: box, tent, gaussian"
            )
        self.rfilter_oversample = int(self.rfilter_oversample)
        if self.rfilter != "box" and self.rfilter_oversample < 2:
            raise ValueError("rfilter_oversample must be >= 2 for non-box")

    @property
    def film_shape(self) -> tuple:
        return tuple(self.film_resolution)

    @property
    def ray_anchor(self) -> np.ndarray:
        """Rays start at the camera origin (consumed by compile_scene)."""
        return self.origin

    @property
    def ray_offset(self) -> float:
        return 0.0

    def _grid_directions(self, nx, ny) -> np.ndarray:
        fwd = self.target - self.origin
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, self.up)
        right = right / np.linalg.norm(right)
        upv = np.cross(right, fwd)
        half_w = np.tan(np.deg2rad(self.fov) / 2.0)
        half_h = half_w * self.film_resolution[1] / self.film_resolution[0]
        # pixel centers; +y up on the image plane
        xs = (np.arange(nx) + 0.5) / nx * 2.0 - 1.0
        ys = 1.0 - (np.arange(ny) + 0.5) / ny * 2.0
        xx, yy = np.meshgrid(xs * half_w, ys * half_h, indexing="ij")
        d = (
            fwd[None, :]
            + xx.ravel()[:, None] * right[None, :]
            + yy.ravel()[:, None] * upv[None, :]
        )
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        return -d  # toward the sensor

    def sensor_directions(self) -> np.ndarray:
        """Unit vectors from the scene toward the camera, x-fastest over
        the (possibly rfilter-oversampled) sub-pixel grid; non-box
        filters trace ``rfilter_oversample^2`` stratified rays per pixel
        and :meth:`assemble_film` folds them back to ``film_shape``."""
        nx, ny = self.film_resolution
        if self.rfilter == "box":
            return self._grid_directions(nx, ny)
        os_ = self.rfilter_oversample
        return self._grid_directions(nx * os_, ny * os_)

    @property
    def viewing_angles(self) -> np.ndarray:
        nx, ny = self.film_resolution
        return np.rad2deg(direction_to_angles(self._grid_directions(nx, ny)))

    def _filter_taps(self):
        """(offsets, weights): kernel taps on the oversampled grid, in
        output-pixel units relative to the output pixel center."""
        os_ = self.rfilter_oversample
        if self.rfilter == "tent":
            radius = 1.0

            def kern(r):
                return np.maximum(1.0 - np.abs(r), 0.0)
        else:  # gaussian (Mitsuba defaults: sigma 0.5, radius 2)
            radius, sigma = 2.0, 0.5

            def kern(r):
                g = np.exp(-0.5 * (r / sigma) ** 2)
                return np.maximum(g - np.exp(-0.5 * (radius / sigma) ** 2), 0.0)

        half = int(np.ceil(radius * os_))
        taps = np.arange(-half, half + 1)
        # tap t addresses sub-sample (os-1)//2 + t within the output
        # pixel's os-wide stratum; that sub-sample's center sits at
        # ((os-1)//2 + t + 0.5)/os - 0.5 output-pixel units from the
        # output pixel center
        r = ((os_ - 1) // 2 + taps + 0.5) / os_ - 0.5
        w = kern(r)
        keep = w > 0
        return taps[keep], w[keep]

    def assemble_film(self, *fields):
        """Kernel-weighted downsampling of oversampled film fields.

        ``fields``: arrays [..., N_over] (x-fastest raveled film). The
        FIRST field is averaged with weights w; any further fields are
        treated as per-sample variances (weights w^2, same
        normalization squared). Returns the tuple of [..., W*H] arrays.
        No-op for the box filter.
        """
        if self.rfilter == "box":
            return fields if len(fields) > 1 else fields[0]
        nx, ny = self.film_resolution
        os_ = self.rfilter_oversample
        taps, w = self._filter_taps()

        def down(img, sq):
            shp = img.shape[:-1]
            a = img.reshape(shp + (nx * os_, ny * os_))
            out = np.zeros(shp + (nx, ny), dtype=img.dtype)
            norm = 0.0
            # output pixel (i, j) pools sub-samples at
            # (i*os + (os-1)/2 + tap) in each axis, clamped at the border
            base_x = np.arange(nx) * os_ + (os_ - 1) // 2
            base_y = np.arange(ny) * os_ + (os_ - 1) // 2
            for tx, wx in zip(taps, w):
                ix = np.clip(base_x + tx, 0, nx * os_ - 1)
                for ty, wy in zip(taps, w):
                    iy = np.clip(base_y + ty, 0, ny * os_ - 1)
                    # variance of a w-weighted mean: w^2 numerator
                    # weights over the SQUARED linear normalization
                    wgt = (wx * wy) ** 2 if sq else wx * wy
                    out += wgt * a[..., ix[:, None], iy[None, :]]
                    norm += wx * wy
            return (out / (norm**2 if sq else norm)).reshape(
                shp + (nx * ny,)
            )

        outs = [down(np.asarray(fields[0]), sq=False)]
        for f in fields[1:]:
            outs.append(down(np.asarray(f), sq=True))
        return tuple(outs) if len(outs) > 1 else outs[0]


@measure_factory.register("radiancemeter")
@attrs.define(eq=False, slots=False)
class RadiancemeterMeasure(Measure):
    """In-scene single radiancemeter (``_radiancemeter.py:77``)."""

    origin: np.ndarray = attrs.field(factory=lambda: np.array([0.0, 0.0, 0.0]))
    target_point: np.ndarray = attrs.field(factory=lambda: np.array([0.0, 0.0, 1.0]))

    def __attrs_post_init__(self):
        self.origin = np.asarray(to_quantity(self.origin, "km").m_as("km"))
        self.target_point = np.asarray(
            to_quantity(self.target_point, "km").m_as("km")
        )

    def sensor_directions(self) -> np.ndarray:
        d = self.origin - self.target_point
        return (d / np.linalg.norm(d))[None, :]

    @property
    def viewing_angles(self) -> np.ndarray:
        return np.rad2deg(direction_to_angles(self.sensor_directions()))


@measure_factory.register("mradiancemeter", aliases=("multi_radiancemeter",))
@attrs.define(eq=False, slots=False)
class MultiRadiancemeterMeasure(Measure):
    """Multi-origin/direction radiancemeter array
    (``scenes/measure/_multi_radiancemeter.py:82``)."""

    origins: np.ndarray = attrs.field(factory=lambda: np.zeros((1, 3)))
    directions: np.ndarray = attrs.field(factory=lambda: np.array([[0.0, 0.0, 1.0]]))

    def __attrs_post_init__(self):
        self.origins = np.atleast_2d(
            np.asarray(to_quantity(self.origins, "km").m_as("km"))
        )
        self.directions = np.atleast_2d(np.asarray(self.directions, dtype=np.float64))

    def sensor_directions(self) -> np.ndarray:
        # viewing directions: opposite of pointing directions
        d = -self.directions
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    @property
    def viewing_angles(self) -> np.ndarray:
        return np.rad2deg(direction_to_angles(self.sensor_directions()))
