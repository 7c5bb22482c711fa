"""One-dimensional atmosphere experiment, mono slice.

Port of ``eradiate_tpu/experiments/_atmosphere.py``: the same attrs fields
and converters, the mono and CKD spectral contexts (CKD: one spectral row
for each (bin, g-point) pair of the quadrature), and ``compile_scene`` for
plane-parallel geometry (with the optional error-bounded layer merge) and
spherical-shell geometry (with the error-bounded shell merge and the sun
slant-tau table), directional, spot and constant illumination, and every
measure: distant banks, cameras (rays from the camera's origin) and
``mpdistant`` (a target subcell a pixel). Host
arithmetic stays numpy float64 up to a single cast to the mode's dtype
(float32 in a single mode, float64 in a double one), as the reference casts
to ``mode().device_dtype``; the sun-tau table is built only in float32, from
the float32 radii and extinction, as in the reference. The compiled leaves
are numpy arrays that :func:`..ops.scene_state.from_reference` ships to the
device.
"""

from __future__ import annotations

import attrs
import numpy as np

import torch

from ..core.modes import mode
from ..physics.shell_merge import (
    adaptive_layer_groups_pp,
    adaptive_shell_groups,
    merge_layer_mean,
    merge_layer_weighted,
)
from ..scenes.atmosphere import (
    Atmosphere,
    MolecularAtmosphere,
    atmosphere_factory,
)
from ..scenes.geometry import PlaneParallelGeometry, SceneGeometry
from ..scenes.illumination import (
    ConstantIllumination,
    SpotIllumination,
)
from ..scenes.measure import TargetPoint, TargetRectangle
from ..scenes.surface import Surface, surface_converter
from ..spectral.grid import CKDSpectralGrid, MonoSpectralGrid

from ..ops.scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneArrays,
    SceneConfig,
    SensorArrays,
    SphericalMediumArrays,
    SurfaceArrays,
)
from ..ops.spherical import sun_mu_grid_warped, sun_tau_table_grid
from ._core import EarthObservationExperiment, check_mode

__all__ = ["AtmosphereExperiment"]


def _atmosphere_converter(value):
    if value is None:
        return None
    if isinstance(value, dict):
        return atmosphere_factory.convert(value)
    if isinstance(value, Atmosphere):
        return value
    raise TypeError(f"cannot convert {type(value)} to Atmosphere")


def _cast(x):
    """``x`` as a numpy array of the active mode's dtype."""
    return np.asarray(x, dtype=mode().host_dtype)


def _merge_params(params, groups, w_scat, L):
    """Merge layer-indexed phase parameters under scattering-depth weights."""
    L_m = groups.size - 1
    return tuple(
        {
            k: (
                merge_layer_weighted(v, groups, w_scat)
                if np.ndim(v) >= 1 and np.shape(v)[-1] == L and np.shape(v)[-1] != L_m
                else v
            )
            for k, v in p.items()
        }
        for p in params
    )


@attrs.define(eq=False, slots=False)
class AtmosphereExperiment(EarthObservationExperiment):
    """1D atmosphere experiment (reference ``AtmosphereExperiment``)."""

    geometry: SceneGeometry = attrs.field(
        factory=PlaneParallelGeometry, converter=SceneGeometry.convert
    )
    atmosphere: Atmosphere | None = attrs.field(
        factory=lambda: atmosphere_factory.convert({"type": "molecular"}),
        converter=_atmosphere_converter,
    )
    surface: Surface | None = attrs.field(
        default={"type": "lambertian", "reflectance": 0.5},
        converter=lambda v: None if v is None else surface_converter(v),
    )

    def __attrs_post_init__(self):
        # default distant-measure target: the scene origin (plane-parallel)
        # or the sub-sensor surface point (spherical shells)
        if self.geometry.kind == "spherical_shell":
            z_target = self.geometry.planet_radius + self.geometry.ground_altitude
        else:
            z_target = self.geometry.ground_altitude
        for m in self.measures:
            if m.target is None and m.is_distant:
                m.target = TargetPoint(xyz=np.array([0.0, 0.0, z_target]))

    def spectral_grid_for(self, measure):
        """The measure's spectral grid: mono wavelengths, or the CKD bins its
        response selects with their quadratures."""
        m = check_mode()
        if m.is_mono:
            grid = None
            if (
                isinstance(self.atmosphere, MolecularAtmosphere)
                and self.atmosphere.absorption_data is not None
                and self.atmosphere.absorption_data.kind == "mono"
            ):
                grid = MonoSpectralGrid(self.atmosphere.absorption_data.wavelengths)
            if grid is None:
                grid = MonoSpectralGrid.default()
            return grid.select(measure.srf)
        grid = None
        db = getattr(self.atmosphere, "absorption_data", None)
        if db is not None and getattr(db, "kind", None) == "ckd":
            grid = db.spectral_grid()
        if grid is None:
            grid = CKDSpectralGrid.default()
        return grid.select(measure.srf).walk_quads(self.ckd_quad_config, db)

    def spectral_context(self, measure) -> dict:
        """Mono: ``{"w": wavelengths [S]}``. CKD: the flattened (bin, g)
        pairs, ``w`` (the bin's centre), ``g``, ``bin_index``, ``g_weights``
        (each bin's sum to 1) [S] and ``bin_wcenters`` [bins]."""
        grid = self.spectral_grid_for(measure)
        if check_mode().is_mono:
            return {"w": grid.wavelengths}
        ws, gs, bidx, gw = [], [], [], []
        for i in range(len(grid)):
            quad = grid.quad_for_bin(i)
            nodes = quad.eval_nodes((0.0, 1.0))
            # normalized weights on [0, 1]
            weights = quad.weights / 2.0
            for gnode, wt in zip(nodes, weights):
                ws.append(grid.wcenters[i])
                gs.append(gnode)
                bidx.append(i)
                gw.append(wt)
        return {
            "w": np.asarray(ws),
            "g": np.asarray(gs),
            "bin_index": np.asarray(bidx, dtype=np.int64),
            "g_weights": np.asarray(gw),
            "bin_wcenters": grid.wcenters,
        }

    def _plane_parallel_medium(self, sigma_t, albedo, params, weights, L):
        levels = self.geometry.zgrid.levels
        tol = getattr(self.geometry, "layer_merge_tol", None)
        if tol:
            # plane-parallel transport is invariant in the tau coordinate,
            # so layers merge under a slant-error bound; per-component
            # scattering rows block merging across material boundaries
            sigma_np = np.asarray(sigma_t, dtype=np.float64)
            alb_np = np.asarray(albedo, dtype=np.float64)
            w_np = np.asarray(weights, dtype=np.float64)
            C = w_np.shape[1]
            rows = np.concatenate(
                [sigma_np] + [sigma_np * alb_np * w_np[:, c, :] for c in range(C)],
                axis=0,
            )
            groups = adaptive_layer_groups_pp(levels, rows, tol)
            if groups.size - 1 < sigma_np.shape[-1]:
                dzf = np.diff(levels)
                w_ext = sigma_np * dzf
                w_scat = w_ext * alb_np
                sigma_t = merge_layer_mean(sigma_np, groups, dzf)
                albedo = merge_layer_weighted(alb_np, groups, w_ext)
                weights = merge_layer_weighted(w_np, groups, w_scat[:, None, :])
                params = _merge_params(params, groups, w_scat, L)
                levels = levels[groups]

        dz = np.diff(levels)
        tau_np = np.concatenate(
            [
                np.zeros(sigma_t.shape[:-1] + (1,)),
                np.cumsum(np.asarray(sigma_t) * dz, axis=-1),
            ],
            axis=-1,
        )
        return MediumArrays(
            z_levels=_cast(levels),
            tau_levels=_cast(tau_np),
            albedo=_cast(albedo),
            phase_weights=_cast(weights),
            phase_params=tuple({k: _cast(v) for k, v in p.items()} for p in params),
        )

    def _spherical_medium(self, sigma_t, albedo, params, weights, L):
        geom = self.geometry
        levels = geom.zgrid.levels
        tol = getattr(geom, "shell_merge_tol", None)
        groups = adaptive_shell_groups(levels, sigma_t, geom.planet_radius, tol or 0.0)
        if groups.size - 1 < np.asarray(sigma_t).shape[-1]:
            # error-bounded merge: vertical tau exact, worst-case tangent
            # slant-tau error <= tol per group; albedo merges under
            # extinction-depth weights, phase quantities under
            # scattering-depth weights
            dz = np.diff(levels)
            sigma_np = np.asarray(sigma_t, dtype=np.float64)
            w_ext = sigma_np * dz
            w_scat = w_ext * np.asarray(albedo, dtype=np.float64)
            sigma_t = merge_layer_mean(sigma_np, groups, dz)
            albedo = merge_layer_weighted(albedo, groups, w_ext)
            weights = merge_layer_weighted(weights, groups, w_scat[:, None, :])
            params = _merge_params(params, groups, w_scat, L)
            levels = levels[groups]

        radii = _cast(geom.planet_radius + levels)
        sig = _cast(sigma_t)
        # NEE sun transmittance from a (radius, local cosine) slant-tau table
        # where the terminator guardrail allows it (SZA <= 80 by default);
        # otherwise the tracer computes the exact slant depth per event
        table = getattr(geom, "sun_tau_table", "auto")
        if table == "auto":
            table = getattr(self.illumination, "zenith", 0.0) <= 80.0
        # the table is float32 only: a double mode takes the exact slant depth
        table = table and mode().host_dtype == np.float32
        sun_tau = mu_grid = sun_r_grid = warp = None
        if table:
            mu_np, warp = sun_mu_grid_warped(128)
            mu_grid = _cast(mu_np)
            sun_r_grid = _cast(
                np.linspace(
                    float(geom.planet_radius + levels[0]),
                    float(geom.planet_radius + levels[-1]),
                    128,
                )
            )
            # r_ground = 0: the ground's shadow is not in the table (it would
            # smear the bilinear fetch at the terminator); the tracer applies
            # it exactly
            sun_tau = sun_tau_table_grid(
                *map(torch.from_numpy, (sig, radii, sun_r_grid, mu_grid)), r_ground=0.0
            ).numpy()
        return SphericalMediumArrays(
            radii=radii,
            sigma_t=sig,
            sigma_majorant=_cast(np.max(np.asarray(sigma_t), axis=1)),
            albedo=_cast(albedo),
            phase_weights=_cast(weights),
            phase_params=tuple({k: _cast(v) for k, v in p.items()} for p in params),
            sun_tau=sun_tau,
            mu_grid=mu_grid,
            sun_r_grid=sun_r_grid,
            sun_mu_warp=warp,
        )

    def compile_scene(self, measure, spectral_ctx):
        """Compile to (SceneArrays, SensorArrays, SceneConfig) with numpy
        leaves in the mode's dtype."""
        m = check_mode()
        if self.geometry.kind not in ("plane_parallel", "spherical_shell"):
            raise NotImplementedError(
                f"geometry {self.geometry.kind!r} is not ported yet"
            )
        w = np.asarray(spectral_ctx["w"], dtype=np.float64)
        g = spectral_ctx.get("g")
        S = w.size
        zgrid = self.geometry.zgrid
        L = zgrid.n_layers

        # Medium
        if self.atmosphere is not None:
            sigma_t = self.atmosphere.eval_sigma_t(w, g, zgrid)
            albedo = self.atmosphere.eval_albedo(w, g, zgrid)
            kinds, params, weights = self.atmosphere.eval_phase(w, zgrid)
        else:
            sigma_t = np.zeros((S, L))
            albedo = np.ones((S, L))
            kinds = ("rayleigh",)
            params = ({"depol": np.zeros((S, L))},)
            weights = np.ones((S, 1, L))

        if self.geometry.kind == "spherical_shell":
            medium = self._spherical_medium(sigma_t, albedo, params, weights, L)
        else:
            medium = self._plane_parallel_medium(sigma_t, albedo, params, weights, L)

        # Surface
        if self.surface is not None:
            surf_kind = self.surface.bsdf_kind
            sparams = {
                k: v if isinstance(v, str) else _cast(v)
                for k, v in self.surface.eval_bsdf_params(w).items()
            }
        else:
            surf_kind = "black"
            sparams = {}

        # Illumination
        illumination_kind = "directional"
        if isinstance(self.illumination, SpotIllumination):
            illumination_kind = "spot"
            illum = IlluminationArrays(
                direction=_cast(self.illumination.direction),
                irradiance=_cast(self.illumination.eval_intensity(w)),
                cos_cutoff=_cast(self.illumination.cos_cutoff),
                sky_radiance=_cast(np.zeros(S)),
                position=_cast(self.illumination.origin),
            )
        elif isinstance(self.illumination, ConstantIllumination):
            illum = IlluminationArrays(
                direction=_cast(np.array([0.0, 0.0, -1.0])),
                irradiance=_cast(np.zeros(S)),
                cos_cutoff=_cast(1.0),
                sky_radiance=_cast(self.illumination.radiance.eval(w)),
            )
        else:
            illum = IlluminationArrays(
                direction=_cast(self.illumination.direction),
                irradiance=_cast(self.illumination.eval_irradiance(w)),
                cos_cutoff=_cast(self.illumination.cos_cutoff),
                sky_radiance=_cast(np.zeros(S)),
            )
        scene = SceneArrays(medium, SurfaceArrays(params=sparams), illum)

        # Sensor
        anchor = getattr(measure, "ray_anchor", None)
        pixel_targets = getattr(measure, "pixel_targets", None)
        per_pixel = pixel_targets() if callable(pixel_targets) else None
        extent = None
        if anchor is not None:
            # a camera: rays start at its origin
            target = np.asarray(anchor, dtype=np.float64)
        elif per_pixel is not None:
            # mpdistant: one target subcell a film pixel
            target, extent = per_pixel
        elif isinstance(measure.target, TargetPoint):
            target = measure.target.xyz
        elif isinstance(measure.target, TargetRectangle):
            r = measure.target
            target = np.array([0.5 * (r.xmin + r.xmax), 0.5 * (r.ymin + r.ymax), r.z])
            extent = np.array([r.xmax - r.xmin, r.ymax - r.ymin])
        else:
            target = np.zeros(3)
        ray_offset = getattr(measure, "ray_offset", None)
        sensor = SensorArrays(
            directions=_cast(measure.sensor_directions()),
            target=_cast(target),
            ray_offset=_cast(np.nan if ray_offset is None else ray_offset),
            target_extent=None if extent is None else _cast(extent),
        )

        integrator = self.integrator
        config = SceneConfig(
            geometry=self.geometry.kind,
            surface_kind=surf_kind,
            phase_kinds=tuple(kinds),
            polarized=m.is_polarized,
            max_depth=integrator.max_depth if integrator else 32,
            rr_depth=integrator.rr_depth if integrator else 5,
            ground_altitude=self.geometry.ground_altitude,
            toa_altitude=self.geometry.toa_altitude,
            has_surface=self.surface is not None,
            sampler=measure.sampler,
            illumination_kind=illumination_kind,
        )
        return scene, sensor, config
