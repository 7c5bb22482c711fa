"""Compiled scene state: the tensors the port's tracer consumes.

Port of ``eradiate_tpu/ops/scene_state.py``: the same classes, field names
and defaults, as plain dataclasses of tensors instead of JAX pytrees.
:func:`from_reference` is the one place where compiled arrays cross onto the
device, whether they come from the JAX package's ``compile_scene`` or from
the port's own host-side compile (numpy leaves either way);
:func:`canopy_from_reference` does the same for a canopy's leaf arrays and
leaf optics, :func:`dem_from_reference` for a terrain's grid.

Shape conventions: ``S`` spectral rows, ``L`` layers, ``C`` phase
components, ``N`` sensor directions. Lengths in km, sigma in km^-1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .canopy import InstancedLeafArrays, LeafCloudArrays
from .dem import DemArrays
from .mesh import InstancedTriArrays, TriangleMeshArrays

__all__ = [
    "MediumArrays",
    "SphericalMediumArrays",
    "SurfaceArrays",
    "IlluminationArrays",
    "SensorArrays",
    "SceneArrays",
    "SceneConfig",
    "from_reference",
    "canopy_from_reference",
    "dem_from_reference",
    "scene_dtype",
    "SURFACE_PARAMS",
    "PHASE_PARAMS",
]

#: The rows the surfaces' parameters must hold (``rpv``: Rahman's three;
#: ``maignan``: the RPV base and the Fresnel peak; ``ocean_mishchenko``: the
#: Cox-Munk glint). A compiled scene that lacks one is refused on transfer.
SURFACE_PARAMS = {
    "rpv": ("rho_0", "k", "g"),
    "maignan": ("rho_0", "k", "g", "C", "ndvi", "refr_re", "refr_im", "ext_ior"),
    "ocean_mishchenko": ("wind_speed", "eta", "k", "ext_ior", "shadowing"),
}

#: The parameters each phase component must hold, rows [S, ...]:
#: ``rayleigh`` its depolarization per layer [S, L], ``hg`` its asymmetry
#: [S], ``tab`` its table on the mu grid [S, M] (and, on a theta-uniform
#: grid, ``tg0`` and ``itg`` [S]), ``tab_polarized`` a ``tab`` table and the
#: phase matrix's other elements on the same grid [S, M]. A compiled scene
#: that lacks one is refused on transfer.
PHASE_PARAMS = {
    "rayleigh": ("depol",),
    "hg": ("g",),
    "tab": ("mu", "values", "cdf"),
    "tab_polarized": ("mu", "values", "cdf", "m12", "m22", "m33", "m34", "m44"),
}


@dataclasses.dataclass
class MediumArrays:
    """Layered 1D medium; ``tau_levels[s, i]`` is the cumulative vertical
    optical depth from the bottom up to level ``i``."""

    z_levels: Any  # [L+1]
    tau_levels: Any  # [S, L+1]
    albedo: Any  # [S, L]
    phase_weights: Any  # [S, C, L]
    phase_params: Any  # tuple of per-component dicts (rows: [S, ...])


@dataclasses.dataclass
class SphericalMediumArrays:
    """Radially stratified medium (reference
    ``ops.tracer_spherical.SphericalMediumArrays``)."""

    radii: Any  # [L+1] shell boundary radii from the planet centre, ascending
    sigma_t: Any  # [S, L]
    sigma_majorant: Any  # [S]
    albedo: Any  # [S, L]
    phase_weights: Any  # [S, C, L]
    phase_params: Any
    #: sun slant-tau table [S, Nr, M] over (radius, local sun cosine), built
    #: without ground blockage; None keeps the exact per-event slant depth
    sun_tau: Any = None
    mu_grid: Any = None  # [M] cosine nodes of the table
    sun_r_grid: Any = None  # [Nr] uniform radius nodes of the table
    sun_mu_warp: Any = None  # (mu_c, s, a, b) floats of the cosine warp


@dataclasses.dataclass
class SurfaceArrays:
    """Surface BSDF parameters: dict name -> [S] tensor."""

    params: Any


@dataclasses.dataclass
class IlluminationArrays:
    """The emitter: ``direction`` points down into the scene (a spot's beam
    axis); ``irradiance`` is a spot's intensity; ``sky_radiance`` a constant
    sky's radiance; ``position`` a spot's origin (None otherwise)."""

    direction: Any  # [3]
    irradiance: Any  # [S]
    cos_cutoff: Any  # scalar
    sky_radiance: Any = 0.0  # [S]
    position: Any = None


@dataclasses.dataclass
class SensorArrays:
    """Distant sensor bank; ``directions`` point toward the sensor."""

    directions: Any  # [N, 3]
    target: Any  # [3] or [N, 3]
    ray_offset: Any  # scalar, NaN = at TOA
    target_extent: Any = None  # [2] or [N, 2], km


@dataclasses.dataclass
class SceneArrays:
    medium: MediumArrays
    surface: SurfaceArrays
    illumination: IlluminationArrays


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Static scene configuration (reference ``SceneConfig``)."""

    geometry: str = "plane_parallel"
    surface_kind: str = "lambertian"
    phase_kinds: tuple = ("rayleigh",)
    polarized: bool = False
    max_depth: int = 32
    rr_depth: int = 5
    planet_radius: float = 6378.1
    ground_altitude: float = 0.0
    toa_altitude: float = 120.0
    has_surface: bool = True
    lr_flight: bool = False
    sensor_at_toa: bool = True
    sampler: str = "independent"
    illumination_kind: str = "directional"
    rng: str = "pcg4d"


def _tensor(x, device, dtype=np.float32):
    """One leaf to the device: floating data as ``dtype``, strings kept. A
    tensor stays a tensor (moved and cast, so that a forward-mode dual keeps
    its tangent, as the sensitivity renders pass their perturbed leaves);
    anything else goes through ``np.asarray``."""
    if x is None or isinstance(x, str):
        return x
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            f64 = np.dtype(dtype) == np.float64
            return x.to(device=device, dtype=torch.float64 if f64 else torch.float32)
        return x.to(device=device)
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(dtype, copy=False)
    return torch.tensor(a, device=device)


def scene_dtype(medium):
    """The numpy dtype a compiled scene runs in: float64 when its
    optical-depth leaf (``tau_levels``, or ``radii`` for shells) is float64,
    as a double mode compiles it, else float32."""
    leaf = getattr(medium, "tau_levels", None)
    if leaf is None:
        leaf = medium.radii
    f64 = leaf.dtype == torch.float64 if isinstance(leaf, torch.Tensor) else (
        np.asarray(leaf).dtype == np.float64)
    return np.float64 if f64 else np.float32


def _require(what, names, params):
    missing = set(names) - set(params)
    if missing:
        raise ValueError(f"{what}: the compiled scene lacks the parameter rows {sorted(missing)}")


def from_reference(scene, sensor, config, device):
    """Turn a compiled scene into the port's tensors on ``device``.

    ``scene``/``sensor``/``config`` may be the JAX package's
    ``SceneArrays``/``SensorArrays``/``SceneConfig`` or the port's own; only
    field names are read, and every leaf goes through ``np.asarray``, but
    for a tensor, which stays one (a forward-mode dual keeps its tangent).
    Floating leaves take the scene's dtype (:func:`scene_dtype`): float64
    for a scene compiled in a double mode, float32 otherwise.
    Phase and surface parameters travel as they are, every row of every
    kind (the tabulated phase function's tables, RPV's and the polarized
    surfaces' rows); a kind of :data:`PHASE_PARAMS` or
    :data:`SURFACE_PARAMS` must carry its rows.
    A spherical-shell scene (``config.geometry == "spherical_shell"``) carries
    a :class:`SphericalMediumArrays`.
    """
    med = scene.medium
    dt = scene_dtype(med)

    def tensor(x):
        return _tensor(x, device, dt)

    for kind, params in zip(config.phase_kinds, med.phase_params):
        _require(f"phase kind {kind!r}", PHASE_PARAMS.get(kind, ()), params)
    _require(f"surface kind {config.surface_kind!r}",
             SURFACE_PARAMS.get(config.surface_kind, ()), scene.surface.params)
    common = dict(
        albedo=tensor(med.albedo),
        phase_weights=tensor(med.phase_weights),
        phase_params=tuple(
            {k: tensor(v) for k, v in p.items()} for p in med.phase_params
        ),
    )
    if config.geometry == "spherical_shell":
        warp = med.sun_mu_warp
        medium = SphericalMediumArrays(
            radii=tensor(med.radii),
            sigma_t=tensor(med.sigma_t),
            sigma_majorant=tensor(med.sigma_majorant),
            sun_tau=tensor(med.sun_tau),
            mu_grid=tensor(med.mu_grid),
            sun_r_grid=tensor(med.sun_r_grid),
            sun_mu_warp=None if warp is None else tuple(float(x) for x in warp),
            **common,
        )
    else:
        medium = MediumArrays(
            z_levels=tensor(med.z_levels),
            tau_levels=tensor(med.tau_levels),
            **common,
        )
    surface = SurfaceArrays(
        params={k: tensor(v) for k, v in scene.surface.params.items()}
    )
    il = scene.illumination
    illumination = IlluminationArrays(
        direction=tensor(il.direction),
        irradiance=tensor(il.irradiance),
        cos_cutoff=tensor(il.cos_cutoff),
        sky_radiance=tensor(il.sky_radiance),
        position=tensor(il.position),
    )
    sensor_t = SensorArrays(
        directions=tensor(sensor.directions),
        target=tensor(sensor.target),
        ray_offset=tensor(sensor.ray_offset),
        target_extent=tensor(sensor.target_extent),
    )
    config_t = SceneConfig(
        **{f.name: getattr(config, f.name) for f in dataclasses.fields(SceneConfig)}
    )
    return SceneArrays(medium, surface, illumination), sensor_t, config_t


def canopy_from_reference(leaves, leaf_params, device, tris=None, tri_params=None,
                          dtype=np.float32):
    """Leaf and triangle geometry and their optics of a compiled canopy as
    the port's tensors on ``device``: ``leaves`` is a flat cloud
    (``centers``, ``normals``, ``radii``) or an instanced one (``canonical``,
    ``offsets``), ``tris`` None, a flat soup (``v0``, ``e1``, ``e2``) or an
    instanced one, the reference's or the port's; ``leaf_params`` and
    ``tri_params`` map ``reflectance`` and ``transmittance`` to [S] rows.
    Floating leaves (disks, triangles, offsets, optics) take ``dtype``, the
    scene's (:func:`scene_dtype`): float64 in a double mode. Returns ``(leaves, leaf_params, tris,
    tri_params)``."""

    def leaf(x):
        return _tensor(x, device, dtype).contiguous()

    def cloud(c):
        return LeafCloudArrays(
            centers=leaf(c.centers), normals=leaf(c.normals), radii=leaf(c.radii)
        )

    def soup(m):
        return TriangleMeshArrays(v0=leaf(m.v0), e1=leaf(m.e1), e2=leaf(m.e2))

    def instanced(x, base, cls):
        if hasattr(x, "canonical"):
            return cls(canonical=base(x.canonical), offsets=leaf(x.offsets))
        return base(x)

    def optics(params):
        return {k: _tensor(v, device, dtype) for k, v in params.items()}

    out = instanced(leaves, cloud, InstancedLeafArrays), optics(leaf_params)
    if tris is None:
        return *out, None, None
    return *out, instanced(tris, soup, InstancedTriArrays), optics(tri_params)


def dem_from_reference(heights, x0, y0, dx, dy, device, dtype=np.float32):
    """A terrain's grid as the port's :class:`~.dem.DemArrays` on
    ``device``: ``heights`` [Ny, Nx] (a numpy array) and the grid's west and
    south edges and spacings (plain floats), each cast to ``dtype``, as the
    reference's ``DEMSurface.dem_arrays`` casts them."""
    return DemArrays(*(_tensor(np.asarray(x, dtype=dtype), device, dtype)
                       for x in (heights, x0, y0, dx, dy)))
