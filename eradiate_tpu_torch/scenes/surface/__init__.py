# Host-code copy of eradiate_tpu/scenes/surface/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Surface scene elements.

Mirror of ``src/eradiate/scenes/surface/`` (factory at ``_core.py:12-18``:
basic, central_patch, dem). A surface couples a shape with a BSDF; in the
engine the 1D geometries carry an analytic ground plane/sphere, so the
surface compiles to (bsdf kind, spectral params).
"""

from __future__ import annotations

import attrs
import numpy as np

from ..bsdfs import BSDF, LambertianBSDF, bsdf_factory
from ..core import Factory, SceneElement

__all__ = ["Surface", "BasicSurface", "CentralPatchSurface", "surface_factory"]

surface_factory = Factory("surface")


def _bsdf_converter(value):
    if isinstance(value, BSDF):
        return value
    if isinstance(value, dict):
        return bsdf_factory.convert(value)
    raise TypeError(f"cannot convert {type(value)} to BSDF")


@attrs.define(eq=False, slots=False)
class Surface(SceneElement):
    """Base surface element."""

    @property
    def bsdf_kind(self) -> str:
        raise NotImplementedError

    def eval_bsdf_params(self, w_nm) -> dict:
        raise NotImplementedError


@surface_factory.register("basic")
@attrs.define(eq=False, slots=False)
class BasicSurface(Surface):
    """Shape + BSDF composite (``scenes/surface/_basic.py:18``)."""

    bsdf: BSDF = attrs.field(factory=LambertianBSDF, converter=_bsdf_converter)
    altitude: float = 0.0  # km

    @property
    def bsdf_kind(self) -> str:
        return self.bsdf.kind

    def eval_bsdf_params(self, w_nm) -> dict:
        return self.bsdf.eval_params(w_nm)


@surface_factory.register("central_patch")
@attrs.define(eq=False, slots=False)
class CentralPatchSurface(Surface):
    """Dual-BSDF surface: a central rectangular patch with its own BSDF on
    a background (``scenes/surface/_central_patch.py:37``)."""

    bsdf: BSDF = attrs.field(factory=LambertianBSDF, converter=_bsdf_converter)
    patch_bsdf: BSDF = attrs.field(factory=LambertianBSDF, converter=_bsdf_converter)
    patch_edges: float = 1.0  # km, square half-extent

    @property
    def bsdf_kind(self) -> str:
        # composite static kind: structure is part of the jit cache key
        return f"central_patch:{self.bsdf.kind}:{self.patch_bsdf.kind}"

    def eval_bsdf_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        out = {f"bg_{k}": v for k, v in self.bsdf.eval_params(w).items()}
        out.update(
            {f"patch_{k}": v for k, v in self.patch_bsdf.eval_params(w).items()}
        )
        out["patch_edges"] = np.full(w.shape, self.patch_edges)
        return out


@surface_factory.register("dem")
@attrs.define(eq=False, slots=False)
class DEMSurface(Surface):
    """Digital elevation model surface (``scenes/surface/_dem.py:475``).

    ``elevation``: [Ny, Nx] height grid [km]; ``extent``: (x0, y0, dx, dy)
    in km. The reference triangulates elevation rasters into meshes
    (``mesh_from_dem``); here the grid itself is the render primitive
    (bilinear heightfield, :mod:`eradiate_tpu.ops.dem`).
    """

    elevation: np.ndarray = attrs.field(default=None)
    x0: float = -1.0
    y0: float = -1.0
    dx: float = None
    dy: float = None
    bsdf: BSDF = attrs.field(factory=LambertianBSDF, converter=_bsdf_converter)
    #: render through the exact triangulated mesh (two triangles per
    #: cell, the reference's ``mesh_from_dem`` approach,
    #: ``scenes/surface/_dem.py:475``) instead of the marched bilinear
    #: heightfield. The mesh costs O(cells) per intersection vs the
    #: marcher's fixed step count — prefer the marcher for large grids;
    #: use the mesh as the exactness cross-gate, or for steep terrain
    #: where marching silhouettes need step-count tuning (see
    #: ops/dem.dem_intersect).
    triangulate: bool = False
    #: marcher accuracy knobs (``ops/dem.dem_intersect``): fixed-step
    #: count over each candidate segment + bisection refinements. Steep
    #: terrain at grazing sun needs enough steps that a step is shorter
    #: than the silhouette features — guidance from the triangulated
    #: cross-gate (tests/system/test_dem.py): keep
    #: ``march_steps >= 2 * t_max / min(dx, dy)`` worth of resolution on
    #: shadow rays, i.e. raise to 256+ when ``height / sigma`` exceeds
    #: ~1.5 at SZA >= 70.
    march_steps: int = 128
    bisect_steps: int = 16

    def __attrs_post_init__(self):
        self.elevation = np.atleast_2d(np.asarray(self.elevation, dtype=np.float64))
        ny, nx = self.elevation.shape
        if self.dx is None:
            self.dx = (2.0 * abs(self.x0)) / max(nx - 1, 1)
        if self.dy is None:
            self.dy = (2.0 * abs(self.y0)) / max(ny - 1, 1)

    @classmethod
    def gaussian_hill(
        cls, height_km=0.5, sigma_km=2.0, extent_km=10.0, n=65, **kwargs
    ) -> "DEMSurface":
        x = np.linspace(-extent_km / 2, extent_km / 2, n)
        xx, yy = np.meshgrid(x, x)
        h = height_km * np.exp(-(xx**2 + yy**2) / (2 * sigma_km**2))
        return cls(
            elevation=h,
            x0=-extent_km / 2,
            y0=-extent_km / 2,
            dx=x[1] - x[0],
            dy=x[1] - x[0],
            **kwargs,
        )

    @property
    def bsdf_kind(self) -> str:
        return self.bsdf.kind

    def eval_bsdf_params(self, w_nm) -> dict:
        return self.bsdf.eval_params(w_nm)

    def dem_arrays(self, dtype=np.float32):
        from ...ops.scene_state import dem_from_reference

        return dem_from_reference(
            self.elevation, self.x0, self.y0, self.dx, self.dy, "cpu", dtype
        )


def surface_converter(value):
    """Convert surfaces OR bare BSDFs (the reference accepts both,
    ``experiments/_helpers.py:62``)."""
    if isinstance(value, Surface):
        return value
    if isinstance(value, BSDF):
        return BasicSurface(bsdf=value)
    if isinstance(value, dict):
        d = dict(value)
        t = d.get("type")
        if t in surface_factory.registry:
            return surface_factory.convert(d)
        # assume it's a BSDF dict
        return BasicSurface(bsdf=bsdf_factory.convert(d))
    raise TypeError(f"cannot convert {type(value)} to Surface")
