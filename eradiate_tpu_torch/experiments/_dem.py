"""DEM experiment: a 1D atmosphere over a terrain.

Port of ``eradiate_tpu/experiments/_dem.py``: an
:class:`~._atmosphere.AtmosphereExperiment` whose surface is a
:class:`~..scenes.surface.DEMSurface` renders through
:func:`..ops.tracer_dem.render_dem`, the marched heightfield or, with
``triangulate``, the triangulated grid through the triangle sweeps; with a
mesh the marched heightfield renders sharded
(:func:`..parallel.render_dem_sharded`), and the triangulated grid is
refused, as in the reference. As in the reference, each measure draws one
seed and renders all its spectral rows in one call (no spectral chunks), and
a polarized mode renders the scalar result.
"""

from __future__ import annotations

import attrs
import torch

from ..core.device import resolve_device
from ..core.modes import mode
from ..core.rng import root_seed_state
from ..ops.dem import mesh_from_dem
from ..ops.tracer_dem import render_dem
from ..scenes.surface import DEMSurface
from ._atmosphere import AtmosphereExperiment
from ._core import resolve_mesh

__all__ = ["DEMExperiment"]

#: The reference's refusal of a sharded triangulated terrain.
TRIANGULATED_SHARDED = (
    "triangulated DEM rendering is single-device only (pass mesh=None); the "
    "marched heightfield path shards"
)


@attrs.define(eq=False, slots=False)
class DEMExperiment(AtmosphereExperiment):
    """1D atmosphere + DEM surface (reference ``DEMExperiment``)."""

    def __attrs_post_init__(self):
        super().__attrs_post_init__()
        if self.geometry.kind != "plane_parallel":
            raise ValueError("DEMExperiment requires plane-parallel geometry")

    def terrain(self):
        """The terrain's arrays, made once per experiment: ``(dem, tris)``,
        the heightfield's :class:`~..ops.dem.DemArrays` and, with
        ``triangulate``, its triangulation (else None), in the mode's host
        dtype."""
        dtype = mode().host_dtype
        surface = self.surface
        tris = None
        if surface.triangulate:
            tris = mesh_from_dem(surface.elevation, surface.x0, surface.y0, surface.dx,
                                 surface.dy, dtype=dtype)
        return surface.dem_arrays(dtype=dtype), tris

    def _render_dem_raw(self, scene, terrain, sensor, config, n, seed, device="cuda",
                        mesh=None):
        """One render over the terrain ``terrain`` (:meth:`terrain`) on
        ``device``, with the surface's march and bisection steps:
        :func:`..ops.tracer_dem.render_dem`, or with ``mesh`` the marched
        heightfield through :func:`..parallel.render_dem_sharded`; which
        :func:`..sensitivity.sensitivities` also calls."""
        dem, tris = terrain
        steps = dict(n_march=self.surface.march_steps, n_bisect=self.surface.bisect_steps)
        if mesh is not None:
            from ..parallel import render_dem_sharded

            if tris is not None:
                raise NotImplementedError(TRIANGULATED_SHARDED)
            return render_dem_sharded(scene, dem, sensor, config, spp=n, seed=seed, mesh=mesh,
                                      device=device, **steps)
        return render_dem(scene, dem, sensor, config, spp=n, seed=seed, tris=tris,
                          device=device, **steps)

    def process(self, spp=None, seed_state=None, checkpoint_dir=None, mesh="auto",
                device="cuda"):
        """Render every measure on ``device``, sharded over ``mesh`` (as
        :func:`._core.resolve_mesh`) where the heightfield is marched; a
        triangulated terrain with a mesh raises. One render a measure, so
        ``checkpoint_dir`` has nothing to resume, as in the reference."""
        if not isinstance(self.surface, DEMSurface):
            return super().process(spp=spp, seed_state=seed_state,
                                   checkpoint_dir=checkpoint_dir, mesh=mesh, device=device)
        dev = resolve_device(device)
        mesh = resolve_mesh(mesh, dev)
        if mesh is not None and self.surface.triangulate:
            raise NotImplementedError(TRIANGULATED_SHARDED)
        seed_state = seed_state or root_seed_state
        terrain = self.terrain()
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            scene, sensor, config = self.compile_scene(measure, ctx)
            n = int(spp) if spp is not None else int(measure.spp)
            raw = self._render_dem_raw(
                scene, terrain, sensor, config, n, int(seed_state.next()), device=dev, mesh=mesh
            )
            measure.results = {
                "raw": {
                    k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in raw.items()
                },
                "spectral_ctx": ctx,
            }
