"""Canopy experiments.

Port of ``eradiate_tpu/experiments/_canopy.py``: an explicit disk-leaf
canopy over a lambertian-like surface, without or with a 1D atmosphere. The
host side (leaf arrays in Morton order, leaf optics) is numpy; the render
goes to :func:`..ops.tracer_canopy.render_canopy` on one device (or its
sharded twin, :mod:`..parallel.render`, over a mesh), or in a
polarized mode to :func:`..ops.tracer_canopy_polarized.render_canopy_polarized`.
Canopies hold leaf clouds, abstract trees (a leaf-cloud crown on a trunk)
and mesh trees; trunks and mesh trees are triangle soups (the ``ray_tris``
kernels). The double modes render every canopy in float64, leaves and
triangles, as the reference under x64.
"""

from __future__ import annotations

import attrs
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.modes import mode
from ..core.rng import root_seed_state
from ..ops.canopy import InstancedLeafArrays, LeafCloudArrays, morton_order
from ..ops.mesh import InstancedTriArrays, mesh_from_vertices
from ..ops.tracer_canopy import render_canopy
from ..ops.tracer_canopy_polarized import render_canopy_polarized
from ..scenes.biosphere import DiscreteCanopy, LeafCloud, biosphere_factory
from ..scenes.measure import TargetRectangle
from ..scenes.spectra import converter as spectrum_converter
from ._atmosphere import AtmosphereExperiment
from ._core import resolve_mesh

__all__ = ["CanopyExperiment", "CanopyAtmosphereExperiment"]


def _canopy_converter(value):
    if value is None:
        return None
    if isinstance(value, dict):
        value = biosphere_factory.convert(value)
    if isinstance(value, LeafCloud):
        value = DiscreteCanopy(
            size=(
                float(np.ptp(value.positions[:, 0]) * 1e3),
                float(np.ptp(value.positions[:, 1]) * 1e3),
                float(np.ptp(value.positions[:, 2]) * 1e3),
            ),
            instanced_canopy_elements=[
                {"type": "instanced", "canopy_element": value}
            ],
        )
    return value


def _cloud_arrays(cloud, dtype):
    """A leaf cloud as Morton-ordered numpy arrays."""
    order = morton_order(cloud.positions)
    return LeafCloudArrays(
        centers=np.asarray(cloud.positions[order], dtype=dtype),
        normals=np.asarray(cloud.orientations[order], dtype=dtype),
        radii=np.asarray(cloud.radii[order], dtype=dtype),
    )


def _tri_arrays(mesh, dtype):
    """A mesh dict's vertices and faces as pre-differenced numpy arrays;
    the vertices are cast first, so the edges are differences in ``dtype``
    as the reference's are."""
    return mesh_from_vertices(np.asarray(mesh["vertices"], dtype=dtype), mesh["faces"])


@attrs.define(eq=False, slots=False)
class CanopyAtmosphereExperiment(AtmosphereExperiment):
    """Coupled canopy + atmosphere experiment (reference
    ``CanopyAtmosphereExperiment``). Adds a canopy and scene padding to
    :class:`AtmosphereExperiment`; the atmosphere may be None (then this
    reduces to :class:`CanopyExperiment` semantics)."""

    canopy: DiscreteCanopy | None = attrs.field(
        default=None, converter=_canopy_converter
    )
    padding: int = 0

    def __attrs_post_init__(self):
        # default distant-measure targets: the canopy-top footprint
        # rectangle, so BRF estimates average over the heterogeneous scene
        # area rather than a single point
        if self.canopy is not None:
            sx, sy, sz = (float(v) for v in self.canopy.size_km)
            for m in self.measures:
                if m.target is None and m.is_distant:
                    m.target = TargetRectangle(
                        xmin=-0.5 * sx, xmax=0.5 * sx,
                        ymin=-0.5 * sy, ymax=0.5 * sy, z=sz,
                    )
        super().__attrs_post_init__()
        if self.geometry.kind != "plane_parallel":
            raise ValueError("canopy experiments require plane-parallel geometry")

    def _leaf_arrays(self):
        """``(cloud, leaves, tris, tri_mesh)``: the cloud that carries the
        leaf optics, the leaf geometry and the triangle geometry (None
        without trunks or meshes) as numpy arrays, and the mesh dict that
        carries the wood optics. One element with leaves (a leaf cloud or a
        tree with a crown) replicated at >= 2 positions stays instanced:
        storage is the canonical cloud and the canonical soup alone, with
        shared offsets. Anything else is flattened."""
        canopy = self.canopy
        if self.padding > 0:
            canopy = canopy.padded_copy(self.padding)
        dtype = mode().host_dtype

        els = canopy.instanced_canopy_elements
        if len(els) == 1 and np.atleast_2d(els[0].instance_positions).shape[0] >= 2:
            element = els[0].canopy_element
            if isinstance(element, LeafCloud):
                cloud, tri_mesh = element, None
            else:  # tree-like: leaf_part / mesh_part protocol
                cloud = element.leaf_part()
                mp = element.mesh_part()
                tri_mesh = None
                if mp is not None:
                    v, f, r, t = mp
                    tri_mesh = {
                        "vertices": np.asarray(v),
                        "faces": np.asarray(f),
                        "reflectance": r,
                        "transmittance": t,
                    }
            if cloud is not None:
                offsets = np.asarray(np.atleast_2d(els[0].instance_positions), dtype=dtype)
                leaves = InstancedLeafArrays(
                    canonical=_cloud_arrays(cloud, dtype), offsets=offsets
                )
                tris = None
                if tri_mesh is not None:
                    tris = InstancedTriArrays(
                        canonical=_tri_arrays(tri_mesh, dtype), offsets=offsets
                    )
                # the caller only reads the optics spectra off these
                # handles; no need to materialise the flattened copies
                return cloud, leaves, tris, tri_mesh

        flat, mesh = canopy.flatten_full()
        # a canopy without a single leaf fails here, as in the reference
        leaves = _cloud_arrays(flat, dtype)
        tris = None if mesh is None else _tri_arrays(mesh, dtype)
        return flat, leaves, tris, mesh

    def compile_canopy_scene(self, measure, ctx):
        """Compiled scene + canopy arrays for one measure: returns
        ``(scene, sensor, config, leaf_params, leaves, tris, tri_params)``
        with numpy leaves and triangles in the mode's dtype (float64 in a
        double mode); ``tris`` and ``tri_params`` are None for canopies of
        leaf clouds alone."""
        flat, leaves, tris, tri_mesh = self._leaf_arrays()
        dtype = mode().host_dtype
        scene, sensor, config = self.compile_scene(measure, ctx)
        w = np.asarray(ctx["w"], dtype=np.float64)

        def optics(reflectance, transmittance):
            refl = spectrum_converter("reflectance")(reflectance)
            trans = spectrum_converter("transmittance")(transmittance)
            return {
                "reflectance": np.asarray(refl.eval(w), dtype=dtype),
                "transmittance": np.asarray(trans.eval(w), dtype=dtype),
            }

        leaf_params = optics(flat.leaf_reflectance, flat.leaf_transmittance)
        tri_params = None
        if tri_mesh is not None:
            tri_params = optics(tri_mesh["reflectance"], tri_mesh["transmittance"])
        return scene, sensor, config, leaf_params, leaves, tris, tri_params

    @staticmethod
    def _render_canopy_raw(scene, leaf_params, leaves, sensor, config, n, seed, tris,
                           tri_params, device="cuda", mesh=None):
        """One canopy render on ``device``, scalar or polarized as ``config``
        says, sharded over ``mesh`` when one is given (reference
        ``_render_canopy_raw``): the canopy counterpart of
        :meth:`._core.EarthObservationExperiment._render_one`, which
        :func:`..sensitivity.sensitivities` also calls."""
        if mesh is not None:
            from .. import parallel as par

            renderer = (par.render_canopy_polarized_sharded if config.polarized
                        else par.render_canopy_sharded)
            return renderer(
                scene, leaf_params, leaves, sensor, config, spp=n, seed=seed, mesh=mesh,
                tris=tris, tri_params=tri_params, device=device,
            )
        renderer = render_canopy_polarized if config.polarized else render_canopy
        return renderer(
            scene, leaf_params, leaves, sensor, config, spp=n, seed=seed, tris=tris,
            tri_params=tri_params, device=device,
        )

    def process(self, spp=None, seed_state=None, checkpoint_dir=None, mesh="auto",
                device="cuda"):
        """Render every measure on ``device`` (sharded over ``mesh``, as
        :func:`._core.resolve_mesh`). A canopy render is one spectral chunk,
        so ``checkpoint_dir`` has nothing to resume, as in the reference."""
        if self.canopy is None:
            return super().process(spp=spp, seed_state=seed_state,
                                   checkpoint_dir=checkpoint_dir, mesh=mesh, device=device)
        dev = resolve_device(device)
        mesh = resolve_mesh(mesh, dev)
        seed_state = seed_state or root_seed_state
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            (scene, sensor, config, leaf_params, leaves, tris,
             tri_params) = self.compile_canopy_scene(measure, ctx)
            n = int(spp) if spp is not None else int(measure.spp)
            raw = self._render_canopy_raw(
                scene, leaf_params, leaves, sensor, config, n, int(seed_state.next()), tris,
                tri_params, device=dev, mesh=mesh,
            )
            measure.results = {
                "raw": {
                    k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in raw.items()
                },
                "spectral_ctx": ctx,
            }


@attrs.define(eq=False, slots=False)
class CanopyExperiment(CanopyAtmosphereExperiment):
    """Canopy-only experiment (reference ``CanopyExperiment``): no
    atmosphere, path-integrator semantics."""

    def __attrs_post_init__(self):
        self.atmosphere = None
        super().__attrs_post_init__()
