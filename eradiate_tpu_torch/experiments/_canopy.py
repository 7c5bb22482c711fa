"""Canopy experiments.

Port of ``eradiate_tpu/experiments/_canopy.py``: an explicit disk-leaf
canopy over a lambertian-like surface, without or with a 1D atmosphere. The
host side (leaf arrays in Morton order, leaf optics) is numpy; the render
goes to :func:`..ops.tracer_canopy.render_canopy` on one device. Leaf clouds
only: tree elements and mesh elements (triangle soups, the ``ray_tris``
kernels) and polarized transport raise ``NotImplementedError``.
"""

from __future__ import annotations

import attrs
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.modes import mode
from ..core.rng import root_seed_state
from ..ops.canopy import InstancedLeafArrays, LeafCloudArrays, morton_order
from ..ops.tracer_canopy import render_canopy
from ..scenes.biosphere import DiscreteCanopy, LeafCloud, biosphere_factory
from ..scenes.measure import TargetRectangle
from ..scenes.spectra import converter as spectrum_converter
from ._atmosphere import AtmosphereExperiment

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
        """``(cloud, leaves)``: the cloud that carries the leaf optics and
        the leaf geometry as numpy arrays, instanced where the canopy is one
        leaf cloud replicated at >= 2 positions (instances stay instances:
        leaf storage is the canonical cloud alone), else flattened."""
        canopy = self.canopy
        if self.padding > 0:
            canopy = canopy.padded_copy(self.padding)
        dtype = mode().host_dtype

        els = canopy.instanced_canopy_elements
        for el in els:
            if not isinstance(el.canopy_element, LeafCloud):
                raise NotImplementedError(
                    f"canopy element {type(el.canopy_element).__name__} (trunks and "
                    "mesh trees: triangle meshes, ray_tris kernels) is not ported yet"
                )
        if len(els) == 1 and np.atleast_2d(els[0].instance_positions).shape[0] >= 2:
            cloud = els[0].canopy_element
            leaves = InstancedLeafArrays(
                canonical=_cloud_arrays(cloud, dtype),
                offsets=np.asarray(np.atleast_2d(els[0].instance_positions), dtype=dtype),
            )
            # the caller only reads the optics spectra off this handle; no
            # need to materialise the flattened copies
            return cloud, leaves

        flat, mesh = canopy.flatten_full()
        if mesh is not None:
            raise NotImplementedError(
                "triangle meshes in canopy scenes (ray_tris kernels) are not ported yet"
            )
        return flat, _cloud_arrays(flat, dtype)

    def compile_canopy_scene(self, measure, ctx):
        """Compiled scene + canopy arrays for one measure: returns
        ``(scene, sensor, config, leaf_params, leaves, tris, tri_params)``
        with numpy leaves; ``tris`` and ``tri_params`` are None (leaf clouds
        only)."""
        flat, leaves = self._leaf_arrays()
        dtype = mode().host_dtype
        refl = spectrum_converter("reflectance")(flat.leaf_reflectance)
        trans = spectrum_converter("transmittance")(flat.leaf_transmittance)
        scene, sensor, config = self.compile_scene(measure, ctx)
        w = np.asarray(ctx["w"], dtype=np.float64)
        leaf_params = {
            "reflectance": np.asarray(refl.eval(w), dtype=dtype),
            "transmittance": np.asarray(trans.eval(w), dtype=dtype),
        }
        return scene, sensor, config, leaf_params, leaves, None, None

    def process(self, spp=None, seed_state=None, device="cuda"):
        if self.canopy is None:
            return super().process(spp=spp, seed_state=seed_state, device=device)
        dev = resolve_device(device)
        seed_state = seed_state or root_seed_state
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            scene, sensor, config, leaf_params, leaves, _, _ = self.compile_canopy_scene(
                measure, ctx
            )
            n = int(spp) if spp is not None else int(measure.spp)
            raw = render_canopy(
                scene, leaf_params, leaves, sensor, config, spp=n,
                seed=int(seed_state.next()), device=dev,
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
