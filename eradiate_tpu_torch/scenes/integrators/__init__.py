# Host-code copy of eradiate_tpu/scenes/integrators/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Integrator configuration elements.

Mirror of ``src/eradiate/scenes/integrators/`` (factory at
``_core.py:11-20``). In the TPU build there is a single wavefront engine;
integrator elements select its compile-time options: path depth, Russian
roulette start, moment (variance) output, Stokes (polarized) output.

The reference's ``piecewise_volpath`` (deterministic 1D transmittance) and
``volpath`` (null-collision tracking) distinction collapses: the engine
always uses closed-form optical-depth inversion for 1D media, which is the
piecewise integrator's defining property (SURVEY §2.1).
"""

from __future__ import annotations

import attrs

from ..core import Factory, SceneElement

__all__ = [
    "Integrator",
    "PathIntegrator",
    "VolPathIntegrator",
    "VolPathMISIntegrator",
    "PiecewiseVolPathIntegrator",
    "integrator_factory",
]

integrator_factory = Factory("integrator")


@attrs.define(eq=False, slots=False)
class Integrator(SceneElement):
    """Base integrator config (``scenes/integrators/_core.py:44-92``)."""

    max_depth: int = 32
    rr_depth: int = 5
    #: compute the 2nd moment of per-sample radiance (variance AOV); mirror
    #: of the ``moment`` wrapper (``_path_tracers.py:68-69``). The engine
    #: always tracks it — this flag controls result exposure.
    moment: bool = True
    #: polarized (Stokes) output; mirror of the ``stokes`` wrapper
    stokes: bool = False
    meridian_align: bool = True
    timeout: float | None = None


@integrator_factory.register("path")
@attrs.define(eq=False, slots=False)
class PathIntegrator(Integrator):
    """Surface-only path tracer (``_path_tracers.py:84-95``)."""


@integrator_factory.register("volpath")
@attrs.define(eq=False, slots=False)
class VolPathIntegrator(Integrator):
    """Volumetric path tracer (``_path_tracers.py:99-109``)."""


@integrator_factory.register("volpathmis")
@attrs.define(eq=False, slots=False)
class VolPathMISIntegrator(Integrator):
    """Volumetric path tracer with spectral MIS (``_path_tracers.py:113``)."""


@integrator_factory.register("piecewise_volpath")
@attrs.define(eq=False, slots=False)
class PiecewiseVolPathIntegrator(Integrator):
    """Deterministic-transmittance 1D volumetric path tracer — the
    reference's Eradiate-specific default for plane-parallel scenes
    (``_path_tracers.py:138-149``, ``experiments/_atmosphere.py:173-177``)."""
