"""Experiment core: compile each measure's scene, render it, post-process.

Port of ``eradiate_tpu/experiments/_core.py`` as a single-device path (no
mesh, no checkpoint): plane-parallel scenes go to :mod:`..ops.tracer`, or
to :mod:`..ops.tracer_polarized` in a polarized mode, spherical-shell scenes
to :mod:`..ops.tracer_spherical`, or to
:mod:`..ops.tracer_spherical_polarized`. The result is the same :mod:`..xr`
Dataset layout the reference returns (with the Stokes components and
``dolp`` in a polarized mode), assembled by the port's copy of
``pipelines.logic.postprocess_measure``.
"""

from __future__ import annotations

import attrs
import numpy as np
import torch

from ..core.modes import mode
from ..core.rng import root_seed_state
from ..pipelines.logic import postprocess_measure
from ..scenes.core import SceneElement
from ..scenes.illumination import (
    DirectionalIllumination,
    Illumination,
    illumination_factory,
)
from ..scenes.integrators import Integrator, integrator_factory
from ..scenes.measure import Measure, measure_factory
from ..spectral.ckd_quad import CKDQuadConfig

from ..core.device import resolve_device
from ..ops.tracer import render
from ..ops.tracer_polarized import render_polarized
from ..ops.tracer_spherical import render_spherical
from ..ops.tracer_spherical_polarized import render_spherical_polarized

__all__ = ["EarthObservationExperiment", "run", "check_mode"]


def _measures_converter(value):
    if isinstance(value, (Measure, dict)):
        value = [value]
    return [measure_factory.convert(m, Measure) for m in value]


def _illumination_converter(value):
    return illumination_factory.convert(value, Illumination)


def _integrator_converter(value):
    if value == "auto" or value is None:
        return None
    return integrator_factory.convert(value, Integrator)


#: The modes the port renders. The double modes (and the unsuffixed aliases
#: ``mono``, ``mono_polarized``, ``ckd`` and ``ckd_polarized``, which name
#: them) run their path state in float64 on every device.
SUPPORTED_MODES = (
    "mono_single", "mono_polarized_single", "ckd_single", "ckd_polarized_single",
    "mono_double", "mono_polarized_double", "ckd_double", "ckd_polarized_double",
)


def check_mode():
    """The active mode, if the port supports it."""
    m = mode()
    if m.id not in SUPPORTED_MODES:
        raise NotImplementedError(
            f"mode {m.id!r} is not ported yet (supported: {', '.join(SUPPORTED_MODES)})"
        )
    return m


@attrs.define(eq=False, slots=False)
class EarthObservationExperiment(SceneElement):
    """Experiment with directional illumination (reference
    ``EarthObservationExperiment`` and its ``Experiment`` base)."""

    measures: list = attrs.field(
        factory=lambda: [measure_factory.convert({"type": "mdistant"})],
        converter=_measures_converter,
    )
    integrator: Integrator | None = attrs.field(
        default=None, converter=_integrator_converter
    )
    ckd_quad_config: CKDQuadConfig = attrs.field(
        factory=CKDQuadConfig, converter=CKDQuadConfig.convert
    )
    #: results per measure id, filled by postprocess()
    results: dict = attrs.field(factory=dict, init=False, repr=False)
    illumination: Illumination = attrs.field(
        factory=DirectionalIllumination, converter=_illumination_converter
    )
    #: maximum spectral indices compiled into one device batch
    spectral_chunk_size: int = attrs.field(default=4096, kw_only=True)

    def spectral_context(self, measure) -> dict:
        raise NotImplementedError

    def compile_scene(self, measure, spectral_ctx):
        raise NotImplementedError

    def init(self):
        pass

    def process(self, spp=None, seed_state=None, device="cuda"):
        """Render every measure on ``device``; fills ``measure.results``
        with the raw estimates (numpy) and the spectral context."""
        dev = resolve_device(device)
        seed_state = seed_state or root_seed_state
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            n = int(spp) if spp is not None else int(measure.spp)
            raws = []
            for sub_ctx in self._chunk_spectral_ctx(ctx):
                seed = int(seed_state.next())
                scene, sensor, config = self.compile_scene(measure, sub_ctx)
                raw = self._render_one(scene, sensor, config, n, seed, device=dev)
                raws.append(
                    {
                        k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                        for k, v in raw.items()
                    }
                )
            measure.results = {"raw": self._concat_raw(raws), "spectral_ctx": ctx}

    def _chunk_spectral_ctx(self, ctx):
        S = int(np.asarray(ctx["w"]).size)
        step = max(int(self.spectral_chunk_size), 1)
        if S <= step:
            yield ctx
            return
        for start in range(0, S, step):
            sl = slice(start, min(start + step, S))
            sub = dict(ctx)
            for key in ("w", "g", "bin_index", "g_weights"):
                if key in ctx and ctx[key] is not None:
                    sub[key] = np.asarray(ctx[key])[sl]
            yield sub

    @staticmethod
    def _concat_raw(raws):
        if len(raws) == 1:
            return raws[0]
        out = {
            "spp": raws[0]["spp"],
            "iterations": sum(r["iterations"] for r in raws),
        }
        for key in raws[0]:
            if key not in out:
                out[key] = np.concatenate([np.asarray(r[key]) for r in raws], axis=0)
        return out

    def _render_one(self, scene, sensor, config, n, seed, device):
        if config.geometry == "spherical_shell":
            if config.polarized:
                return render_spherical_polarized(
                    scene, sensor, config, spp=n, seed=seed, device=device
                )
            return render_spherical(scene, sensor, config, spp=n, seed=seed, device=device)
        if config.polarized:
            return render_polarized(scene, sensor, config, spp=n, seed=seed, device=device)
        return render(scene, sensor, config, spp=n, seed=seed, device=device)

    def postprocess(self):
        for measure in self.measures:
            if not measure.results:
                continue
            mid = measure.id or f"measure_{self.measures.index(measure)}"
            self.results[mid] = postprocess_measure(
                measure,
                self.illumination,
                measure.results["raw"],
                measure.results["spectral_ctx"],
                mode(),
            )
        return self.results


def run(exp, spp=None, seed_state=None, device="cuda"):
    """Run an experiment end to end on ``device`` (reference
    ``eradiate_tpu.run`` with ``mesh=None``). Returns the first measure's
    dataset when there is one measure, else the dict of all."""
    exp.init()
    exp.process(spp=spp, seed_state=seed_state, device=device)
    exp.postprocess()
    if len(exp.results) == 1:
        return next(iter(exp.results.values()))
    return exp.results
