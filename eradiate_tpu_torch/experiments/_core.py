"""Experiment core: compile each measure's scene, render it, post-process.

Port of ``eradiate_tpu/experiments/_core.py``: plane-parallel scenes go to
:mod:`..ops.tracer`, or to :mod:`..ops.tracer_polarized` in a polarized
mode, spherical-shell scenes to :mod:`..ops.tracer_spherical`, or to
:mod:`..ops.tracer_spherical_polarized`; with a mesh (:func:`resolve_mesh`)
to their sharded twins (:mod:`..parallel.render`). A checkpoint directory
(:class:`..checkpoint.RenderCheckpoint`) keeps each completed spectral
chunk, so that an interrupted run resumes after it. The result is the same
:mod:`..xr` Dataset layout the reference returns (with the Stokes
components and ``dolp`` in a polarized mode), assembled by the port's copy
of ``pipelines.logic.postprocess_measure``.
"""

from __future__ import annotations

import time

import attrs
import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import RenderCheckpoint
from ..config import settings
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
from ..profiling import annotate, stats
from ..ops.tracer_polarized import render_polarized
from ..ops.tracer_spherical import render_spherical
from ..ops.tracer_spherical_polarized import render_spherical_polarized

__all__ = ["EarthObservationExperiment", "run", "check_mode", "resolve_mesh"]


def resolve_mesh(mesh, device="cuda"):
    """Resolve the ``mesh`` argument of ``process()``/``run()``.

    - ``"auto"`` (default): ``make_render_mesh(1, world)`` over every rank,
      on ``device``'s type, when a process group of more than one rank is
      up (:func:`..parallel.initialize`), else single-device. The ``MESH``
      setting (``ERADIATE_TPU_MESH=none``) turns sharding off.
    - ``None``: single-device renders.
    - a ``DeviceMesh`` with ("spectral", "sample") axes: used as it is.
    """
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a DeviceMesh, got {mesh!r}")
        if str(settings.get("MESH", "auto")).lower() in ("none", "off", "0"):
            return None
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return None
        from ..parallel import make_render_mesh

        return make_render_mesh(1, dist.get_world_size(), torch.device(device).type)
    return mesh


def _min_over_ranks(n):
    """The least ``n`` over the world's ranks (on the card under NCCL)."""
    dev = "cpu" if dist.get_backend() == "gloo" else torch.cuda.current_device()
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


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

    def process(self, spp=None, seed_state=None, checkpoint_dir=None, mesh="auto",
                device="cuda"):
        """Render every measure on ``device``; fills ``measure.results``
        with the raw estimates (numpy) and the spectral context.

        ``mesh`` as :func:`resolve_mesh`; ``checkpoint_dir`` keeps each
        measure's completed spectral chunks (rank 0 of the world writes, every
        rank reads), and a run with the same configuration resumes after
        the last chunk that every rank completed. Each chunk draws its seed
        also when a resume skips it, so that a resumed run equals the
        uninterrupted one."""
        dev = resolve_device(device)
        mesh = resolve_mesh(mesh, dev)
        checkpoint = None if checkpoint_dir is None else RenderCheckpoint(checkpoint_dir)
        writer = not dist.is_initialized() or dist.get_rank() == 0
        seed_state = seed_state or root_seed_state
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            n = int(spp) if spp is not None else int(measure.spp)
            raws, n_done = [], 0
            if checkpoint is not None:
                raws, n_done = checkpoint.load(measure.id, n, ctx["w"])
                if dist.is_initialized() and dist.get_world_size() > 1:
                    # a rank killed mid-loop may have read fewer chunks than
                    # the others: all resume from the fewest, so that every
                    # rank enters the same sharded renders
                    n_done = _min_over_ranks(n_done)
                    raws = raws[:n_done]
            t0 = time.perf_counter()
            n_paths_pix = 0
            for ci, sub_ctx in enumerate(self._chunk_spectral_ctx(ctx)):
                seed = int(seed_state.next())
                if ci < n_done:
                    continue
                scene, sensor, config = self.compile_scene(measure, sub_ctx)
                with annotate(f"render:{measure.id}"):
                    raw = self._render_one(scene, sensor, config, n, seed, device=dev, mesh=mesh)
                raw = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                       for k, v in raw.items()}
                n_paths_pix += int(np.asarray(sub_ctx["w"]).size * raw["radiance"].shape[1])
                raws.append(raw)
                if checkpoint is not None and writer:
                    checkpoint.save(measure.id, n, ctx["w"], raws)
            stats.record(label=f"measure:{measure.id}", wall_s=time.perf_counter() - t0,
                         spectral_size=n_paths_pix, n_pixels=1, spp=n)
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

    def _render_one(self, scene, sensor, config, n, seed, device, mesh=None):
        if mesh is not None:
            from .. import parallel as par

            if config.geometry == "spherical_shell":
                fn = (par.render_spherical_polarized_sharded if config.polarized
                      else par.render_spherical_sharded)
                return fn(scene.medium, scene.surface, scene.illumination, sensor, config,
                          spp=n, seed=seed, mesh=mesh, device=device)
            fn = par.render_polarized_sharded if config.polarized else par.render_sharded
            return fn(scene, sensor, config, spp=n, seed=seed, mesh=mesh, device=device)
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


def run(exp, spp=None, seed_state=None, checkpoint_dir=None, mesh="auto", device="cuda"):
    """Run an experiment end to end on ``device`` (reference
    ``eradiate_tpu.run``). Returns the first measure's dataset when there is
    one measure, else the dict of all.

    ``checkpoint_dir``: a directory for spectral-chunk checkpoints; an
    interrupted run called again with the same configuration resumes after
    the last completed chunk. ``mesh``: ``"auto"`` shards over every rank of
    a process group of more than one rank, ``None`` renders on one device,
    a ("spectral", "sample") ``DeviceMesh`` is used as it is
    (:func:`resolve_mesh`); sharded estimates equal single-device ones up to
    float summation order when ``spp`` divides by the sample axis.
    """
    exp.init()
    exp.process(spp=spp, seed_state=seed_state, checkpoint_dir=checkpoint_dir, mesh=mesh,
                device=device)
    exp.postprocess()
    if len(exp.results) == 1:
        return next(iter(exp.results.values()))
    return exp.results
