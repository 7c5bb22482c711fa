"""eradiate_tpu_torch — the PyTorch/CUDA port of eradiate_tpu.

The port runs on NVIDIA GPUs, in every single and double mode (the double
modes with float64 path state, through float64 builds of the kernels):

* the plane-parallel paths (BASELINE configs 1-3: Rayleigh and aerosol
  columns, mono and CKD, over every surface kind, seen by distant sensor
  banks, cameras and radiancemeters, with every sampler), with the
  per-bounce collision fetch as a CUDA kernel (``csrc/collision_fetch.cu``);
* the spherical-shell paths (config 4), with the exact shell free flight,
  shell event and slant optical depth as CUDA kernels
  (``csrc/shell_flight.cu``);
* canopies (the scene of config 5: disk-leaf clouds, abstract trees and
  mesh trees, flat or instanced, under the sun or a spot), with the
  nearest-hit and any-hit leaf-disk and triangle sweeps as CUDA kernels
  (``csrc/leaf_intersect.cu``, ``csrc/tri_intersect.cu``);
* polarized transport for all three (``mono_polarized_*``,
  ``ckd_polarized_*``);
* DEM terrain (``experiments.DEMExperiment``): the bilinear heightfield
  marched in plain PyTorch (``ops/dem.py``) or, triangulated, through the
  flat triangle sweeps;
* forward-mode sensitivities (``sensitivity.sensitivities``): BRF Jacobians
  by ``torch.autograd.forward_ad``, one pass a channel, through the
  kernels' forward rules (the collision fetch, the slant depth) and the
  shell depths of the likelihood-ratio flight, launched on the
  extinction's tangent, on every tracer family;
* sharded renders (``parallel``): every family over a ("spectral",
  "sample") mesh of ``torch.distributed`` ranks, one process a rank,
  through ``run(exp, mesh=...)``, with spectral-chunk checkpoints
  (``checkpoint``) and profiling counters (``profiling``).

The package stands alone: it imports ``torch`` and ``numpy``, never ``jax``
and nothing of ``eradiate_tpu``. Its host-side code (mode registry, seed
streams, units, scene elements, spectral and physics data, post-processing)
is a mechanical copy of the JAX package's, kept in step by
``tools/copy_host_code.py``; the device code (``ops/``, ``kernels/``,
``csrc/``) and the experiments are the port's own. Module names mirror
``eradiate_tpu`` so each piece has an obvious counterpart; ``eradiate_tpu``
stays the reference the tests hold the port against, exchanging numpy
arrays and plain Python values only.

Public surface: ``set_mode``/``mode`` (and ``Mode``, ``ModeFlag``,
``modes``), ``ureg``, ``SeedState``/``root_seed_state``, the experiments,
``run``, ``sensitivity``, ``parallel`` and ``profiling``; the command line
is ``python -m eradiate_tpu_torch.cli``. Every entry point takes an explicit ``device``
("cuda" by default); asking for CUDA without a card raises instead of
running on the CPU.
"""

from .config import apply_settings as _apply_settings
from .core.modes import Mode, ModeFlag, mode, modes, set_mode  # noqa: F401
from .core.rng import SeedState, root_seed_state  # noqa: F401
from .core.units import ureg  # noqa: F401
from .experiments import (  # noqa: F401
    AtmosphereExperiment,
    CanopyAtmosphereExperiment,
    CanopyExperiment,
    run,
)
from . import parallel, profiling, sensitivity  # noqa: F401

__version__ = "0.1.0"

_apply_settings()

__all__ = [
    "AtmosphereExperiment",
    "CanopyAtmosphereExperiment",
    "CanopyExperiment",
    "Mode",
    "ModeFlag",
    "SeedState",
    "mode",
    "modes",
    "root_seed_state",
    "run",
    "set_mode",
    "ureg",
]
