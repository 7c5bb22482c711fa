"""eradiate_tpu_torch — the PyTorch/CUDA port of eradiate_tpu.

The port runs on one NVIDIA GPU, in the single modes (and, for the
atmosphere experiment, in the double modes, with float64 path state):

* the plane-parallel scalar path (BASELINE config 1: a Rayleigh atmosphere
  over a Lambertian surface seen by a distant sensor bank), with the
  per-bounce collision fetch as a CUDA kernel (``csrc/collision_fetch.cu``);
* the spherical-shell scalar path (config 4), with the exact shell free
  flight and shell event as CUDA kernels (``csrc/shell_flight.cu``);
* the scalar canopy path (the scene of config 5: a disk-leaf canopy, flat
  or instanced, under a Rayleigh atmosphere), with the nearest-hit and
  any-hit leaf-disk sweeps as CUDA kernels (``csrc/leaf_intersect.cu``).

The package stands alone: it imports ``torch`` and ``numpy``, never ``jax``
and nothing of ``eradiate_tpu``. Its host-side code (mode registry, seed
streams, units, scene elements, spectral and physics data, post-processing)
is a mechanical copy of the JAX package's, kept in step by
``tools/copy_host_code.py``; the device code (``ops/``, ``kernels/``,
``csrc/``) and the experiments are the port's own. Module names mirror
``eradiate_tpu`` so each piece has an obvious counterpart; ``eradiate_tpu``
stays the reference the tests hold the port against, exchanging numpy
arrays and plain Python values only.

Public surface: ``set_mode``/``mode``, ``SeedState``/``root_seed_state``,
the experiments and ``run``. Every entry point takes an explicit ``device``
("cuda" by default); asking for CUDA without a card raises instead of
running on the CPU.
"""

from .config import apply_settings as _apply_settings
from .core.modes import mode, set_mode  # noqa: F401
from .core.rng import SeedState, root_seed_state  # noqa: F401
from .experiments import (  # noqa: F401
    AtmosphereExperiment,
    CanopyAtmosphereExperiment,
    CanopyExperiment,
    run,
)

_apply_settings()

__all__ = [
    "AtmosphereExperiment",
    "CanopyAtmosphereExperiment",
    "CanopyExperiment",
    "SeedState",
    "mode",
    "root_seed_state",
    "run",
    "set_mode",
]
