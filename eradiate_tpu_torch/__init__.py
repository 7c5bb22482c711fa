"""eradiate_tpu_torch — the PyTorch/CUDA port of eradiate_tpu.

The port runs the plane-parallel scalar path (BASELINE config 1: a mono
single-precision Rayleigh atmosphere over a Lambertian surface seen by a
distant sensor bank) on one NVIDIA GPU, with the per-bounce collision fetch
as a hand-written CUDA kernel (``csrc/collision_fetch.cu``).

It shares the JAX package's host-side code (mode registry, seed streams,
scene elements, spectral and physics data, post-processing) and owns the
device code. Module names mirror ``eradiate_tpu`` so each piece has an
obvious counterpart; ``eradiate_tpu`` stays the reference the tests hold the
port against. The package never imports ``jax``.

Public surface: ``set_mode``/``mode``, ``SeedState``/``root_seed_state``
(the reference's own objects) and ``run``. Every entry point takes an
explicit ``device`` ("cuda" by default); asking for CUDA without a card
raises instead of running on the CPU.
"""

import os as _os

# Importing eradiate_tpu configures JAX's persistent compilation cache (and
# so imports jax) unless this setting is off; the port uses no JAX, so the
# host package is imported with it off and the environment is restored.
_KEY = "ERADIATE_TPU_COMPILATION_CACHE"
_prev = _os.environ.get(_KEY)
_os.environ[_KEY] = "0"
try:
    import eradiate_tpu  # noqa: F401
finally:
    if _prev is None:
        del _os.environ[_KEY]
    else:
        _os.environ[_KEY] = _prev

from eradiate_tpu.core.modes import mode, set_mode  # noqa: E402, F401
from eradiate_tpu.core.rng import SeedState, root_seed_state  # noqa: E402, F401

from .experiments import AtmosphereExperiment, run  # noqa: E402, F401

__all__ = [
    "AtmosphereExperiment",
    "SeedState",
    "mode",
    "root_seed_state",
    "run",
    "set_mode",
]
