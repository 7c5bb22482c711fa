# Host-code copy of eradiate_tpu/core/rng.py; regenerate with tools/copy_host_code.py, do not edit.
"""Deterministic random-stream management.

The reference uses ``np.random.SeedSequence`` spawning child seeds per render
call (``src/eradiate/rng.py:15-62``). The TPU build replaces this with JAX's
counter-based threefry keys: a root key, deterministic ``fold_in`` derivation
per (spectral chunk, sensor, device shard, pixel, sample), so every estimate
is reproducible bit-for-bit regardless of device count or batching order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SeedState", "root_seed_state"]


class SeedState:
    """Deterministic seed stream.

    ``next()`` returns successive uint32 seeds derived from the root seed,
    mirroring ``SeedState.next`` in the reference (``rng.py:47-62``); device
    code converts them to threefry keys via ``jax.random.key(seed)``.
    """

    def __init__(self, seed: int | None = None):
        if seed is None:
            seed = 0
        self._root = int(seed)
        self._counter = 0

    @property
    def root(self) -> int:
        return self._root

    def reset(self, seed: int | None = None):
        if seed is not None:
            self._root = int(seed)
        self._counter = 0

    def next(self, n: int | None = None):
        """Return the next seed (or array of n seeds)."""
        # SplitMix64-style mixing for well-distributed 32-bit seeds.
        def mix(i):
            z = (self._root + 0x9E3779B97F4A7C15 * (i + 1)) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
            return (z ^ (z >> 31)) & 0xFFFFFFFF

        if n is None:
            s = mix(self._counter)
            self._counter += 1
            return s
        out = np.array([mix(self._counter + i) for i in range(n)], dtype=np.uint32)
        self._counter += n
        return out


#: Global seed state (mirror of ``eradiate.rng.seed_state``); root seed
#: configurable via settings key ``RNG_SEED``.
root_seed_state = SeedState(0)
