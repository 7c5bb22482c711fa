#!/usr/bin/env python3
"""Count the lanes on which the threefry stream leaves the reference's path
in the float32 canopy tracer, and on which the port does.

For each seed, the small HET01 of the canopy tests under the Rayleigh
atmosphere (``mono_single``, 64 spp, one spectral row, ``rng="threefry"``)
is traced three ways (``tests/test_torch_samplers.threefry_canopy_lanes``):
by the reference's jitted ``trace_paths_canopy_regen``, by the reference's
bounce jitted alone and stepped on the host, and by the port. A lane
"leaves" where its sum differs from the other's by more than 1e-4
relative. Prints one line a seed and the totals. Run from the repository
root on the CPU::

    JAX_PLATFORMS=cpu python3 tools/threefry_canopy_lanes.py 32
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    seeds = int(argv[0]) if argv else 32
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    from test_torch_samplers import threefry_canopy_lanes

    def off(a, b):
        return np.nonzero(np.abs(a - b) > 1e-4 * np.abs(b) + 1e-9)[0].tolist()

    totals = [0, 0, 0]
    worst = 0.0
    lanes = 0
    for seed in range(seeds):
        loop, stepped, port = threefry_canopy_lanes(seed)
        rows = (off(stepped, loop), off(port, stepped), off(port, loop))
        worst = max(worst, float(np.max(np.abs(port - stepped) / np.maximum(stepped, 1e-30))))
        lanes += loop.size
        totals = [t + len(r) for t, r in zip(totals, rows)]
        print(f"seed {seed}: stepped reference against its loop {rows[0]}, port against the "
              f"stepped reference {rows[1]}, port against the loop {rows[2]}", flush=True)
    print(f"{seeds} seeds, {lanes} lanes: the reference's loop leaves its stepped bounce on "
          f"{totals[0]}, the port leaves the stepped bounce on {totals[1]} (largest relative "
          f"difference {worst:.3e}) and the loop on {totals[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
