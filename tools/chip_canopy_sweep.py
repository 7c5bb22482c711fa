#!/usr/bin/env python3
"""Lane sweep and device-time profile of the canopy path on one NVIDIA GPU.

Runs the scene of BASELINE config 5 with the scalar integrator (HET01, 19
view zeniths, 2097152 spp; ``chip_smoke._c5``) through
``eradiate_tpu_torch.ops.tracer_canopy.render_canopy`` on CUDA, in the forms
``instanced`` and ``flat`` (leaf clouds alone), ``trees`` (crowns on
instanced trunks) and ``wood`` (leaf clouds and 92700 triangles of wood
skeletons, flattened; its mesh file is written to a temporary directory):

* ``--lanes 19 20 21 22`` renders it at each lane-count target 2^n, up the
  list and down again (so every target but the last is measured twice, and a
  drift of the host shows), for each of ``--forms``, and prints one table row
  per run: lanes, bounce iterations, wall time, path samples/s, ms per
  iteration, peak device memory;
* ``--profile`` renders it once more at the default target under
  ``torch.profiler`` and prints the device-busy share of the wall time, the
  CUDA kernels launched per iteration, and the kernels that take most of the
  device time, with the leaf and triangle sweeps' share.

Usage, from the repository root on a machine with a card::

    python3 tools/chip_canopy_sweep.py --lanes 19 20 21 22 --profile
    python3 tools/chip_canopy_sweep.py --forms trees wood --profile

The card's name and power limit are printed first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

SPP = chip_smoke.SPP_C5
N_VZA = chip_smoke.N_VZA_C5


def compiled(form, mesh_dir):
    exp = chip_smoke._c5(form, mesh_dir)
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


def render(scene, lanes_target=None, spp=None, seed=chip_smoke.SEED):
    from eradiate_tpu_torch.ops import tracer_canopy

    s, sensor, config, leaf_params, leaves, tris, tri_params = scene
    return tracer_canopy.render_canopy(
        s, leaf_params, leaves, sensor, config, spp=SPP if spp is None else spp, seed=seed,
        tris=tris, tri_params=tri_params, device="cuda", lanes_target=lanes_target,
    )


def timed(scene, lanes_target):
    import torch

    from eradiate_tpu_torch.ops.tracer import lane_partition

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render(scene, lanes_target)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lanes = N_VZA * lane_partition(N_VZA, SPP, lanes_target, "cpu")[0]
    return lanes, out["iterations"], wall, torch.cuda.max_memory_allocated() / 2**30


def sweep(form, scene, exponents):
    order = list(exponents) + list(exponents)[-2::-1]
    print(f"| form | lanes_target | lanes | iterations | wall (s) | samples/s | "
          f"ms/iteration | peak mem |  (order: {order})", flush=True)
    for n in order:
        lanes, iterations, wall, mem = timed(scene, 2**n)
        print(f"| {form} | 2^{n} | {lanes} | {iterations} | {wall:.4f} | "
              f"{N_VZA * SPP / wall:.4e} | {1e3 * wall / iterations:.3f} | {mem:.2f} GiB |",
              flush=True)


def profile(form, scene):
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = render(scene)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time, n + 1)  # device_time in us
    total_ms = sum(t for t, _ in by_name.values()) / 1e3
    iterations = out["iterations"]
    print(f"profile ({form}): wall {wall:.4f} s under the profiler, {iterations} iterations, "
          f"{len(kernels)} CUDA kernels ({len(kernels) / iterations:.0f} per iteration), device "
          f"time {total_ms:.2f} ms, busy share {total_ms / (1e3 * wall):.3f}", flush=True)
    sweeps = {name: t for name, (t, _) in by_name.items()
              if "nearest_kernel" in name or "occluded_kernel" in name}
    for what in ("leaf", "triangle"):
        # the leaf kernels are leaf_bvh_{nearest,occluded}_kernel (flat) and
        # leaf_ibvh_{nearest,occluded}_kernel (instanced); the triangle
        # kernels are bvh_{nearest,occluded}_kernel (flat) and
        # tri_ibvh_{nearest,occluded}_kernel (instanced)
        ms = sum(t for name, t in sweeps.items() if ("leaf_" in name) == (what == "leaf")) / 1e3
        print(f"  {what} sweeps: {ms:.2f} ms, {ms / total_ms:.3f} of device time", flush=True)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / 1e3:9.2f} ms  {t / 1e3 / total_ms:6.3f}  x{n:<6d} {name[:110]}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lanes", type=int, nargs="*", default=[],
                        help="lane-count targets as exponents of 2")
    parser.add_argument("--forms", nargs="*", default=["instanced", "flat"],
                        choices=["instanced", "flat", "trees", "wood"])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("a CUDA device is required", file=sys.stderr)
        return 1
    import eradiate_tpu_torch as etp

    etp.set_mode("mono_single")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as mesh_dir:
        for form in args.forms:
            scene = compiled(form, mesh_dir)
            render(scene, spp=4096, seed=0)  # builds the kernels, warms the allocator
            if args.lanes:
                sweep(form, scene, args.lanes)
            if args.profile:
                profile(form, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
