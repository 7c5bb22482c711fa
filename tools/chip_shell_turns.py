#!/usr/bin/env python3
"""The shell kernels and the c4 paths of two trees, in turns, on one NVIDIA GPU.

For each tree named (the repository root, or an unpacked copy of another
commit), in the order given, one process imports that tree's
``eradiate_tpu_torch`` and ``chip_smoke`` and measures:

* the shell flight (K2), shell event (K3) and slant depth (K4) kernels on
  ``chip_smoke.py`` phase 7's lanes (the c4 column at c4's lane count, seed
  10; K4 on the event points of K2's flight): CUDA events, median of 25;
* c4 at SZA 75 (the sun-tau table, K2), c4 at SZA 85 (exact NEE, K3) and
  path B (c4 at SZA 75 through ``render_spherical`` with ``lr_flight``, K2 +
  K4) at full width (15 view zeniths x 2097152 spp): a warm-up, a timed run
  (wall time), then one more run with CUDA events around each kernel launch
  (device time a launch).

With ``--double`` it measures the float64 builds in ``mono_double``
instead: K2, K3 and K4 f64 on ``chip_smoke.py`` phase 33's lanes (the c4
column compiled in ``mono_double``; device time, ``chip_smoke._device_ms``,
median of 25), c4 at SZA 75 (exact NEE, K3 f64) and path B (K2 + K4 f64)
at full width, as above.

It prints one JSON line per turn, then the medians by tree, the card's name
and power limit, and the kernels' bounds on those lanes from this tree's
``chip_smoke.check_shell_kernels`` (``check_shell_kernels_f64`` with
``--double``; either also holds this tree's kernels against their twins
there): a bound depends on the data alone, so it is the same for every tree.

Usage, from the repository root on a machine with a card (the parent
unpacked into the git-ignored ``build/``)::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/chip_shell_turns.py build/parent . . build/parent [--double]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _here_smoke():
    """This tree's ``chip_smoke`` under another name (for its helpers, whose
    imports of the package resolve to the tree on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_turn(root, double=False):
    """Measure the tree at ``root`` (its float64 builds in ``mono_double``
    with ``double``); returns a dict of its numbers."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import dataclasses

    import torch

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.spherical import fma
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import render_spherical, spherical_lanes_target

    for mod in (cs, etp):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__
    helpers = _here_smoke()
    etp.set_mode("mono_double" if double else "mono_single")
    _build.library()
    out = {"root": root}

    lp = lane_partition(cs.N_VZA_C4, cs.SPP_C4,
                        spherical_lanes_target(cs.N_VZA_C4, cs.SPP_C4, "cuda"), "cpu")[0]
    inputs = cs._shell_inputs_f64 if double else cs._shell_inputs
    args = inputs(cs._c4(), cs.N_VZA_C4 * lp, seed=10)
    p, d, t_max, radii, sigma, _, w = args
    collide, t_col, _ = sf.shell_flight(*args[:6])
    p_event = fma(d, torch.where(collide, t_col, t_max)[:, None], p).contiguous()
    out["lanes"] = p.shape[0]
    calls = {"shell_flight": lambda: sf.shell_flight(*args[:6]),
             "shell_event": lambda: sf.shell_event(*args),
             "slant_tau": lambda: sf.slant_tau(p_event, w, radii, sigma)}
    for name, call in calls.items():
        if double:
            out[f"{name}_f64_device_ms"] = cs._device_ms(call, f"{name}_f64_kernel")[0]
        else:
            out[f"{name}_ms"] = cs._time_ms(call)

    def timed_runs(label, run, names):
        run(4096)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(cs.SPP_C4)
        torch.cuda.synchronize()
        out[f"{label}_wall_s"] = time.perf_counter() - t0
        in_run, *_ = helpers.launch_ms_in_run(lambda: run(cs.SPP_C4), names, starts=False)
        for n, (k, ms) in in_run.items():
            out[f"{label}_{n}_run_ms"] = ms
            out[f"{label}_{n}_launches"] = k

    exp75 = cs._c4(75.0)
    # a double mode has no sun-tau table: c4 at SZA 75 takes the exact NEE (K3)
    timed_runs("c4_sza75", lambda spp: etp.run(
        exp75, spp=spp, seed_state=etp.SeedState(cs.SEED), device="cuda"),
        ("shell_event",) if double else ("shell_flight",))
    if not double:
        exp = cs._c4(85.0)
        timed_runs("c4_sza85", lambda spp: etp.run(
            exp, spp=spp, seed_state=etp.SeedState(cs.SEED), device="cuda"), ("shell_event",))
    exp_b = cs._c4(75.0)
    m = exp_b.measures[0]
    scene, sensor, config = exp_b.compile_scene(m, exp_b.spectral_context(m))
    config_lr = dataclasses.replace(config, lr_flight=True)
    timed_runs("path_b", lambda spp: render_spherical(
        scene, sensor, config_lr, spp=spp, seed=cs.SEED, device="cuda"),
        ("shell_flight", "slant_tau"))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="tree roots, in turn order")
    ap.add_argument("--one", help="measure this tree in this process and print its JSON")
    ap.add_argument("--double", action="store_true", help="the float64 builds, mono_double")
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one_turn(a.one, a.double)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_shell_turns: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for tree in map(lambda t: str(Path(t).resolve()), a.trees):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree]
                              + ["--double"] * a.double, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for root in dict.fromkeys(t["root"] for t in turns):
        mine = [t for t in turns if t["root"] == root]
        keys = [k for k in mine[0] if k not in ("root", "lanes")]
        print(json.dumps({"root": root, "median_of": len(mine),
                          **{k: statistics.median(t[k] for t in mine) for k in keys}}), flush=True)

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target

    etp.set_mode("mono_double" if a.double else "mono_single")
    lp = lane_partition(cs.N_VZA_C4, cs.SPP_C4,
                        spherical_lanes_target(cs.N_VZA_C4, cs.SPP_C4, "cuda"), "cpu")[0]
    print("bounds on these lanes, this tree's kernels held against their twins:", flush=True)
    if a.double:
        cs.check_shell_kernels_f64(
            "c4 column, mono_double", cs._shell_inputs_f64(cs._c4(), cs.N_VZA_C4 * lp, seed=10),
            timed=True)
    else:
        cs.check_shell_kernels("c4 column", cs._shell_inputs(cs._c4(), cs.N_VZA_C4 * lp, seed=10),
                               timed=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
