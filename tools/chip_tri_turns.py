#!/usr/bin/env python3
"""The instanced triangle kernels and the ``c5_trees`` path of two trees, in turns, on one NVIDIA GPU.

For each tree named (the repository root, or an unpacked copy of another
commit), in the order given, one process imports that tree's
``eradiate_tpu_torch`` and ``chip_smoke`` and measures, on that tree's own
cull operands (its ``ops.mesh.tri_accel`` and ``ops.canopy.leaf_accel``):

* the instanced triangle kernels (K9) on ``chip_smoke.py`` phase 16's lanes
  of ``c5_trees`` (the trunks, N = 36, I = 15, at the path's lane count,
  seed 30), and the instanced leaf kernels (K7, the control) on the same
  scene's leaf lanes: CUDA events around each call, median of 25, and,
  where the tree's ``chip_smoke`` has ``_device_ms``, the kernel's device
  time (``*_device_ms``); and K9's floors on those lanes: ``empty``, every
  cap 0, so that a lane loads its ray and stores its result and visits
  nothing; ``unreached``, the instances moved 1000 km
  up (the tree's own cull operand for them), so that a lane tests the top
  level's root and reaches nothing;
* K9 on the wood skeleton as canonical soup (N = 6180, I = 15) and the flat
  triangle kernels (K8) on the same 92700 triangles flattened, on the rays
  of ``chip_smoke.instanced_against_flat``: the same;
* ``c5_trees`` at full width (19 view zeniths x 2097152 spp): a warm-up, a
  timed run (wall time), then one more run with CUDA events around each K9
  launch (device time a launch).

It prints one JSON line per turn, then the medians by tree and the card's
name and power limit.

Usage, from the repository root on a machine with a card (the parent
unpacked into the git-ignored ``build/``)::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/chip_tri_turns.py build/parent . . build/parent
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

K9 = ("ray_tris_nearest_instanced", "ray_tris_occluded_instanced")


def one_turn(root):
    """Measure the tree at ``root``; returns a dict of its numbers."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import leaf_intersect as li
    from eradiate_tpu_torch.kernels import tri_intersect as ti
    from eradiate_tpu_torch.ops import mesh
    from eradiate_tpu_torch.ops.canopy import InstancedLeafArrays
    from eradiate_tpu_torch.ops.tracer_canopy import LANES_TARGET
    from eradiate_tpu_torch.ops.tracer import lane_partition
    from eradiate_tpu_torch.scenes.shapes import FileMeshShape

    for mod in (cs, etp):
        assert Path(mod.__file__).resolve().is_relative_to(root), mod.__file__
    etp.set_mode("mono_single")
    _build.library()
    out = {"root": root}
    lp = lane_partition(cs.N_VZA_C5, cs.SPP_C5, LANES_TARGET["cuda"], "cpu")[0]
    B5 = cs.N_VZA_C5 * lp
    out["lanes"] = B5

    exp = cs._c5("trees")
    leaves, leaf_cull, leaf_rays, tris, tri_cull, tri_rays = cs._canopy_inputs(exp, B5, seed=30)
    assert isinstance(leaves, InstancedLeafArrays) and isinstance(tris, mesh.InstancedTriArrays)
    c = tris.canonical
    tri_args = (*tri_rays, c.v0, c.e1, c.e2, tris.offsets, tri_cull)
    lc = leaves.canonical
    leaf_args = (*leaf_rays, lc.centers, lc.normals, lc.radii, leaves.offsets, leaf_cull)
    far = mesh.InstancedTriArrays(c, tris.offsets + torch.tensor([0.0, 0.0, 1000.0],
                                                                 device="cuda"))
    floors = {"empty": (*tri_rays[:2], torch.zeros_like(tri_rays[2]), *tri_args[3:]),
              "unreached": (*tri_rays, c.v0, c.e1, c.e2, far.offsets, mesh.tri_accel(far)[0])}
    # device time where the tree's chip_smoke has it
    device = getattr(cs, "_device_ms", None)
    for name in K9:
        out[f"{name}_ms"] = cs._time_ms(lambda: getattr(ti, name)(*tri_args))
        if device:
            out[f"{name}_device_ms"] = device(lambda: getattr(ti, name)(*tri_args),
                                              cs.KERNELS[name])[0]
        for floor, args in floors.items():
            out[f"{name}_{floor}_ms"] = cs._time_ms(lambda: getattr(ti, name)(*args))
            if device:
                out[f"{name}_{floor}_device_ms"] = device(lambda: getattr(ti, name)(*args),
                                                          cs.KERNELS[name])[0]
    for name in ("ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced"):
        out[f"{name}_ms"] = cs._time_ms(lambda: getattr(li, name)(*leaf_args))
        if device:
            out[f"{name}_device_ms"] = device(lambda: getattr(li, name)(*leaf_args),
                                              cs.KERNELS[name])[0]

    with tempfile.TemporaryDirectory() as mesh_dir:
        wood = cs._c5("wood", mesh_dir)
        *_, flat, flat_bvh, rays = cs._canopy_inputs(wood, B5, seed=30)
        v, f = FileMeshShape(filename=cs._wood_obj(mesh_dir), mesh_units="m").triangles()
        soup = mesh.mesh_from_vertices(v.astype(np.float32), f)
        to_dev = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
        canon = mesh.TriangleMeshArrays(to_dev(soup.v0), to_dev(soup.e1), to_dev(soup.e2))
        offsets = to_dev(np.atleast_2d(wood.canopy.instanced_canopy_elements[1].instance_positions))
        t0 = time.perf_counter()
        cull = mesh.tri_accel(mesh.InstancedTriArrays(canon, offsets))[0]
        torch.cuda.synchronize()
        out["skeleton_cull_build_s"] = time.perf_counter() - t0
        inst_args = (*rays, canon.v0, canon.e1, canon.e2, offsets, cull)
        flat_args = (*rays, flat.v0, flat.e1, flat.e2, flat_bvh)
        for name in K9:
            out[f"skeleton_{name}_ms"] = cs._time_ms(lambda: getattr(ti, name)(*inst_args))
        for name in ("ray_tris_nearest", "ray_tris_occluded"):
            out[f"skeleton_flat_{name}_ms"] = cs._time_ms(lambda: getattr(ti, name)(*flat_args))

    def run():
        return etp.run(exp, spp=cs.SPP_C5, seed_state=etp.SeedState(cs.SEED), device="cuda")

    etp.run(exp, spp=4096, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = run()
    torch.cuda.synchronize()
    out["c5_trees_wall_s"] = time.perf_counter() - t0
    out["c5_trees_brf_nadir"] = float(np.asarray(ds["brf"])[0, cs.N_VZA_C5 // 2])
    events = {n: [] for n in K9}
    saved = {n: getattr(mesh, n) for n in K9}

    def timed(name, fn):
        def call(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            result = fn(*args)
            end.record()
            events[name].append((start, end))
            return result
        return call

    for n in K9:
        setattr(mesh, n, timed(n, saved[n]))
    try:
        run()
    finally:
        for n, fn in saved.items():
            setattr(mesh, n, fn)
    torch.cuda.synchronize()
    for n, ev in events.items():
        out[f"c5_trees_{n}_launches"] = len(ev)
        out[f"c5_trees_{n}_run_ms"] = statistics.fmean(a.elapsed_time(b) for a, b in ev)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="tree roots, in turn order")
    ap.add_argument("--one", help="measure this tree in this process and print its JSON")
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one_turn(a.one)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_tri_turns: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for tree in map(lambda t: str(Path(t).resolve()), a.trees):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree],
                              capture_output=True, text=True, cwd=tree)
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
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
