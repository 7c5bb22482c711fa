#!/usr/bin/env python3
"""The collision-fetch kernel (K1) of two trees, in turns, on one NVIDIA GPU.

This script computes the operands once, on the CPU, with the repository's
``eradiate_tpu_torch.test_tools.collision_fetch``: the c1 column merged
(L = 46) and unmerged (L = 1200), K = 3, and 2,097,144 queries (the c1
path's lane count), uniform in [0, tau_top] with its ``stress_queries`` over
the head. Then, for each tree named (the repository root, or an unpacked
copy of another commit), in the order given, one process imports that
tree's ``eradiate_tpu_torch``, builds its kernels and, at both columns:

* holds the kernel against its plain twin on every lane, bit for bit, and
  counts the lanes that differ (``lanes_differ``; fatal on a lane whose
  query is not NaN: the design before the redesign took a NaN for 0);
* ``call_ms``: CUDA events around each call of the wrapper, median of 25,
  as ``chip_smoke.py`` timed it before: the stream is idle when the start
  event is recorded, so the wrapper's host time counts;
* ``device_ms``: the kernel's device time, median of 25 calls
  (``chip_smoke._device_ms``: its durations in ``torch.profiler``'s
  records, or, where the profiler dropped more than half of them, CUDA
  events around calls enqueued while the card spins; ``device_by`` says
  which); ``flushed_ms`` the same with 128 MB written before each call
  (the L2 cache flushed);
* ``graph_ms``: a CUDA graph of 25 bare launches (the library's launcher on
  preallocated outputs, the wrapper's checks run once), a replay's time
  over 25, median of 5 replays;
* the floors of ``tools/fetch_floors.cu`` (device time, the same in every
  turn): ``parent_floor_ms`` and ``redesign_floor_ms``, the design before
  the redesign (one lane a thread, blocks of 256 staging the levels) and
  the redesign (four lanes a thread, 16-byte values, blocks of 256 staging
  the search tree), each with the search and the fetch taken out.

It prints one JSON line per turn, then the medians by tree and the card's
name and power limit.

Usage, from the repository root on a machine with a card (the parent
unpacked into the git-ignored ``build/``)::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/chip_fetch_turns.py build/parent . . build/parent
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
#: The c1 path's lanes: 76 view zeniths x 27594 lanes a pixel.
LANES = 2_097_144
COLUMNS = {"L46": 1e-3, "L1200": None}


def _smoke():
    """This repository's ``chip_smoke`` (its timing helpers), whatever tree
    is on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("fetch_turns_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operands(path):
    """Write the columns' operands and queries to ``path`` (npz)."""
    import numpy as np

    sys.path.insert(0, str(REPO))
    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.test_tools.collision_fetch import column_operands, stress_queries

    etp.set_mode("mono_single")
    out = {}
    for name, tol in COLUMNS.items():
        z, tau, tables = column_operands(tol)
        out.update({f"{name}_z": z, f"{name}_tau": tau, f"{name}_tables": tables,
                    f"{name}_q": stress_queries(tau, LANES, seed=0)})
    np.savez(path, **out)


def build_floors(directory):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = Path(directory) / "libfetch_floors.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out), str(HERE / "fetch_floors.cu")],
                   check=True)
    return out


def _graph_ms(launch, reps=25, replays=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def one_turn(root, npz, floors):
    """Measure the tree at ``root``; returns a dict of its numbers."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import collision_fetch as cf

    assert Path(etp.__file__).resolve().is_relative_to(root), etp.__file__
    cs = _smoke()
    lib = _build.library()
    floor_lib = ctypes.CDLL(str(floors))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for floor in ("parent_floor", "redesign_floor"):
        getattr(floor_lib, f"{floor}_launch").argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    data = np.load(npz)
    out = {"root": root, "lanes": LANES}
    for name in COLUMNS:
        z_lv, tau_lv, tables, q = (torch.tensor(data[f"{name}_{k}"], device="cuda")
                                   for k in ("z", "tau", "tables", "q"))
        args = (q, z_lv, tau_lv, tables)
        K, L = tables.shape
        got, want = cf.collision_fetch(*args), cf.collision_fetch_plain(*args)
        differ = torch.zeros_like(q, dtype=torch.bool)
        for g, w in zip(got, want):
            differ |= (cs._bits(g) != cs._bits(w)).reshape(-1, LANES).any(dim=0)
        out[f"{name}_lanes_differ"] = int(differ.sum())
        if (differ & ~q.isnan()).any():  # the design before the redesign: NaN lanes
            raise AssertionError(f"{name}: the kernel differs from its twin on a number")
        z, layer, fetched = (torch.empty_like(t) for t in got)
        outs = (z.data_ptr(), layer.data_ptr(), fetched.data_ptr())
        ins = tuple(t.data_ptr() for t in args)

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def bare():
            rc = cf._get_launcher()(*ins, *outs, LANES, L, K, stream())
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        out[f"{name}_call_ms"] = cs._time_ms(lambda: cf.collision_fetch(*args))
        out[f"{name}_device_ms"], out[f"{name}_device_by"] = cs._device_ms(
            lambda: cf.collision_fetch(*args), "collision_fetch_kernel")
        out[f"{name}_flushed_ms"], out[f"{name}_flushed_by"] = cs._device_ms(
            lambda: cf.collision_fetch(*args), "collision_fetch_kernel", flush=True)
        out[f"{name}_graph_ms"] = _graph_ms(bare)

        for floor in ("parent_floor", "redesign_floor"):
            launch = getattr(floor_lib, f"{floor}_launch")
            args_floor = (q.data_ptr(), tau_lv.data_ptr(), *outs, LANES, L, K)

            def run():
                rc = launch(*args_floor, stream())
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            out[f"{name}_{floor}_ms"], out[f"{name}_{floor}_by"] = cs._device_ms(
                run, f"{floor}_kernel")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="tree roots, in turn order")
    ap.add_argument("--one", help="measure this tree in this process and print its JSON")
    ap.add_argument("--operands", help="(with --one) the operands' npz")
    ap.add_argument("--floors", help="(with --one) the floors' library")
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one_turn(a.one, a.operands, a.floors)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_fetch_turns: a CUDA device is required", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "operands.npz"
        operands(npz)
        floors = build_floors(tmp)
        for tree in map(lambda t: str(Path(t).resolve()), a.trees):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one", tree, "--operands",
                 str(npz), "--floors", str(floors)],
                capture_output=True, text=True, cwd=tree)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(turns[-1]), flush=True)
    for root in dict.fromkeys(t["root"] for t in turns):
        mine = [t for t in turns if t["root"] == root]
        keys = [k for k, v in mine[0].items() if isinstance(v, float)]
        print(json.dumps({"root": root, "median_of": len(mine),
                          **{k: statistics.median(t[k] for t in mine) for k in keys}}), flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
