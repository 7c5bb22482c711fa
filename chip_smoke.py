#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

The main path is BASELINE config 1 (``bench.py`` ``_c1``): a mono
single-precision plane-parallel Rayleigh atmosphere (AFGL, 550 nm) over a
Lambertian surface (rho = 0.5), sun at SZA 30, seen by a 76-angle
``mdistant`` hplane sensor at 4194304 spp, run through
``eradiate_tpu_torch.run``. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build of the port's CUDA kernels from ``eradiate_tpu_torch/csrc``;
3. the collision-fetch kernel against its plain PyTorch twin on the card, at
   the main path's shapes (the merged c1 column and its lane count), on the
   unmerged 1200-layer column, on a table with flat runs, and at a ragged
   lane count: layer and fetched values bitwise, z bitwise or within 1 ulp;
   kernel and twin timed with CUDA events (median of several launches);
4. the port on CUDA against the port on the CPU, c1 at 11 view zeniths and
   256 spp at one seed: BRF within 1e-4 relative (CUDA's expf/log1pf differ
   from the CPU's in the last ulp, which can flip a rare branch), and every
   pixel within |z| <= 5 of the variances;
5. c1 at full width: one warm-up run, then a timed run; the kernel's launch
   count over the timed run must equal its bounce iterations.

It prints a ``{"kernels": [...]}`` line and the ``nvidia-smi`` line before
the last line, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_VZA = 76
SPP_C1 = 4194304
SEED = 1


def _c1(n_vza, layer_merge_tol=1e-3):
    from eradiate_tpu_torch import AtmosphereExperiment

    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "id": "m",
        },
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        geometry={"type": "plane_parallel", "layer_merge_tol": layer_merge_tol},
    )


def _fetch_inputs(exp, device="cuda"):
    """The collision-fetch operands of the tracer's first spectral row."""
    import torch

    from eradiate_tpu_torch.ops.phase_ops import layer_param_slots

    m = exp.measures[0]
    scene, _, config = exp.compile_scene(m, exp.spectral_context(m))
    med = scene.medium
    params = tuple({k: v[0] for k, v in p.items()} for p in med.phase_params)
    extra, _ = layer_param_slots(config.phase_kinds, params)
    tables = np.stack([med.albedo[0], *med.phase_weights[0], *extra])
    return [
        torch.tensor(a, device=device)
        for a in (med.z_levels, med.tau_levels[0], np.ascontiguousarray(tables))
    ]


def _queries(tau, n, seed):
    """n sampled optical depths: uniform in [0, tau_top] with the edges
    (0, tau_top, every level, one ulp either side) written over the head."""
    tau = tau.cpu().numpy()
    q = np.random.default_rng(seed).uniform(0.0, tau[-1], n).astype(np.float32)
    edges = np.concatenate(
        [[0.0, tau[-1]], tau, np.nextafter(tau, np.float32(np.inf)),
         np.nextafter(tau[1:], np.float32(0.0))]
    ).astype(np.float32)
    k = min(n, edges.size)
    q[:k] = edges[:k]
    return q


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def _time_ms(fn, reps=25):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_collision_fetch(name, z_levels, tau_levels, tables, B, seed, timed=False):
    """Kernel vs twin on the card; returns (max |dz|, kernel ms, twin ms)."""
    import torch

    from eradiate_tpu_torch.kernels import collision_fetch as cf

    q = torch.tensor(_queries(tau_levels, B, seed), device=tau_levels.device)
    args = (q, z_levels, tau_levels, tables)
    got = cf.collision_fetch(*args)
    want = cf.collision_fetch_plain(*args)
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{name}: layer indices differ from the twin")
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"{name}: fetched values differ from the twin")
    za, zb = got[0].cpu().numpy(), want[0].cpu().numpy()
    ulps = int(_ulps(za, zb).max())
    if ulps > 1:
        raise AssertionError(f"{name}: z differs from the twin by {ulps} ulp")
    err = float(np.max(np.abs(za - zb)))
    line = (f"  {name}: B={B} L={tables.shape[1]} K={tables.shape[0]} layer and "
            f"fetched bitwise, z max ulp {ulps}")
    if ulps:
        line += " (rounding of the interpolation differs by one ulp)"
    kernel_ms = plain_ms = None
    if timed:
        kernel_ms = _time_ms(lambda: cf.collision_fetch(*args))
        plain_ms = _time_ms(lambda: cf.collision_fetch_plain(*args))
        line += f"; kernel {kernel_ms:.4f} ms, twin {plain_ms:.4f} ms (median)"
    print(line, flush=True)
    return err, kernel_ms, plain_ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device "
              "is required", file=sys.stderr)
        return 1

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import collision_fetch as cf
    from eradiate_tpu_torch.ops.tracer import REGEN_LANES_TARGET, lane_partition

    etp.set_mode("mono_single")

    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[1] card: {smi}", flush=True)
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s: "
          f"{lib._name}", flush=True)
    report = Path(lib._name).with_suffix(".log").read_text().strip()
    print("    " + report.replace("\n", "\n    "), flush=True)

    # -- 3. kernel against twin ---------------------------------------------
    print("[3] collision_fetch kernel against its plain twin", flush=True)
    c1_fetch = _fetch_inputs(_c1(N_VZA))
    lp = lane_partition(N_VZA, SPP_C1, REGEN_LANES_TARGET["cuda"], "cpu")[0]
    B = N_VZA * lp
    err, kernel_ms, plain_ms = check_collision_fetch(
        "c1 merged column", *c1_fetch, B, seed=0, timed=True
    )
    check_collision_fetch("c1 merged column, ragged", *c1_fetch, B + 37, seed=1)
    check_collision_fetch(
        "unmerged 1200-layer column", *_fetch_inputs(_c1(N_VZA, None)), B, seed=2,
        timed=True,
    )
    flat_tau = np.concatenate([[0.0], np.cumsum([0.1, 0, 0, 0.3, 0.2, 0, 0.5])])
    flat = [
        torch.tensor(np.asarray(a, np.float32), device="cuda")
        for a in (np.arange(8.0), flat_tau,
                  np.random.default_rng(3).uniform(size=(3, 7)))
    ]
    check_collision_fetch("7-layer table with flat runs", *flat, 1000, seed=3)

    # -- 4. port on CUDA against port on CPU ----------------------------------
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = etp.run(_c1(11), spp=256, seed_state=etp.SeedState(SEED), device=dev)
    brf_g, brf_c = (np.asarray(out[d]["brf"]) for d in ("cuda", "cpu"))
    rad_g, rad_c = (np.asarray(out[d]["radiance"]) for d in ("cuda", "cpu"))
    var = np.asarray(out["cuda"]["var"]) + np.asarray(out["cpu"]["var"])
    rel = float(np.max(np.abs(brf_g - brf_c) / np.abs(brf_c)))
    zmax = float(np.max(np.abs(rad_g - rad_c) / np.sqrt(var)))
    print(f"[4] c1 11 VZA 256 spp, CUDA vs CPU: max rel BRF diff {rel:.3e} "
          f"(bound 1e-4), max |z| {zmax:.3e} (bound 5)", flush=True)
    if not (np.isfinite(brf_g).all() and rel <= 1e-4 and zmax <= 5.0):
        raise AssertionError("CUDA and CPU runs of the port disagree")

    # -- 5. c1 at full width --------------------------------------------------
    exp = _c1(N_VZA)
    etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.launches = 0
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=SPP_C1, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cf.launches
    iterations = exp.measures[0].results["raw"]["iterations"]
    brf = np.asarray(ds["brf"])
    vza = np.asarray(ds["vza"])
    nadir = int(np.argmin(np.abs(vza)))
    samples = N_VZA * SPP_C1
    print(f"[5] c1 full width: {N_VZA} VZA x {SPP_C1} spp = {samples} samples, "
          f"{lp} lanes/pixel ({N_VZA * lp} lanes), wall {wall:.3f} s, "
          f"{samples / wall:.4e} samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    collision_fetch launches {launches}, bounce iterations "
          f"{iterations}; BRF finite {bool(np.isfinite(brf).all())}, shape "
          f"{brf.shape}, BRF at VZA {vza[nadir]:.2f}: {brf[0, nadir]:.6f}; "
          f"jax imported: {'jax' in sys.modules}", flush=True)
    if not (launches > 0 and launches == iterations):
        raise AssertionError("the main path did not run through the kernel once per bounce")
    if brf.shape != (1, N_VZA) or not np.isfinite(brf).all():
        raise AssertionError("c1 BRF is not finite or has the wrong shape")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [{
        "name": "collision_fetch",
        "route": "cuda",
        "source": "eradiate_tpu_torch/csrc/collision_fetch.cu",
        "replaces": "eradiate_tpu/ops/pallas/collision_fetch.py:59",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
