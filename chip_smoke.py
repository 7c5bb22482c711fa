#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

Two paths run through ``eradiate_tpu_torch.run``. BASELINE config 1
(``bench.py`` ``_c1``): a mono single-precision plane-parallel Rayleigh
atmosphere (AFGL, 550 nm) over a Lambertian surface (rho = 0.5), sun at
SZA 30, seen by a 76-angle ``mdistant`` hplane sensor at 4194304 spp.
BASELINE config 4 (``_c4``): the same column in spherical shells over a
Hapke surface, sun at SZA 75, 15 view zeniths at 2097152 spp; at SZA 85 the
sun-tau table is off and the exact NEE runs. Phases, each fatal on failure:

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
   count over the timed run must equal its bounce iterations;
6. the shell-flight and shell-event launchers in the library, and their
   ptxas reports;
7. the shell-flight (K2) and shell-event (K3) kernels against their plain
   twins on the card: the c4 column at c4's lane count, with the lanes of a
   real first event (rays from the top of the atmosphere along the 15 view
   directions) and seeded interior lanes (steep descents, grazing rays,
   tangents below the ground); the unmerged 1200-shell column; a column
   with vacuum shells; a ragged lane count. collide, layer, t_col and
   tau_sun bitwise; kernel and twin timed with CUDA events (median);
8. the port on CUDA against the port on the CPU, c4 at 15 view zeniths and
   256 spp at one seed, SZA 75 and SZA 85: every pixel within |z| <= 5,
   the median pixel within 1e-4 relative and every pixel within 5e-2 (CUDA's
   libm differs from the CPU's in the last ulp, and the event positions
   drift apart until a few paths take another branch);
9. c4 at full width, SZA 75: one warm-up run, then a timed run; shell-flight
   launches must equal event iterations;
10. the SZA 85 variant at full width (2097152 spp): shell-event launches
    must equal event iterations.

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
N_VZA_C4 = 15
SPP_C4 = 2097152
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


def _c4(sza=75.0, shell_merge_tol=1e-3):
    from eradiate_tpu_torch import AtmosphereExperiment

    return AtmosphereExperiment(
        geometry={"type": "spherical_shell", "shell_merge_tol": shell_merge_tol},
        illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0),
            "azimuth": 0.0,
            "target": [0.0, 0.0, 6378.1],
            "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
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


def _shell_inputs(exp, B, seed, vacuum=False, device="cuda"):
    """Shell-kernel operands for ``B`` lanes of c4's first spectral row: the
    first half the lanes of a real first event (rays from the top of the
    atmosphere along the view directions), the rest seeded interior states
    (steep descents, grazing rays, tangents below the ground, isotropic),
    flight caps as the tracer computes them. ``vacuum`` zeroes every third
    shell."""
    import torch

    from eradiate_tpu_torch.ops.tracer_spherical import flight_bounds, toa_rays

    m = exp.measures[0]
    scene, sensor, _ = exp.compile_scene(m, exp.spectral_context(m))
    radii = torch.tensor(scene.medium.radii, device=device)
    sigma = np.array(scene.medium.sigma_t[0])
    if vacuum:
        sigma[::3] = 0.0
    sigma = torch.tensor(sigma, device=device)
    w_sun = -torch.tensor(scene.illumination.direction, device=device)
    rng = np.random.default_rng(seed)
    n_first = B // 2
    dirs = np.asarray(sensor.directions, np.float32)
    w_v = torch.tensor(dirs[np.arange(n_first) % len(dirs)], device=device)
    target = torch.tensor(np.asarray(sensor.target, np.float32), device=device)
    p0, d0 = toa_rays(w_v, target, radii[-1])

    n = B - n_first
    r_lo, r_hi = float(radii[0]) + 1e-3, float(radii[-1]) - 1e-3
    r = rng.uniform(r_lo, r_hi, n)
    theta, phi = rng.uniform(0, np.pi / 6, n), rng.uniform(0, 2 * np.pi, n)
    up = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    iso = rng.normal(size=(n, 3))
    iso /= np.linalg.norm(iso, axis=1, keepdims=True)
    tangent = np.cross(up, iso)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    kind = np.arange(n) % 4
    d = np.where(
        (kind == 0)[:, None], -up + 0.05 * iso,  # steep descents: tangent below ground
        np.where((kind == 1)[:, None], tangent + 1e-3 * iso,  # grazing
                 np.where((kind == 2)[:, None], -up + 0.3 * iso, iso)),
    )
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p1 = torch.tensor((up * r[:, None]).astype(np.float32), device=device)
    d1 = torch.tensor(d.astype(np.float32), device=device)

    p = torch.cat([p0, p1]).contiguous()
    d = torch.cat([d0, d1]).contiguous()
    t_ground, t_exit = flight_bounds(p, d, radii)
    t_max = torch.minimum(t_ground, t_exit).contiguous()
    u = torch.tensor(rng.uniform(0, 1, B).astype(np.float32), device=device)
    tau_s = -torch.log1p(-u)
    return p, d, t_max, radii, sigma, tau_s, w_sun.contiguous()


def check_shell_kernels(name, args, timed=False):
    """K2 and K3 against their twins on the card, bitwise; returns
    ({kernel: max abs error}, {kernel: (kernel ms, twin ms)})."""
    import torch

    from eradiate_tpu_torch.kernels import shell_flight as sf

    flight_args = args[:6]
    checks = {
        "shell_flight": (sf.shell_flight, sf.shell_flight_plain, flight_args),
        "shell_event": (sf.shell_event, sf.shell_event_plain, args),
    }
    errs, times = {}, {}
    for kernel, (fn, plain, a) in checks.items():
        got, want = fn(*a), plain(*a)
        for label, g, w in zip(("collide", "t_col", "layer", "tau_sun"), got, want):
            if not torch.equal(g, w):
                gn, wn = g.cpu().numpy(), w.cpu().numpy()
                detail = f"{int((gn != wn).sum())} lanes"
                if gn.dtype == np.float32:
                    detail += f", max {int(_ulps(gn, wn).max())} ulp"
                raise AssertionError(f"{name}: {kernel} {label} differs from the twin: {detail}")
        errs[kernel] = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        if timed:
            times[kernel] = (_time_ms(lambda: fn(*a)), _time_ms(lambda: plain(*a), reps=5))
    collide = got[0].float().mean().item()
    blocked = (got[3] >= 1e9).float().mean().item()
    line = (f"  {name}: B={args[0].shape[0]} L={args[4].shape[0]} collide, t_col, "
            f"layer, tau_sun bitwise for both kernels (collide share {collide:.3f}, "
            f"ground-shadowed share {blocked:.3f})")
    for kernel, (k_ms, p_ms) in times.items():
        line += f"; {kernel} kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms"
    print(line, flush=True)
    return errs, times


def c4_cuda_vs_cpu(sza):
    """Phase 8 for one sun zenith; returns (max rel, median rel, max |z|)."""
    import eradiate_tpu_torch as etp

    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = etp.run(_c4(sza), spp=256, seed_state=etp.SeedState(SEED), device=dev)
    brf_g, brf_c = (np.asarray(out[d]["brf"]) for d in ("cuda", "cpu"))
    rad_g, rad_c = (np.asarray(out[d]["radiance"]) for d in ("cuda", "cpu"))
    var = np.asarray(out["cuda"]["var"]) + np.asarray(out["cpu"]["var"])
    rel = np.abs(brf_g - brf_c) / np.abs(brf_c)
    zmax = float(np.max(np.abs(rad_g - rad_c) / np.sqrt(var)))
    print(f"[8] c4 SZA {sza:g}, 15 VZA 256 spp, CUDA vs CPU: max rel BRF diff "
          f"{rel.max():.3e} (bound 5e-2), median {np.median(rel):.3e} (bound 1e-4), "
          f"pixels above 1e-4: {int((rel > 1e-4).sum())}, max |z| {zmax:.3e} "
          f"(bound 5)", flush=True)
    if not (np.isfinite(brf_g).all() and rel.max() <= 5e-2 and np.median(rel) <= 1e-4
            and zmax <= 5.0):
        raise AssertionError(f"CUDA and CPU runs of the port disagree on c4 at SZA {sza:g}")


def c4_full_width(sza, spp, phase):
    """Phases 9 and 10: one timed run of c4 at ``spp``; returns the launch
    counts of the run by kernel."""
    import torch

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import collision_fetch as cf
    from eradiate_tpu_torch.kernels import shell_flight as sf

    exp = _c4(sza)
    etp.run(exp, spp=spp if phase == 9 else 4096, seed_state=etp.SeedState(0), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.launches = 0
    sf.launches.update(shell_flight=0, shell_event=0)
    t0 = time.perf_counter()
    ds = etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"collision_fetch": cf.launches, **sf.launches}
    iterations = exp.measures[0].results["raw"]["iterations"]
    brf = np.asarray(ds["brf"])
    samples = N_VZA_C4 * spp
    print(f"[{phase}] c4 SZA {sza:g} full width: {N_VZA_C4} VZA x {spp} spp = {samples} "
          f"samples, wall {wall:.3f} s, {samples / wall:.4e} samples/s, "
          f"{iterations} event iterations ({1e3 * wall / iterations:.3f} ms each), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"    launches {launches}; BRF finite {bool(np.isfinite(brf).all())}, shape "
          f"{brf.shape}, BRF at VZA -5: {brf[0, 8]:.6f}", flush=True)
    kernel = "shell_flight" if sza <= 80.0 else "shell_event"
    others = [k for k in launches if k != kernel]
    if not (launches[kernel] > 0 and launches[kernel] == iterations):
        raise AssertionError(f"c4 at SZA {sza:g} did not launch {kernel} once per event")
    if any(launches[k] for k in others):
        raise AssertionError(f"c4 at SZA {sza:g} launched {others}")
    if brf.shape != (1, N_VZA_C4) or not np.isfinite(brf).all():
        raise AssertionError("c4 BRF is not finite or has the wrong shape")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device "
              "is required", file=sys.stderr)
        return 1

    import eradiate_tpu_torch as etp
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import collision_fetch as cf
    from eradiate_tpu_torch.kernels import shell_flight as sf
    from eradiate_tpu_torch.ops.tracer import REGEN_LANES_TARGET, lane_partition
    from eradiate_tpu_torch.ops.tracer_spherical import spherical_lanes_target

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
    sf.launches.update(shell_flight=0, shell_event=0)
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
    if any(sf.launches.values()):
        raise AssertionError("c1 launched a shell kernel")
    if brf.shape != (1, N_VZA) or not np.isfinite(brf).all():
        raise AssertionError("c1 BRF is not finite or has the wrong shape")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    # -- 6. the shell kernels in the library --------------------------------
    for fn in ("shell_flight_launch", "shell_event_launch"):
        getattr(lib, fn)
    blocks = report.split("ptxas info    : Compiling entry function ")
    print("[6] shell_flight and shell_event launchers loaded; ptxas:", flush=True)
    for block in blocks:
        if "shell_flight_cu" in block:
            name = block.split("'")[1]
            regs = [ln.strip() for ln in block.splitlines() if "registers" in ln or "spill" in ln]
            print(f"    {name}: {'; '.join(regs)}", flush=True)

    # -- 7. shell kernels against their twins ------------------------------
    print("[7] shell_flight and shell_event kernels against their plain twins", flush=True)
    lp = lane_partition(N_VZA_C4, SPP_C4, spherical_lanes_target(N_VZA_C4, SPP_C4, "cuda"),
                        "cpu")[0]
    B4 = N_VZA_C4 * lp
    c4_args = _shell_inputs(_c4(), B4, seed=10)
    shell_errs, shell_times = check_shell_kernels("c4 column", c4_args, timed=True)
    for name, args in (
        ("c4 column, ragged", _shell_inputs(_c4(), 100_037, seed=11)),
        ("unmerged 1200-shell column", _shell_inputs(_c4(85.0, None), 2**18, seed=12)),
        ("c4 column with vacuum shells", _shell_inputs(_c4(), 2**18, seed=13, vacuum=True)),
    ):
        errs, _ = check_shell_kernels(name, args)
        shell_errs = {k: max(v, errs[k]) for k, v in shell_errs.items()}

    # -- 8. c4: port on CUDA against port on CPU -----------------------------
    for sza in (75.0, 85.0):
        c4_cuda_vs_cpu(sza)

    # -- 9, 10. c4 at full width -------------------------------------------
    c4_launches = c4_full_width(75.0, SPP_C4, phase=9)
    c4x_launches = c4_full_width(85.0, SPP_C4, phase=10)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    def entry(name, source, replaces, n, err, ms, plain):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain}

    shell_src = "eradiate_tpu_torch/csrc/shell_flight.cu"
    print(json.dumps({"kernels": [
        entry("collision_fetch", "eradiate_tpu_torch/csrc/collision_fetch.cu",
              "eradiate_tpu/ops/pallas/collision_fetch.py:59", launches, err, kernel_ms,
              plain_ms),
        entry("shell_flight", shell_src, "eradiate_tpu/ops/pallas/shell_flight.py:405",
              c4_launches["shell_flight"], shell_errs["shell_flight"],
              *shell_times["shell_flight"]),
        entry("shell_event", shell_src, "eradiate_tpu/ops/pallas/shell_flight.py:326",
              c4x_launches["shell_event"], shell_errs["shell_event"],
              *shell_times["shell_event"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
