"""Dry run of the sharded renders: spawn ranks, render, write the results.

::

    python -m eradiate_tpu_torch.parallel.dryrun --ranks 4 --mesh 2x2,1x4 \\
        --device cpu --backend gloo --out DIR

spawns ``--ranks`` processes (``torch.multiprocessing``), which meet through
a ``file://`` store under ``DIR`` (no port to pick: several dry runs may run
at once on one host) and start the process group with
:func:`.multihost.initialize`. Then, on each ("spectral", "sample") mesh of
``--mesh``, every family renders a small step at one seed through the entry
points a user calls (``run(exp, mesh=...)``, ``sensitivities(..., mesh=...)``),
sharded, and once unsharded (``mesh=None``, each case on one rank), and rank
0 writes one ``.npz`` a case: ``<case>-<mesh>.npz`` (``<mesh>`` ``single``
for the unsharded render), whose arrays :func:`compare` holds together.

``--cases`` picks what runs: ``families`` (the above, and the forward-mode
reduction, the structured sampler, the ``auto`` mesh, and plane-parallel
at S = 2 rows and ``spp`` 33), ``checkpoint`` (ranks sharing one checkpoint
directory, and ranks resuming with unequal progress) or ``c1`` (BASELINE
config 1 at full width, ``--spp`` samples a rank, sharded only, each rank's
wall printed). ``--device`` is ``cpu``, ``cuda`` (rank ``r`` on card ``r``)
or ``cuda:<index>`` (every rank on that card, which only gloo allows); on
the CPU each rank runs one thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import read_launches, reset_launches

__all__ = ["main", "run_ranks", "compare", "experiment", "atmosphere_kwargs",
           "canopy_kwargs", "SEED", "FAMILIES"]

SEED = 11

#: family case -> (mode, spp): every spp divides by the sample axes the tests
#: use (1, 2 and 4), so that sharded and unsharded renders trace as many
FAMILIES = {
    "plane_parallel": ("mono_single", 64),
    "polarized": ("mono_polarized_single", 64),
    "spherical": ("mono_single", 32),
    "spherical_polarized": ("mono_polarized_single", 16),
    "canopy": ("mono_single", 32),
    "canopy_polarized": ("mono_polarized_single", 16),
    "dem": ("mono_single", 32),
    "stratified": ("mono_single", 64),
    "sensitivity": ("mono_single", 64),
}

#: the spectral rows of every case (two, so that a spectral axis of 2 splits them)
WAVELENGTHS = [500.0, 600.0]


def _measure(zeniths, **kw):
    return {"type": "mdistant", "construct": "hplane", "zeniths": list(zeniths),
            "azimuth": 0.0, "id": "m",
            "srf": {"type": "multi_delta", "wavelengths": WAVELENGTHS}, **kw}


def atmosphere_kwargs(case):
    """The arguments of a plane-parallel or spherical case's experiment:
    three views of two wavelengths (the structured sampler with
    ``stratified``), plain data, so that the tests build the reference's
    experiment from them."""
    stokes = {"type": "volpath", "stokes": True}
    if case in ("plane_parallel", "polarized", "stratified", "sensitivity"):
        measure = _measure([-60.0, 0.0, 60.0])
        if case == "stratified":
            measure["sampler"] = "stratified"
        return dict(
            illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
            measures=measure, surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "molecular"},
            integrator=stokes if case == "polarized" else None,
        )
    return dict(
        geometry="spherical_shell",
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
        measures=_measure([-45.0, 0.0, 45.0], target=[0.0, 0.0, 6378.1]),
        surface={"type": "hapke"}, atmosphere={"type": "molecular"},
        integrator=stokes if case == "spherical_polarized" else None,
    )


def experiment(case):
    """The port's experiment of a family case, small."""
    import eradiate_tpu_torch as etp

    if case.startswith("canopy"):
        from ..scenes import biosphere

        integrator = {"type": "volpath", "stokes": case == "canopy_polarized"}
        return etp.CanopyAtmosphereExperiment(**canopy_kwargs(biosphere, integrator))
    if case == "dem":
        from ..experiments import DEMExperiment
        from ..scenes.surface import DEMSurface

        surface = DEMSurface.gaussian_hill(
            height_km=1.0, sigma_km=1.0, extent_km=10.0, n=17,
            bsdf={"type": "lambertian", "reflectance": 0.5},
        )
        return DEMExperiment(
            illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
            measures=_measure([-45.0, 0.0, 45.0]), surface=surface,
            atmosphere={"type": "molecular"},
        )
    if case not in FAMILIES:
        raise ValueError(f"unknown case {case!r}")
    return etp.AtmosphereExperiment(**atmosphere_kwargs(case))


def canopy_kwargs(bio, integrator):
    """The small HET01 (one 200-leaf sphere cloud at three positions in a
    30 m x 30 m x 15 m canopy) under a Rayleigh atmosphere, five views of
    two wavelengths; ``bio`` is a package's ``scenes.biosphere``, so that
    the tests build the reference's scene from the same arguments."""
    cloud = bio.LeafCloud.sphere(
        n_leaves=200, leaf_radius=0.4, radius=5.0, center=(0.0, 0.0, 10.0),
        leaf_reflectance=0.4957, leaf_transmittance=0.4409,
    )
    positions = np.array([[-8.0, -5.0, 0.0], [6.0, -7.0, 0.0], [1.0, 8.0, 0.0]]) * 1e-3
    return dict(
        canopy=bio.DiscreteCanopy(size=(30.0, 30.0, 15.0), instanced_canopy_elements=[
            {"type": "instanced", "canopy_element": cloud, "instance_positions": positions}]),
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures=_measure(np.linspace(-75.0, 75.0, 5)),
        surface={"type": "lambertian", "reflectance": 0.159},
        atmosphere={"type": "molecular", "has_absorption": False},
        integrator=integrator,
    )


def c1_experiment():
    """BASELINE config 1 (``bench.py`` ``_c1``): 76 views over the merged
    AFGL Rayleigh column, Lambertian 0.5, SZA 30."""
    import eradiate_tpu_torch as etp

    return etp.AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, 76), "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        geometry={"type": "plane_parallel", "layer_merge_tol": 1e-3},
    )


def _raw(exp):
    return {k: np.asarray(v) for k, v in exp.measures[0].results["raw"].items()}


def render_case(case, mesh, device):
    """One family case through its entry point: the first measure's raw
    results (sensitivities: the value and the Jacobian)."""
    import eradiate_tpu_torch as etp
    from ..sensitivity import sensitivities

    mode, spp = FAMILIES[case]
    etp.set_mode(mode)
    exp = experiment(case)
    reset_launches()
    if case == "sensitivity":
        entry = sensitivities(exp, ["surface.reflectance"], spp=spp, seed=SEED, mesh=mesh,
                              device=device)["m"]
        jac = entry["jac"]["surface.reflectance"]
        out = {"radiance": entry["radiance"], "brf": entry["brf"],
               "jac_radiance": jac["radiance"], "jac_brf": jac["brf"]}
    else:
        etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), mesh=mesh, device=device)
        out = _raw(exp)
    return {**out, **_launched()}


def _launched():
    """This rank's kernel launches since the last reset, those it made:
    ``{"launches_<kernel>": n}``."""
    return {f"launches_{k}": n for k, n in read_launches().items() if n}


def _save(out, name, arrays):
    np.savez(Path(out) / f"{name}.npz", **{k: np.asarray(v) for k, v in arrays.items()})


def _agree(arrays, group=None):
    """Whether every rank of ``group`` holds the same arrays (each rank
    returns the whole result)."""
    import torch.distributed as dist

    flat = np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for _, v in
                           sorted(arrays.items()) if np.asarray(v).dtype.kind == "f"])
    dev = "cpu" if dist.get_backend() == "gloo" else torch.cuda.current_device()
    mine = torch.tensor(flat, dtype=torch.float64, device=dev)
    lo, hi = mine.clone(), mine.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(lo, hi))


def _dual_case(mesh, device):
    """The sum of a dual over the sample axis, and the gather of one over
    the spectral axis: rank ``(c, r)`` holds primal ``c + r + 1`` and tangent
    ``10 (c + r + 1)``."""
    import torch.autograd.forward_ad as fwAD

    from .render import gather_rows, reduce_sum

    c, r = mesh.get_coordinate()
    v = float(c + r + 1)
    with fwAD.dual_level():
        x = fwAD.make_dual(torch.full((2, 3), v, device=device),
                           torch.full((2, 3), 10.0 * v, device=device))
        summed = fwAD.unpack_dual(reduce_sum(x, mesh.get_group("sample")))
        gathered = fwAD.unpack_dual(gather_rows(x, mesh.get_group("spectral")))
    return {"coordinate": np.asarray([c, r]),
            "sum_primal": summed.primal.cpu(), "sum_tangent": summed.tangent.cpu(),
            "gather_primal": gathered.primal.cpu(), "gather_tangent": gathered.tangent.cpu()}


def _families(rank, world, meshes, device, out):
    """Every family sharded on every mesh, then unsharded, each case on one
    rank; rank 0 writes the sharded results."""
    import torch.distributed as dist

    import eradiate_tpu_torch as etp
    from ..experiments._core import resolve_mesh
    from .render import make_render_mesh, render_sharded

    dev_type = torch.device(device).type
    for shape in meshes:
        tag = "x".join(map(str, shape))
        mesh = make_render_mesh(*shape, device_type=dev_type)
        for case in FAMILIES:
            arrays = render_case(case, mesh, device)
            arrays["ranks_agree"] = _agree(arrays)
            if rank == 0:
                _save(out, f"{case}-{tag}", arrays)
        # S = 2 rows at spp 33: every rank traces ceil(33 / n_sample) a pixel
        etp.set_mode("mono_single")
        exp = experiment("plane_parallel")
        scene, sensor, config = exp.compile_scene(exp.measures[0],
                                                  exp.spectral_context(exp.measures[0]))
        res = render_sharded(scene, sensor, config, 33, seed=SEED, mesh=mesh, device=device)
        if rank == 0:
            _save(out, f"spp33-{tag}", {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                                        for k, v in res.items()})
        dual = _dual_case(mesh, device)
        gathered = [None] * world
        dist.all_gather_object(gathered, {k: np.asarray(v) for k, v in dual.items()})
        if rank == 0:
            _save(out, f"dual-{tag}", {f"r{i}_{k}": v for i, g in enumerate(gathered)
                                       for k, v in g.items()})
    # the auto mesh: every rank of the world on the sample axis, unless the
    # MESH setting turns sharding off
    etp.set_mode("mono_single")
    saved = os.environ.pop("ERADIATE_TPU_MESH", None)
    try:
        auto = resolve_mesh("auto", device)
        auto_shape = tuple(auto.shape)
        exp = experiment("plane_parallel")
        etp.run(exp, spp=FAMILIES["plane_parallel"][1], seed_state=etp.SeedState(SEED),
                mesh="auto", device=device)
        auto_raw = _raw(exp)
        os.environ["ERADIATE_TPU_MESH"] = "none"
        off = resolve_mesh("auto", device)
    finally:
        os.environ.pop("ERADIATE_TPU_MESH", None)
        if saved is not None:
            os.environ["ERADIATE_TPU_MESH"] = saved
    if rank == 0:
        _save(out, "auto", {**auto_raw, "shape": np.asarray(auto_shape),
                            "off_is_none": off is None})
    # unsharded: case i on rank i % world, with no collective
    for i, case in enumerate(FAMILIES):
        if i % world == rank:
            _save(out, f"{case}-single", render_case(case, None, device))
    dist.barrier()


def _checkpoint(rank, world, device, out):
    """Ranks sharing one checkpoint directory (rank 0 writes, every rank
    reads), and ranks resuming from their own directories with unequal
    progress (every rank resumes from the fewest chunks)."""
    import torch.distributed as dist

    import eradiate_tpu_torch as etp
    from ..checkpoint import RenderCheckpoint
    from .render import make_render_mesh

    etp.set_mode("mono_single")
    mesh = make_render_mesh(1, world, torch.device(device).type)
    spp = FAMILIES["plane_parallel"][1]

    def run(checkpoint_dir):
        exp = experiment("plane_parallel")
        exp.spectral_chunk_size = 1  # one spectral chunk a wavelength
        etp.run(exp, spp=spp, seed_state=etp.SeedState(SEED), checkpoint_dir=checkpoint_dir,
                mesh=mesh, device=device)
        return exp, _raw(exp)

    shared = Path(out) / "shared"
    exp, full = run(shared)
    dist.barrier()
    files = sorted(p.name for p in shared.iterdir())
    # every rank's directory holds the first chunk only, rank 0's both
    own = Path(out) / f"own{rank}"
    own.mkdir(parents=True, exist_ok=True)
    ctx = exp.spectral_context(exp.measures[0])
    raws, _ = RenderCheckpoint(shared).load("m", spp, ctx["w"])
    RenderCheckpoint(own).save("m", spp, ctx["w"], raws if rank == 0 else raws[:1])
    dist.barrier()
    _, resumed = run(own)
    arrays = {"shared_files": np.asarray(files), "agree": _agree(resumed),
              **{f"full_{k}": v for k, v in full.items()},
              **{f"resumed_{k}": v for k, v in resumed.items()}}
    if rank == 0:
        _save(out, "checkpoint", arrays)
    dist.barrier()


def _c1(rank, world, device, out, spp, seed):
    """BASELINE config 1 at full width, ``spp`` samples a rank, sharded over
    every rank, at ``seed``; each rank's wall printed."""
    import eradiate_tpu_torch as etp
    from .render import make_render_mesh

    etp.set_mode("mono_single")
    mesh = make_render_mesh(1, world, torch.device(device).type)
    exp = c1_experiment()
    reset_launches()
    t0 = time.perf_counter()
    etp.run(exp, spp=spp * world, seed_state=etp.SeedState(seed), mesh=mesh, device=device)
    wall = time.perf_counter() - t0
    print(f"[dryrun] c1 rank {rank} of {world}: {wall:.3f} s, {spp} spp", flush=True)
    _save(out, f"c1-r{rank}", {**_raw(exp), **_launched(), "wall_s": wall})


def _worker(rank, world, meshes, device, backend, out, cases, spp, seed):
    from . import initialize

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize(f"file://{Path(out).resolve() / 'store'}", world, rank, backend=backend,
               device=device)
    import torch.distributed as dist

    try:
        if "families" in cases:
            _families(rank, world, meshes, device, out)
        if "checkpoint" in cases:
            _checkpoint(rank, world, device, out)
        if "c1" in cases:
            _c1(rank, world, device, out, spp, seed)
    finally:
        dist.destroy_process_group()


def run_ranks(ranks, meshes, device, backend, out, cases=("families",), spp=2**21, seed=SEED,
              timeout=900):
    """Spawn ``ranks`` ranks running ``cases`` (``c1`` at ``spp`` samples a
    rank and ``seed``) and wait for them (at most ``timeout`` seconds; a
    rank that fails or a run that outlasts it ends every rank and raises)."""
    import torch.multiprocessing as mp

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "store").unlink(missing_ok=True)
    for shape in meshes:
        if shape[0] * shape[1] != ranks:
            raise ValueError(f"mesh {shape} does not cover {ranks} ranks")
    ctx = mp.start_processes(_worker, args=(ranks, list(meshes), device, backend, str(out),
                                            tuple(cases), spp, seed),
                             nprocs=ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the dry run's ranks outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join()


def compare(out, meshes, rtol=3e-5, atol=1e-7):
    """Hold each family's sharded results in ``out`` against its unsharded
    one: ``{case-mesh: max relative difference}`` of every array; raises
    ``AssertionError`` naming the first case outside ``rtol``/``atol``, whose
    ``spp`` differs or whose ranks disagree. The structured sampler's point
    sets stratify within each rank, so it is held to |z| <= 5 of the
    unsharded standard error."""
    out = Path(out)
    worst = {}
    for case in FAMILIES:
        single = np.load(out / f"{case}-single.npz")
        for shape in meshes:
            tag = "x".join(map(str, shape))
            sharded = np.load(out / f"{case}-{tag}.npz")
            if not bool(sharded["ranks_agree"]):
                raise AssertionError(f"{case}-{tag}: ranks hold different results")
            if "spp" in single.files and int(sharded["spp"]) != int(single["spp"]):
                raise AssertionError(f"{case}-{tag}: spp {sharded['spp']} != {single['spp']}")
            if case == "stratified":
                sigma = np.sqrt(single["m2"] / int(single["spp"])) + 1e-9
                z = np.abs(sharded["radiance"] - single["radiance"]) / sigma
                worst[f"{case}-{tag}"] = float(z.max())
                if z.max() > 5.0:
                    raise AssertionError(f"{case}-{tag}: |z| {z.max():.2f} > 5")
                continue
            keys = [k for k in single.files if single[k].dtype.kind == "f"]
            rel = 0.0
            for k in keys:
                a, b = sharded[k], single[k]
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{case}-{tag} {k}")
                rel = max(rel, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), atol))))
            worst[f"{case}-{tag}"] = rel
    return worst


def _mesh(text):
    a, b = text.lower().split("x")
    return int(a), int(b)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--mesh", default="2x2",
                        help="comma-separated meshes, spectral x sample (default 2x2)")
    parser.add_argument("--device", default="cpu", help="cpu, cuda or cuda:<index>")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default by device)")
    parser.add_argument("--out", required=True, help="directory of the store and the results")
    parser.add_argument("--cases", default="families",
                        help="comma-separated: families, checkpoint, c1")
    parser.add_argument("--spp", type=int, default=2**21, help="c1's samples a rank")
    parser.add_argument("--seed", type=int, default=SEED, help="c1's seed")
    parser.add_argument("--timeout", type=float, default=900.0)
    args = parser.parse_args(argv)
    meshes = [_mesh(m) for m in args.mesh.split(",")]
    cases = args.cases.split(",")
    t0 = time.perf_counter()
    run_ranks(args.ranks, meshes, args.device, args.backend, args.out, cases, args.spp,
              args.seed, args.timeout)
    result = {"ranks": args.ranks, "seconds": time.perf_counter() - t0}
    if "families" in cases:
        result["worst"] = compare(args.out, meshes)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
