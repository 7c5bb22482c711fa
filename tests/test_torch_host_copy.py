"""The port's own host code against the JAX package's.

``eradiate_tpu_torch`` keeps a mechanical copy of the host-side modules it
needs (``tools/copy_host_code.py``) and imports nothing of ``eradiate_tpu``.
Held here: the copies on disk are what the script writes today; no module of
the port imports ``jax`` or ``eradiate_tpu``; for c1 and c4 the port's
``compile_scene`` leaves equal the reference's bitwise (the c4 sun-tau table
within 2e-6, as it is built by the port's own float64 contraction) and the
port's ``postprocess_measure`` equals the reference's on the same raw arrays;
the places where the copy departs from the original (mode dtypes, the warp
namespace, the DEM surface's terrain arrays) behave as documented, and the copied mesh readers
and trunk mesh give the reference's triangles. The two packages
exchange numpy arrays and plain Python values only.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core import warp as ref_warp
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.pipelines.logic import postprocess_measure as ref_postprocess
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.core import warp
from eradiate_tpu_torch.pipelines.logic import postprocess_measure

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def case_kwargs(case):
    measures = {"type": "mdistant", "construct": "hplane", "azimuth": 0.0, "id": "m"}
    if case == "c1":
        return dict(
            illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
            measures={**measures, "zeniths": np.linspace(-75, 75, 11)},
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "molecular"},
        )
    sza = 75.0 if case == "c4" else 85.0
    return dict(
        geometry="spherical_shell",
        illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
        measures={**measures, "zeniths": np.arange(-85.0, 65.0, 10.0),
                  "target": [0.0, 0.0, 6378.1]},
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
    )


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def _leaves(obj, prefix=""):
    """Flatten a compiled scene into {path: numpy array or value}."""
    if hasattr(obj, "__dataclass_fields__"):
        out = {}
        for name in obj.__dataclass_fields__:
            out.update(_leaves(getattr(obj, name), f"{prefix}.{name}"))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_leaves(v, f"{prefix}[{k}]"))
        return out
    if isinstance(obj, tuple) and obj and not isinstance(obj[0], str):
        out = {}
        for i, v in enumerate(obj):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    if obj is None or isinstance(obj, (str, bool, int, float, tuple)):
        return {prefix: obj}
    return {prefix: np.asarray(obj)}


def test_copies_are_what_the_script_writes():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "copy_host_code.py"), "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "eradiate_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [
                f"{path.relative_to(REPO)}:{node.lineno}: {n}"
                for n in names if n.split(".")[0] in ("jax", "jaxlib", "eradiate_tpu")
            ]
    assert not bad, bad


@pytest.mark.parametrize("case", ["c1", "c4", "c4-sza85"])
def test_compile_scene_leaves_bitwise(mono_single, case):
    ref_exp, exp = RefExperiment(**case_kwargs(case)), AtmosphereExperiment(**case_kwargs(case))
    ctx = exp.spectral_context(exp.measures[0])
    ref_ctx = ref_exp.spectral_context(ref_exp.measures[0])
    np.testing.assert_array_equal(ctx["w"], ref_ctx["w"])
    ref = _leaves(ref_exp.compile_scene(ref_exp.measures[0], ref_ctx))
    out = _leaves(exp.compile_scene(exp.measures[0], ctx))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            if k == "[0].medium.sun_tau":
                np.testing.assert_allclose(out[k], v, rtol=2e-6, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k


@pytest.mark.parametrize("case", ["c1", "c4"])
def test_postprocess_measure_matches(mono_single, case):
    ref_exp, exp = RefExperiment(**case_kwargs(case)), AtmosphereExperiment(**case_kwargs(case))
    n = len(exp.measures[0].sensor_directions())
    rng = np.random.default_rng(5)
    radiance = rng.uniform(0.05, 0.3, (1, n)).astype(np.float32)
    raw = {
        "radiance": radiance,
        "m2": (radiance**2 * rng.uniform(1.5, 3.0, (1, n))).astype(np.float32),
        "spp": 64,
        "iterations": 40,
    }
    ctx = exp.spectral_context(exp.measures[0])
    ref = ref_postprocess(
        ref_exp.measures[0], ref_exp.illumination, dict(raw), {"w": np.array(ctx["w"])},
        eradiate_tpu.mode(),
    )
    out = postprocess_measure(
        exp.measures[0], exp.illumination, dict(raw), ctx, eradiate_tpu_torch.mode()
    )
    assert set(out.data_vars) == set(ref.data_vars)
    assert set(out.coords) == set(ref.coords)
    for k in list(ref.data_vars) + list(ref.coords):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)
    assert np.isfinite(np.asarray(out["brf"])).all()


def test_seed_streams_match():
    ref, out = eradiate_tpu.SeedState(7), eradiate_tpu_torch.SeedState(7)
    assert [int(ref.next()) for _ in range(5)] == [int(out.next()) for _ in range(5)]
    big_ref, big = eradiate_tpu.SeedState(2**32 - 1), eradiate_tpu_torch.SeedState(2**32 - 1)
    assert int(big_ref.next()) == int(big.next())


def test_modes_are_the_ports_own():
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono_single")
    try:
        assert eradiate_tpu.mode().id == "mono_double"
        m = eradiate_tpu_torch.mode()
        assert m.id == "mono_single" and not m.is_polarized
        assert m.device_dtype is torch.float32 and m.host_dtype is np.float32
        eradiate_tpu_torch.set_mode("ckd_double")
        m = eradiate_tpu_torch.mode()
        assert m.device_dtype is torch.float64 and m.host_dtype is np.float64
        assert eradiate_tpu.mode().id == "mono_double"
    finally:
        eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize(
    "name", ["square_to_uniform_disk_concentric", "square_to_cosine_hemisphere",
             "square_to_uniform_hemisphere", "square_to_uniform_sphere",
             "square_to_uniform_disk"]
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_serves_numpy_and_torch(name, dtype):
    u = np.random.default_rng(2).uniform(0, 1, (500, 2)).astype(dtype)
    ref = np.asarray(getattr(ref_warp, name)(u))
    out = getattr(warp, name)(u)
    assert isinstance(out, np.ndarray) and out.dtype == dtype
    np.testing.assert_array_equal(out, ref)
    via_torch = getattr(warp, name)(torch.from_numpy(u))
    assert isinstance(via_torch, torch.Tensor)
    np.testing.assert_allclose(via_torch.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cos_cutoff", [1.0, 0.99998])
def test_warp_cone_numpy(cos_cutoff):
    u = np.random.default_rng(3).uniform(0, 1, (200, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        warp.square_to_uniform_cone(u, np.float32(cos_cutoff)),
        np.asarray(ref_warp.square_to_uniform_cone(u, np.float32(cos_cutoff))),
    )


@pytest.mark.parametrize("mode_id", ["mono_single", "mono_double"])
def test_dem_arrays_patch(mode_id):
    """The copy's ``DEMSurface.dem_arrays`` (patched by the copy script)
    returns the port's ``DemArrays`` in the mode's dtype, equal to the grid
    cast as the reference casts it."""
    from eradiate_tpu.scenes.surface import DEMSurface as RefSurface
    from eradiate_tpu_torch.ops.dem import DemArrays
    from eradiate_tpu_torch.scenes.surface import DEMSurface

    eradiate_tpu_torch.set_mode(mode_id)
    try:
        dtype = eradiate_tpu_torch.mode().host_dtype
        got = DEMSurface.gaussian_hill(height_km=1.0, sigma_km=1.0, n=33).dem_arrays(dtype=dtype)
    finally:
        eradiate_tpu_torch.set_mode("mono")
    assert isinstance(got, DemArrays)
    want = RefSurface.gaussian_hill(height_km=1.0, sigma_km=1.0, n=33)
    for k, v in (("heights", want.elevation), ("x0", want.x0), ("y0", want.y0),
                 ("dx", want.dx), ("dy", want.dy)):
        t = getattr(got, k)
        assert t.dtype == (torch.float64 if mode_id == "mono_double" else torch.float32)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(v, dtype=dtype))


def test_unported_host_features_raise(tmp_path):
    """DEM surfaces, tree trunks, mesh-tree elements and NetCDF absorption
    databases are ported: a DEM surface gives the port's terrain arrays,
    trunks and mesh trees the reference's triangles, and ``open_database``
    reads the committed golden NetCDF database as the reference does."""
    from eradiate_tpu.scenes.biosphere import AbstractTree as RefTree
    from eradiate_tpu.scenes.biosphere import MeshTreeElement as RefElement
    from eradiate_tpu_torch.scenes.biosphere import AbstractTree, MeshTreeElement
    from eradiate_tpu_torch.ops.dem import DemArrays
    from eradiate_tpu_torch.scenes.surface import DEMSurface
    from eradiate_tpu_torch.test_tools.meshes import wood_skeleton, write_obj

    assert isinstance(DEMSurface.gaussian_hill(n=5).dem_arrays(), DemArrays)
    for got, want in zip(AbstractTree().mesh_part(), RefTree().mesh_part()):
        np.testing.assert_array_equal(got, want)
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=3)
    path = tmp_path / "wood.obj"
    write_obj(path, v, f)
    got = MeshTreeElement(mesh_filename=str(path), mesh_units="m").triangles()
    want = RefElement(mesh_filename=str(path), mesh_units="m").triangles()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], v * 1e-3)  # the file keeps every digit
    np.testing.assert_array_equal(got[1], f)
    with pytest.raises(OSError):
        MeshTreeElement(mesh_filename=str(tmp_path / "missing.ply")).triangles()
    from eradiate_tpu.physics.absorption import open_database as ref_open_database
    from eradiate_tpu_torch.physics.absorption import CKDAbsorptionDatabase, open_database

    golden = str(REPO / "tests" / "regression_references" / "absorption_golden")
    db = open_database(golden)
    assert isinstance(db, CKDAbsorptionDatabase)
    np.testing.assert_array_equal(db._d["sigma_a"], ref_open_database(golden)._d["sigma_a"])
