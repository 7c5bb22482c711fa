"""Tree and mesh canopies of the port against the JAX package, on the CPU.

Canopies with ``abstract_tree`` elements (a leaf-cloud crown on a trunk of
36 triangles) and ``mesh_tree`` elements (triangle meshes read from a file)
run through ``eradiate_tpu_torch.run(..., device="cpu")`` and
``eradiate_tpu.run`` at the same seed:

- the 3 x 3 tree forest of ``tests/system/test_trees.py`` (trunks alone and
  with 300-leaf crowns, point target on the central tree, 64 spp), instanced
  leaves and instanced trunk triangles;
- a small ``c5_trees``: one tree (a 200-leaf crown on a 6 m trunk) instanced
  at three positions under the Rayleigh atmosphere, footprint target;
- a small ``c5_wood``: the 200-leaf cloud and a mesh tree (a wood skeleton of
  324 triangles written as an OBJ file) at the same three positions, two
  elements, which the experiments flatten (600 disks, 972 triangles).

``compile_canopy_scene``: leaves, triangles, offsets and both optics rows
bitwise the reference's. ``run``: the canopy gate, every pixel within
|z| <= 5 and 2e-3 relative, the median pixel within 1e-4 (the port follows
the reference's sample stream; an ulp of libm or of a fused multiply-add can
move a hit point across a trunk's wall and flip a rare path). A nadir view
onto a trunk's cap is not black (the shadow ray's origin is lifted off the
triangle it starts on). A canopy of meshes without a single leaf raises as
in the reference. A tree canopy runs with ``jax`` blocked.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu_torch import CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.ops.tracer_canopy import render_canopy
from eradiate_tpu_torch.test_tools.meshes import wood_skeleton, write_obj

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SPP = 64
N_VZA = 5
POSITIONS = np.array([[-8.0, -5.0, 0.0], [6.0, -7.0, 0.0], [1.0, 8.0, 0.0]]) * 1e-3  # km
CLOUD = {"construct": "sphere", "n_leaves": 200, "leaf_radius": 0.4, "radius": 5.0,
         "leaf_reflectance": 0.4957, "leaf_transmittance": 0.4409}


def forest(n_leaves):
    """``tests/system/test_trees.py`` ``_tree_canopy``: 3 x 3 trees, 10 m
    apart, trunks of 0.5 m radius and 2 m height."""
    tree = {
        "type": "abstract_tree",
        "leaf_cloud": {"construct": "sphere", "n_leaves": n_leaves, "leaf_radius": 0.1,
                       "radius": 1.0, "center": (0, 0, 1.0), "leaf_reflectance": 0.45,
                       "leaf_transmittance": 0.02},
        "trunk_height": 2.0, "trunk_radius": 0.5, "trunk_reflectance": 0.1,
    }
    positions = [[i * 0.01, j * 0.01, 0.0] for i in (-1, 0, 1) for j in (-1, 0, 1)]
    return {"type": "discrete_canopy", "size": (30.0, 30.0, 4.0),
            "instanced_canopy_elements": [
                {"type": "instanced", "canopy_element": tree, "instance_positions": positions}]}


def small_c5(form, mesh_file=None):
    """The small ``c5_trees`` (one instanced tree) or ``c5_wood`` (leaf cloud
    and mesh tree, flattened) canopy."""
    if form == "trees":
        tree = {"type": "abstract_tree", "leaf_cloud": {**CLOUD, "center": (0.0, 0.0, 4.0)},
                "trunk_height": 6.0, "trunk_radius": 0.25, "trunk_reflectance": 0.125}
        elements = [tree]
    else:
        wood = {"type": "mesh_tree", "mesh_tree_elements": [
            {"mesh_filename": str(mesh_file), "mesh_units": "m", "reflectance": 0.125,
             "transmittance": 0.0}]}
        elements = [{"type": "leaf_cloud", **CLOUD, "center": (0.0, 0.0, 10.0)}, wood]
    return {"type": "discrete_canopy", "size": (30.0, 30.0, 15.0),
            "instanced_canopy_elements": [
                {"type": "instanced", "canopy_element": e, "instance_positions": POSITIONS}
                for e in elements]}


def kwargs(case, mesh_file=None):
    """Experiment arguments of a case: ``forest-1``, ``forest-300`` (no
    atmosphere, point target), ``trees``, ``wood`` (Rayleigh atmosphere,
    footprint target)."""
    measure = {"type": "mdistant", "construct": "hplane", "azimuth": 0.0, "id": "m"}
    if case.startswith("forest"):
        return dict(
            illumination={"type": "directional", "zenith": 30.0, "irradiance": 1.0},
            measures={**measure, "zeniths": np.linspace(-60, 60, N_VZA),
                      "target": {"type": "point", "xyz": [0.0, 0.0, 0.0]}},
            surface={"type": "lambertian", "reflectance": 0.8},
            canopy=forest(int(case.split("-")[1])),
        )
    return dict(
        canopy=small_c5(case, mesh_file),
        atmosphere={"type": "molecular", "has_absorption": False},
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={**measure, "zeniths": np.linspace(-75, 75, N_VZA)},
        surface={"type": "lambertian", "reflectance": 0.159},
        integrator={"type": "volpath"},
    )


def experiments(case, mesh_file=None):
    """``(port experiment, reference experiment)`` of a case."""
    if case.startswith("forest"):
        return CanopyExperiment(**kwargs(case)), RefCanopy(**kwargs(case))
    kw = kwargs(case, mesh_file)
    return CanopyAtmosphereExperiment(**kw), RefCanopyAtmosphere(**kw)


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    """A 12-branch wood skeleton (324 triangles, metres) as an OBJ file."""
    path = tmp_path_factory.mktemp("meshes") / "wood.obj"
    write_obj(path, *wood_skeleton(np.random.default_rng(7), n_branches=12))
    return path


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def compiled(exp):
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


CASES = ["forest-1", "forest-300", "trees", "wood"]


@pytest.mark.parametrize("case", CASES)
def test_canopy_arrays_bitwise(mono_single, mesh_file, case):
    """Leaves, triangles, offsets and the optics rows of the port's host
    compile equal the reference's bit for bit, instanced where the reference
    keeps instances and flattened where it flattens."""
    out, ref = (compiled(e) for e in experiments(case, mesh_file))
    for i in (3, 6):
        for k in ("reflectance", "transmittance"):
            assert out[i][k].dtype == np.float32
            np.testing.assert_array_equal(out[i][k], np.asarray(ref[i][k]))
    leaves, ref_leaves, tris, ref_tris = out[4], ref[4], out[5], ref[5]
    instanced = case != "wood"
    for x in (leaves, ref_leaves, tris, ref_tris):
        assert hasattr(x, "canonical") == instanced
    if instanced:
        np.testing.assert_array_equal(leaves.offsets, np.asarray(ref_leaves.offsets))
        np.testing.assert_array_equal(tris.offsets, np.asarray(ref_tris.offsets))
        leaves, ref_leaves = leaves.canonical, ref_leaves.canonical
        tris, ref_tris = tris.canonical, ref_tris.canonical
    n_leaves = {"forest-1": 1, "forest-300": 300, "trees": 200, "wood": 600}[case]
    assert leaves.centers.shape == (n_leaves, 3)
    assert tris.v0.shape == ((972 if case == "wood" else 36), 3)
    for k in ("centers", "normals", "radii"):
        assert getattr(leaves, k).dtype == np.float32
        np.testing.assert_array_equal(getattr(leaves, k), np.asarray(getattr(ref_leaves, k)))
    for k in ("v0", "e1", "e2"):
        assert getattr(tris, k).dtype == np.float32
        np.testing.assert_array_equal(getattr(tris, k), np.asarray(getattr(ref_tris, k)))


def gate(out, ref):
    """The canopy gate: |z| <= 5, 2e-3 relative, median within 1e-4."""
    brf, brf_ref = np.asarray(out["brf"]), np.asarray(ref["brf"])
    assert brf.shape == brf_ref.shape == (1, N_VZA)
    assert np.isfinite(brf).all() and (brf > 0).all()
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    diff = np.abs(rad - rad_ref)
    var = np.asarray(out["var"]) + np.asarray(ref["var"])
    z = np.where(diff > 0, diff, 0.0) / np.sqrt(np.where(diff > 0, var, 1.0))
    rel = np.abs(brf - brf_ref) / np.abs(brf_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= 1e-4


@pytest.mark.parametrize("case", CASES)
def test_run_matches_reference(mono_single, mesh_file, case):
    exp, ref_exp = experiments(case, mesh_file)
    ref = eradiate_tpu.run(ref_exp, spp=SPP, seed_state=eradiate_tpu.SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(
        exp, spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7), device="cpu"
    )
    assert set(out.data_vars) == set(ref.data_vars)
    gate(out, ref)
    # the wood is seen: the same canopy without it gives another BRF
    if case in ("trees", "wood"):
        bare = {**kwargs(case, mesh_file),
                "canopy": {"type": "discrete_canopy", "size": (30.0, 30.0, 15.0),
                           "instanced_canopy_elements": [
                               {"type": "instanced", "instance_positions": POSITIONS,
                                "canopy_element": {"type": "leaf_cloud", **CLOUD,
                                                   "center": (0.0, 0.0, 10.0)}}]}}
        leaves_only = eradiate_tpu_torch.run(
            CanopyAtmosphereExperiment(**bare), spp=SPP,
            seed_state=eradiate_tpu_torch.SeedState(7), device="cpu",
        )
        assert np.abs(np.asarray(out["brf"]) - np.asarray(leaves_only["brf"])).max() > 1e-4


def test_trunk_cap_seen_from_above_is_not_black(mono_single):
    """A nadir view onto the cap of the central trunk (radius 0.5 m,
    reflectance 0.1) under a sun at 30 degrees: the hit point's shadow ray
    starts on the cap's own triangles and must not be occluded by them, so
    the cap shows its Lambertian BRF, far below the bright floor's 0.8."""
    kw = kwargs("forest-1")
    kw["measures"] = {"type": "mdistant", "construct": "from_angles", "angles": [[0.0, 0.0]],
                      "target": {"type": "point", "xyz": [0.0, 0.0, 0.0]}, "id": "m"}
    out = eradiate_tpu_torch.run(
        CanopyExperiment(**kw), spp=256, seed_state=eradiate_tpu_torch.SeedState(3),
        device="cpu",
    )
    brf = float(np.asarray(out["brf"]).ravel()[0])
    assert 0.08 < brf < 0.2


@pytest.mark.parametrize("case", ["trees", "wood"])
def test_estimate_independent_of_lane_count(mono_single, mesh_file, case):
    scene, sensor, config, leaf_params, leaves, tris, tri_params = compiled(
        experiments(case, mesh_file)[0]
    )
    out = [
        render_canopy(scene, leaf_params, leaves, sensor, config, spp=32, seed=3,
                      tris=tris, tri_params=tri_params, device="cpu",
                      lanes_target=lt)["radiance"].numpy()
        for lt in (N_VZA * 8, N_VZA * 3)
    ]
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=0)


def test_mesh_only_canopy_raises_as_the_reference(mono_single, mesh_file):
    """Neither package renders a canopy without a single leaf."""
    kw = kwargs("wood", mesh_file)
    kw["canopy"]["instanced_canopy_elements"] = kw["canopy"]["instanced_canopy_elements"][1:]
    with pytest.raises(ValueError) as ref_err:
        compiled(RefCanopyAtmosphere(**kw))
    with pytest.raises(ValueError) as err:
        compiled(CanopyAtmosphereExperiment(**kw))
    assert str(err.value) == str(ref_err.value)


def test_tree_canopies_run_with_jax_blocked(mesh_file):
    cases = json.dumps(
        {case: kwargs(case, mesh_file) for case in ("forest-300", "wood")},
        default=lambda a: np.asarray(a).tolist(),
    )
    code = textwrap.dedent(
        f"""
        import json
        import sys
        sys.modules["jax"] = None
        sys.modules["eradiate_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import eradiate_tpu_torch as etp
        etp.set_mode("mono_single")
        for case, kw in json.loads({cases!r}).items():
            cls = etp.CanopyAtmosphereExperiment if "atmosphere" in kw else etp.CanopyExperiment
            ds = etp.run(cls(**kw), spp=16, seed_state=etp.SeedState(7), device="cpu")
            brf = np.asarray(ds["brf"])
            assert brf.shape == (1, 5) and np.isfinite(brf).all() and (brf > 0).all(), brf
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "eradiate_tpu")]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("OK", float(brf.mean()))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
