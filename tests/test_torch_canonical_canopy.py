"""The reference's canonical canopy scenes in the port, against the JAX
package, on the CPU; polarized ``mesh_tree`` canopies at the same seed.

``het04a1`` (a sphere cloud at 8 positions and a cylinder cloud at 7, with
different optics: two instanced elements, which the experiments flatten to
22,500 leaf disks) and ``het06`` (cone crowns on trunks: instanced leaves
and instanced trunk triangles), from the port's copies of the reference's
factories, run in ``mono_single`` through ``eradiate_tpu_torch.run(...,
device="cpu")`` and ``eradiate_tpu.run`` at the same seed, at 32 spp and 5
views, under the canopy gate: every pixel within |z| <= 5 of the two runs'
variances and 2e-3 relative, the median pixel within 1e-4.

A small ``c5_wood`` canopy (a 200-leaf sphere cloud beside a 12-branch wood
skeleton read from an OBJ file, at three positions: flattened, the flat
triangle sweeps) in ``mono_polarized_single``, with and without the Rayleigh
atmosphere, meets the same gate on I, and on Q and U measured against I.
"""

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu.test_tools import test_cases as ref_cases
from eradiate_tpu_torch import CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.test_tools import test_cases as cases
from eradiate_tpu_torch.test_tools.meshes import wood_skeleton, write_obj

torch.set_num_threads(1)

SEED = 7
N_VZA = 5


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


@pytest.fixture
def mono_polarized_single():
    eradiate_tpu.set_mode("mono_polarized_single")
    eradiate_tpu_torch.set_mode("mono_polarized_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def gate(value, ref_value, I_ref, var):
    """|z| <= 5 (the I variances), 2e-3 of I, the median within 1e-4 of I."""
    diff = np.abs(value - ref_value)
    rel = diff / I_ref
    z = np.where(diff > 0, diff, 0.0) / np.sqrt(np.where(diff > 0, var, 1.0))
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= 1e-4


def run_both(exp, ref_exp, spp=None):
    ref = eradiate_tpu.run(ref_exp, spp=spp, seed_state=eradiate_tpu.SeedState(SEED), mesh=None)
    out = eradiate_tpu_torch.run(exp, spp=spp, seed_state=eradiate_tpu_torch.SeedState(SEED),
                                 device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)
    return out, ref


@pytest.mark.parametrize("factory, disks", [("create_het04a1_brfpp", 22_500),
                                            ("create_het06_brfpp", 648)])
def test_canopy_scene_matches_reference(mono_single, factory, disks):
    exp = getattr(cases, factory)(spp=32, n_vza=N_VZA)
    m = exp.measures[0]
    leaves = exp.compile_canopy_scene(m, exp.spectral_context(m))[4]
    # het04a1's two elements are flattened; het06's tree stays instanced
    assert (leaves.centers.shape[0] if disks > 1000 else leaves.canonical.centers.shape[0]) == disks
    out, ref = run_both(exp, getattr(ref_cases, factory)(spp=32, n_vza=N_VZA))
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    assert rad.shape == (1, N_VZA) and np.isfinite(rad).all()
    gate(rad, rad_ref, rad_ref, np.asarray(out["var"]) + np.asarray(ref["var"]))


POSITIONS = [[-8e-3, -5e-3, 0.0], [6e-3, -7e-3, 0.0], [1e-3, 8e-3, 0.0]]  # km
CLOUD = {"type": "leaf_cloud", "construct": "sphere", "n_leaves": 200, "leaf_radius": 0.4,
         "radius": 5.0, "center": (0.0, 0.0, 10.0), "leaf_reflectance": 0.4957,
         "leaf_transmittance": 0.4409}


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    """A 12-branch wood skeleton (324 triangles, metres) as an OBJ file."""
    path = tmp_path_factory.mktemp("meshes") / "wood.obj"
    write_obj(path, *wood_skeleton(np.random.default_rng(7), n_branches=12))
    return path


@pytest.mark.parametrize("atmosphere", [True, False])
def test_polarized_mesh_tree_matches_reference(mono_polarized_single, mesh_file, atmosphere):
    wood = {"type": "mesh_tree", "mesh_tree_elements": [
        {"mesh_filename": str(mesh_file), "mesh_units": "m", "reflectance": 0.125,
         "transmittance": 0.0}]}
    kw = dict(
        canopy={"type": "discrete_canopy", "size": (30.0, 30.0, 15.0),
                "instanced_canopy_elements": [
                    {"type": "instanced", "canopy_element": e, "instance_positions": POSITIONS}
                    for e in (CLOUD, wood)]},
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, N_VZA), "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.159},
        integrator={"type": "volpath", "stokes": True},
    )
    if atmosphere:
        kw["atmosphere"] = {"type": "molecular", "has_absorption": False}
        exp, ref_exp = CanopyAtmosphereExperiment(**kw), RefCanopyAtmosphere(**kw)
    else:
        exp, ref_exp = CanopyExperiment(**kw), RefCanopy(**kw)
    m = exp.measures[0]
    tris = exp.compile_canopy_scene(m, exp.spectral_context(m))[5]
    assert tris is not None and tris.v0.shape[0] == 3 * 324  # flattened: 3 skeletons
    out, ref = run_both(exp, ref_exp, spp=128)
    I_ref = np.asarray(ref["I"])
    assert I_ref.shape == (1, N_VZA) and (I_ref > 0).all()
    var = np.asarray(out["var"]) + np.asarray(ref["var"])
    for c in "IQU":
        gate(np.asarray(out[c]), np.asarray(ref[c]), I_ref, var)
    dolp = np.asarray(out["dolp"])
    assert dolp.max() > 0.02 if atmosphere else dolp.max() == 0.0
