"""The port's polarized canopy tracer against the JAX package, on the CPU.

A small HET01 (one 200-leaf sphere cloud at three positions in a 30 m x 30
m x 15 m canopy over a Lambertian floor, 5 view zeniths, 128 spp) in
``mono_polarized_single``, in three forms: instanced, as two elements
(flattened: the flat leaf sweeps) and as an abstract tree (the crown on a 6
m trunk: instanced leaves and instanced trunk triangles); each with and
without the Rayleigh atmosphere. ``eradiate_tpu_torch.run(...,
device="cpu")`` and ``eradiate_tpu.run`` at the same seed meet the canopy
gate on I (every pixel within |z| <= 5 and 2e-3 relative, the median pixel
within 1e-4) and on Q and U measured against I. Without an atmosphere
every interaction depolarizes, so the port's polarized I equals its scalar
radiance (the same uniform slots, the same paths) within the reference's
tolerances (``tests/system/test_polarized_canopy.py``: 5e-3 relative, the
median within 1e-6) and Q, U and V vanish; with it the sky polarizes the
views. The Morton lane sort, which permutes P and the basis with their
lanes, changes the estimate only by float32 summation order (2e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu_torch import CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.ops.tracer_canopy import render_canopy
from eradiate_tpu_torch.ops.tracer_canopy_polarized import render_canopy_polarized

torch.set_num_threads(1)

SPP = 128
N_VZA = 5
POSITIONS = [[-8e-3, -5e-3, 0.0], [6e-3, -7e-3, 0.0], [1e-3, 8e-3, 0.0]]  # km
CLOUD = {"type": "leaf_cloud", "construct": "sphere", "n_leaves": 200, "leaf_radius": 0.4,
         "radius": 5.0, "leaf_reflectance": 0.4957, "leaf_transmittance": 0.4409}


def canopy(form):
    """The small HET01 as one instanced cloud, as two elements (2 + 1
    positions), or as one abstract tree with that crown on a 6 m trunk."""
    if form == "tree":
        tree = {"type": "abstract_tree", "leaf_cloud": {**CLOUD, "center": (0.0, 0.0, 4.0)},
                "trunk_height": 6.0, "trunk_radius": 0.25, "trunk_reflectance": 0.125}
        parts = [(tree, POSITIONS)]
    else:
        cloud = {**CLOUD, "center": (0.0, 0.0, 10.0)}
        parts = ([(cloud, POSITIONS)] if form == "instanced"
                 else [(cloud, POSITIONS[:2]), (cloud, POSITIONS[2:])])
    return {"type": "discrete_canopy", "size": (30.0, 30.0, 15.0),
            "instanced_canopy_elements": [
                {"type": "instanced", "canopy_element": e, "instance_positions": p}
                for e, p in parts]}


def experiments(form, atmosphere):
    """``(port experiment, reference experiment)``."""
    kw = dict(
        canopy=canopy(form),
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, N_VZA), "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.159},
        integrator={"type": "volpath", "stokes": True},
    )
    if atmosphere:
        kw["atmosphere"] = {"type": "molecular", "has_absorption": False}
        return CanopyAtmosphereExperiment(**kw), RefCanopyAtmosphere(**kw)
    return CanopyExperiment(**kw), RefCanopy(**kw)


@pytest.fixture
def mono_polarized_single():
    eradiate_tpu.set_mode("mono_polarized_single")
    eradiate_tpu_torch.set_mode("mono_polarized_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def compiled(exp):
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


def gate(value, ref_value, I_ref, var):
    """|z| <= 5 (the I variances), 2e-3 of I, the median within 1e-4 of I."""
    diff = np.abs(value - ref_value)
    rel = diff / I_ref
    z = np.where(diff > 0, diff, 0.0) / np.sqrt(np.where(diff > 0, var, 1.0))
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= 1e-4


@pytest.mark.parametrize("atmosphere", [True, False])
@pytest.mark.parametrize("form", ["instanced", "flat", "tree"])
def test_run_matches_reference(mono_polarized_single, form, atmosphere):
    exp, ref_exp = experiments(form, atmosphere)
    ref = eradiate_tpu.run(ref_exp, spp=SPP, seed_state=eradiate_tpu.SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(exp, spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7),
                                 device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    assert {"I", "Q", "U", "V", "dolp"} <= set(out.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    I_ref = np.asarray(ref["I"])
    assert I_ref.shape == (1, N_VZA) and (I_ref > 0).all()
    assert np.isfinite(np.asarray(out["I"])).all()
    var = np.asarray(out["var"]) + np.asarray(ref["var"])
    for c in "IQU":
        gate(np.asarray(out[c]), np.asarray(ref[c]), I_ref, var)
    dolp = np.asarray(out["dolp"])
    assert ((dolp >= 0.0) & (dolp <= 1.0)).all()
    if atmosphere:
        assert dolp.max() > 0.02  # the sky polarizes the views
    else:
        assert dolp.max() == 0.0


@pytest.mark.parametrize("form", ["instanced", "tree"])
def test_depolarizing_scene_traces_the_scalar_paths(mono_polarized_single, form):
    """No atmosphere: bilambertian leaves and trunks and a Lambertian floor
    depolarize, so the polarized I is the scalar radiance of the same paths
    and the scene leaves Q, U and V at 0."""
    scene, sensor, config, leaf_params, leaves, tris, tri_params = compiled(
        experiments(form, atmosphere=False)[0])
    assert config.polarized
    pol = render_canopy_polarized(scene, leaf_params, leaves, sensor, config, spp=SPP, seed=3,
                                  tris=tris, tri_params=tri_params, device="cpu")
    scalar = render_canopy(scene, leaf_params, leaves, sensor,
                           dataclasses.replace(config, polarized=False), spp=SPP, seed=3,
                           tris=tris, tri_params=tri_params, device="cpu")
    I, L = pol["radiance"].numpy(), scalar["radiance"].numpy()
    assert pol["iterations"] == scalar["iterations"]
    np.testing.assert_allclose(I, L, rtol=5e-3)
    assert np.median(np.abs(I - L) / L) < 1e-6
    np.testing.assert_allclose(pol["stokes"][..., 1:].numpy(), 0.0, atol=1e-7)


@pytest.mark.parametrize("sort_every", [0, 3])
def test_lane_sort_changes_only_summation_order(mono_polarized_single, sort_every):
    scene, sensor, config, leaf_params, leaves, _, _ = compiled(
        experiments("instanced", atmosphere=True)[0])
    base = render_canopy_polarized(scene, leaf_params, leaves, sensor, config, spp=64, seed=4,
                                   device="cpu")
    other = render_canopy_polarized(scene, leaf_params, leaves, sensor, config, spp=64, seed=4,
                                    device="cpu", sort_every=sort_every)
    np.testing.assert_allclose(other["stokes"].numpy(), base["stokes"].numpy(), rtol=2e-5,
                               atol=1e-8)
    np.testing.assert_allclose(other["m2"].numpy(), base["m2"].numpy(), rtol=2e-5, atol=0)


def test_unpolarized_config_and_unported_features_raise(mono_polarized_single):
    scene, sensor, config, leaf_params, leaves, _, _ = compiled(
        experiments("instanced", atmosphere=False)[0])
    with pytest.raises(ValueError, match="polarized is False"):
        render_canopy_polarized(scene, leaf_params, leaves, sensor,
                                dataclasses.replace(config, polarized=False), spp=8,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="render_canopy_polarized"):
        render_canopy(scene, leaf_params, leaves, sensor, config, spp=8, device="cpu")
