"""Surface kinds in the double and polarized modes and in every tracer.

- ``mono_double``: c1's column over ``rtls``, ``ocean_legacy``, a 3 km
  ``bitmap`` (375 m cells) and ``central_patch``, against the reference
  under x64 at one seed: every pixel's radiance and second moment within
  1e-10 relative. A float32 sampled direction meets float64 path state
  there, and each kind promotes as the reference does (its float32 pieces
  rounded as XLA:CPU fuses them); the surface points follow the
  reference's fused multiply-adds in float64.
- ``mono_polarized_single``: the same kinds (the 20 km map), I within 1e-5
  relative a pixel, Q, U and V within 1e-5 of I.
- Every kind and composite renders through ``eradiate_tpu_torch.run`` in
  the spherical tracers (no position: the composites take their
  background, their nested BSDF or child 0, a bitmap its mean) and in the
  canopy tracers, scalar and polarized, with finite results (positive, but
  for a canopy's black ground, which only the leaves reflect over); the
  spherical render of a composite equals that of the kind it reduces to.
"""

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu_torch import AtmosphereExperiment, CanopyExperiment
from test_torch_surfaces_render import MAP, SURFACES, c1_kwargs

torch.set_num_threads(1)

SPP = 64
MODE_CASES = {
    "rtls": SURFACES["rtls"],
    "ocean_legacy": SURFACES["ocean_legacy"],
    "bitmap": {"type": "bitmap", "data": MAP, "extent": 3.0},
    "central_patch": SURFACES["central_patch"],
}


def render_pair(surface, mode, x64):
    """The reference's raw result (x64 on around it when ``x64``) and the
    port's on the CPU, in ``mode`` at one seed."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    eradiate_tpu.set_mode(mode)
    try:
        ref = RefExperiment(**c1_kwargs(surface))
        eradiate_tpu.run(ref, spp=SPP, seed_state=SeedState(7), mesh=None)
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode(mode)
    try:
        out = AtmosphereExperiment(**c1_kwargs(surface))
        eradiate_tpu_torch.run(out, spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7),
                               device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono")
    return ({k: np.asarray(v) for k, v in ref.measures[0].results["raw"].items()},
            out.measures[0].results["raw"])


@pytest.mark.parametrize("name", MODE_CASES)
def test_double_mode_matches_reference_under_x64(name):
    ref, raw = render_pair(MODE_CASES[name], "mono_double", x64=True)
    for k in ("radiance", "m2"):
        assert raw[k].dtype == ref[k].dtype == np.float64 and raw[k].shape == ref[k].shape
        np.testing.assert_allclose(raw[k], ref[k], rtol=1e-10, atol=0, err_msg=k)
    assert (raw["radiance"] > 0).all()


@pytest.mark.parametrize("name", MODE_CASES)
def test_polarized_mode_matches_reference(name):
    surface = SURFACES["bitmap"] if name == "bitmap" else MODE_CASES[name]
    ref, raw = render_pair(surface, "mono_polarized_single", x64=False)
    st, ref_st = np.asarray(raw["stokes"]), ref["stokes"]
    assert st.dtype == ref_st.dtype == np.float32 and st.shape == ref_st.shape
    I = ref_st[..., 0]
    assert (I > 0).all()
    np.testing.assert_allclose(st[..., 0], I, rtol=1e-5, atol=0)
    assert (np.abs(st[..., 1:] - ref_st[..., 1:]) <= 1e-5 * I[..., None]).all()


def _spherical(surface, polarized):
    return AtmosphereExperiment(
        geometry="spherical_shell",
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 20.0],
                  "azimuth": 0.0, "target": [0.0, 0.0, 6378.1]},
        surface=surface,
        atmosphere={"type": "homogeneous", "sigma_s": 0.02, "top": 20.0},
        integrator={"type": "volpath", "stokes": True} if polarized else None,
    )


def _canopy(surface, polarized):
    cloud = {"type": "leaf_cloud", "construct": "sphere", "n_leaves": 30, "leaf_radius": 0.4,
             "radius": 3.0, "center": (0.0, 0.0, 5.0), "leaf_reflectance": 0.45,
             "leaf_transmittance": 0.4}
    return CanopyExperiment(
        canopy={"type": "discrete_canopy", "size": (20.0, 20.0, 10.0),
                "instanced_canopy_elements": [
                    {"type": "instanced", "canopy_element": cloud,
                     "instance_positions": [[0.0, 0.0, 0.0], [4e-3, 3e-3, 0.0]]}]},
        illumination={"type": "directional", "zenith": 20.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 20.0],
                  "azimuth": 0.0},
        surface=surface,
        integrator={"type": "volpath", "stokes": polarized},
    )


@pytest.mark.parametrize("tracer", ["spherical", "canopy"])
@pytest.mark.parametrize("mode", ["mono_single", "mono_polarized_single"])
def test_every_kind_renders_in_every_tracer(tracer, mode):
    polarized = mode == "mono_polarized_single"
    make = _spherical if tracer == "spherical" else _canopy
    eradiate_tpu_torch.set_mode(mode)
    try:
        out = {}
        cases = dict(SURFACES, lambertian_01={"type": "lambertian", "reflectance": 0.1})
        for name, surface in cases.items():
            exp = make(surface, polarized)
            ds = eradiate_tpu_torch.run(exp, spp=16, seed_state=eradiate_tpu_torch.SeedState(5),
                                        device="cpu")
            raw = exp.measures[0].results["raw"]
            assert ("stokes" in raw) == polarized, name
            brf = np.asarray(ds["brf"])
            assert brf.shape == (1, 2) and np.isfinite(brf).all() and (brf >= 0).all(), name
            assert brf.max() > 0 or (tracer == "canopy" and name == "black"), name
            out[name] = np.asarray(raw["radiance"])
        if tracer == "spherical":  # no position: each composite reduces to one kind
            np.testing.assert_array_equal(out["central_patch"], out["rtls"])
            np.testing.assert_array_equal(out["opacity_mask"], out["rpv"])
            np.testing.assert_array_equal(out["selectbsdf"], out["lambertian_01"])
    finally:
        eradiate_tpu_torch.set_mode("mono")
