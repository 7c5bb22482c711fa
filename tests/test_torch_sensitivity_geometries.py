"""``eradiate_tpu_torch.sensitivity.sensitivities`` on spherical shells
(scalar and polarized), a leaf canopy and DEM terrain, on the CPU.

- Closed forms, as the JAX package's own tests state them: over a pure
  absorber (a 10 km homogeneous layer of optical depth 0.4, no scattering)
  the relative derivative of the radiance with respect to the optical-depth
  scale is -tau (1/mu0 + 1/mu), a zero-variance estimate: within 3e-3 in
  spherical shells (scalar and polarized), within 1e-4 over a flat DEM
  (marched and triangulated).
- The leaf channel against common-random-number finite differences of the
  port's own renders (RR off, eps 0.02), at the reference test's gate.
- Same seed as ``eradiate_tpu.sensitivity.sensitivities``: each pixel's
  tangent within 1e-2 of its channel's largest |tangent|, their median
  within 1e-3 (the primal is not bitwise with the reference there: the
  canopy and DEM gates are statistical, and a few spherical lanes flip).
- The primal equals the production render (RR off, no ``lr_flight``; in
  spherical shells the exact slant depth, not the sun-tau table) bit for
  bit in every family.
"""

import dataclasses

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu import experiments as ref_experiments
from eradiate_tpu.scenes.surface import DEMSurface as RefDEMSurface
from eradiate_tpu.sensitivity import sensitivities as ref_sensitivities
from eradiate_tpu_torch import experiments
from eradiate_tpu_torch.scenes.surface import DEMSurface
from eradiate_tpu_torch.sensitivity import sensitivities

torch.set_num_threads(1)

SEED = 7
SUN = {"type": "directional", "zenith": 30.0, "azimuth": 0.0}
VIEWS = {"type": "mdistant", "construct": "hplane", "zeniths": [-45.0, 0.0, 45.0],
         "azimuth": 0.0, "id": "m"}
TAU = 0.4
ABSORBER = {"type": "homogeneous", "top": 10.0, "sigma_s": 0.0, "sigma_a": TAU / 10.0}


def _spherical(pkg, spp, atmosphere=None):
    return pkg.AtmosphereExperiment(
        geometry={"type": "spherical_shell"}, illumination=SUN, measures={**VIEWS, "spp": spp},
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere=atmosphere or {"type": "molecular"})


def _canopy(pkg, spp):
    return pkg.CanopyExperiment(
        canopy={"type": "leaf_cloud", "construct": "cuboid", "n_leaves": 200,
                "leaf_radius": 0.12, "l_horizontal": 10.0, "l_vertical": 2.0,
                "leaf_reflectance": 0.45, "leaf_transmittance": 0.25, "seed": 5},
        illumination=SUN, measures={**VIEWS, "zeniths": [-30.0, 0.0, 30.0], "spp": spp},
        surface={"type": "lambertian", "reflectance": 0.3})


def _dem(pkg, surface_cls, spp, flat=False, triangulate=False, atmosphere=None):
    bsdf = {"type": "lambertian", "reflectance": 0.5}
    if flat:
        surface = surface_cls(elevation=np.zeros((8, 8)), x0=-50.0, y0=-50.0, bsdf=bsdf,
                              triangulate=triangulate)
    else:
        surface = surface_cls.gaussian_hill(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=8,
                                            bsdf=bsdf, triangulate=triangulate)
    return pkg.DEMExperiment(illumination=SUN, measures={**VIEWS, "spp": spp}, surface=surface,
                             atmosphere=atmosphere or {"type": "molecular"})


#: family -> (mode, port experiment, reference experiment, channels)
FAMILIES = {
    "spherical": ("mono_single", lambda: _spherical(eradiate_tpu_torch, 256),
                  lambda: _spherical(ref_experiments, 256),
                  ("medium.tau_scale", "medium.albedo")),
    "spherical polarized": ("mono_polarized_single",
                            lambda: _spherical(eradiate_tpu_torch, 256),
                            lambda: _spherical(ref_experiments, 256), ("medium.tau_scale",)),
    "canopy": ("mono_single", lambda: _canopy(eradiate_tpu_torch, 256),
               lambda: _canopy(ref_experiments, 256),
               ("canopy.reflectance", "canopy.transmittance")),
    "dem": ("mono_single", lambda: _dem(experiments, DEMSurface, 256),
            lambda: _dem(ref_experiments, RefDEMSurface, 256),
            ("medium.tau_scale", "surface.reflectance")),
}


def _in_mode(mode, fn):
    eradiate_tpu.set_mode(mode)
    eradiate_tpu_torch.set_mode(mode)
    try:
        return fn()
    finally:
        eradiate_tpu.set_mode("mono_single")
        eradiate_tpu_torch.set_mode("mono_single")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tangents_match_the_reference_and_the_primal_is_production(family):
    mode, make, make_ref, wrt = FAMILIES[family]

    def run():
        exp = make()
        out = sensitivities(exp, wrt, seed=SEED, device="cpu")["m"]
        (ref,) = ref_sensitivities(make_ref(), wrt, seed=SEED).values()
        # the production render at the sensitivity seed, RR off
        m = exp.measures[0]
        if family == "canopy":
            scene, sensor, config, lp, leaves, tris, tp = exp.compile_canopy_scene(
                m, exp.spectral_context(m))
            config = dataclasses.replace(config, rr_depth=config.max_depth)
            raw = exp._render_canopy_raw(scene, lp, leaves, sensor, config, m.spp, SEED, tris,
                                         tp, device="cpu")
        else:
            scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
            config = dataclasses.replace(config, rr_depth=config.max_depth)
            if family.startswith("spherical"):
                # the likelihood-ratio flight takes the exact slant depth:
                # the production render without the sun-tau table
                scene = dataclasses.replace(scene, medium=dataclasses.replace(
                    scene.medium, sun_tau=None, mu_grid=None, sun_r_grid=None,
                    sun_mu_warp=None))
            if family == "dem":
                raw = exp._render_dem_raw(scene, exp.terrain(), sensor, config, m.spp, SEED,
                                          device="cpu")
            else:
                raw = exp._render_one(scene, sensor, config, m.spp, SEED, device="cpu")
        return out, ref, raw

    out, ref, raw = _in_mode(mode, run)
    assert np.array_equal(out["radiance"], raw["radiance"].numpy())
    for ch in wrt:
        a, b = out["jac"][ch]["radiance"], ref["jac"][ch]["radiance"]
        dev = np.abs(a - b) / np.abs(b).max()
        assert np.isfinite(a).all() and np.abs(a).max() > 0
        assert dev.max() <= 1e-2 and np.median(dev) <= 1e-3, (ch, dev.max(), np.median(dev))


def _closed_form(rel, zeniths):
    mu0 = np.cos(np.radians(30.0))
    mus = np.cos(np.radians(zeniths))
    return rel.ravel(), -TAU * (1.0 / mu0 + 1.0 / mus)


@pytest.mark.parametrize("mode", ["mono_single", "mono_polarized_single"])
def test_spherical_absorber_closed_form(mode):
    def run():
        return sensitivities(_spherical(eradiate_tpu_torch, 64, ABSORBER), ["medium.tau_scale"],
                             seed=4, device="cpu")["m"]

    e = _in_mode(mode, run)
    got, want = _closed_form(e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"],
                             VIEWS["zeniths"])
    np.testing.assert_allclose(got, want, rtol=3e-3)


@pytest.mark.parametrize("triangulate", [False, True])
def test_flat_dem_absorber_closed_form(triangulate):
    exp = _dem(experiments, DEMSurface, 64, flat=True, triangulate=triangulate,
               atmosphere=ABSORBER)
    e = sensitivities(exp, ["medium.tau_scale"], seed=4, device="cpu")["m"]
    got, want = _closed_form(e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"],
                             VIEWS["zeniths"])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_leaf_reflectance_matches_crn_finite_differences():
    """canopy.reflectance against a centred common-random-number difference
    of the port's own RR-off renders with the compiled leaf reflectance
    moved by +-0.02 (the reference test's eps and gate)."""
    spp = 1024
    exp = _canopy(eradiate_tpu_torch, spp)
    jvp = sensitivities(exp, ["canopy.reflectance"], seed=11, device="cpu")["m"][
        "jac"]["canopy.reflectance"]["radiance"]
    assert (jvp > 0).all()
    m = exp.measures[0]
    scene, sensor, config, lp, leaves, tris, tp = exp.compile_canopy_scene(
        m, exp.spectral_context(m))
    config = dataclasses.replace(config, rr_depth=config.max_depth)

    def at(eps):
        moved = {**lp, "reflectance": np.asarray(lp["reflectance"]) + eps}
        return exp._render_canopy_raw(scene, moved, leaves, sensor, config, spp, 11, tris, tp,
                                      device="cpu")["radiance"].numpy()

    fd = (at(0.02) - at(-0.02)) / 0.04
    np.testing.assert_allclose(jvp, fd, rtol=0.15, atol=2e-3)


def test_canopy_extinction_channel_is_refused():
    with pytest.raises(ValueError, match="likelihood-ratio"):
        sensitivities(_canopy(eradiate_tpu_torch, 16), ["medium.tau_scale"], device="cpu")
