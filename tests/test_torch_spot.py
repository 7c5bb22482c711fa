"""The spot emitter over a canopy, in the port against the JAX package.

The small HET01 of the canopy tests (one 200-leaf sphere cloud at three
positions in a 30 m x 30 m x 15 m canopy over a Lambertian floor; also as
abstract trees, the crown on a 6 m trunk) lit by a spot placed as
``SpotIllumination.from_size_at_target`` places it (a 20 m spot at the plot's
centre, beam half-width 30 degrees) and seen by a 4 x 4 box ``perspective``
camera 50 m from the plot, at 64 spp. ``eradiate_tpu_torch.run(..., device="cpu")`` and
``eradiate_tpu.run`` at the same seed meet the canopy gate (every pixel within
|z| <= 5 and 2e-3 relative, the median within 1e-4), scalar and polarized,
and scalar under the Rayleigh atmosphere (the finite segment's
transmittance). The spot's shadow rays are any-hit sweeps that end at the
emitter (finite ``t_max``): the leaves' and the trunks' plain any-hit sweeps
equal the reference's bit for bit there, and a leaf beyond the spot does not
shadow. Seen from the top of the atmosphere by ``mdistant`` the port agrees
with the reference in float32 by the statistical gate only (|z| <= 5, the
median pixel within 1e-4): positions 100 km from their ray's start carry
float32 rounding of ~1e-5 km, which the inverse square turns into relative
differences of 1e-5 to 1e-4 and which flips a rare path (a pixel moved by
16% at 128 spp). In ``mono_double`` under x64 the same scene agrees within
1e-10 in every pixel. The scalar plane-parallel tracer
refuses a spot with the reference's words; the polarized and spherical
ones render what the reference renders (the spot as a sun along its axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu.ops import canopy as ref_canopy
from eradiate_tpu.ops import mesh as ref_mesh
from eradiate_tpu_torch import AtmosphereExperiment, CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.ops import canopy, mesh
from eradiate_tpu_torch.ops.scene_state import canopy_from_reference
from eradiate_tpu_torch.scenes.illumination import SpotIllumination

from test_torch_polarized_canopy import canopy as canopy_dict

torch.set_num_threads(1)

SPP = 64
SEED = 13
_spot = SpotIllumination.from_size_at_target(
    target=[0.0, 0.0, 0.0], direction=[0.2, 0.0, -1.0], spot_radius=0.02, beam_width=30.0)
SPOT = {"type": "spot", "origin": _spot.origin.tolist(), "target": _spot.target.tolist(),
        "beam_width": 30.0, "intensity": 1.0}
CAMERA = {"type": "perspective", "origin": [0.0, -0.03, 0.04], "target": [0.0, 0.0, 0.0],
          "film_resolution": (4, 4), "fov": 50.0, "id": "m"}
MDISTANT = {"type": "mdistant", "construct": "hplane", "zeniths": np.linspace(-60, 60, 5),
            "azimuth": 0.0, "id": "m"}


def experiments(form="instanced", atmosphere=False, measure=CAMERA, stokes=False):
    """``(port experiment, reference experiment)`` of the spot-lit canopy."""
    kw = dict(canopy=canopy_dict(form), illumination=dict(SPOT), measures=dict(measure),
              surface={"type": "lambertian", "reflectance": 0.159},
              integrator={"type": "volpath", "stokes": stokes})
    if atmosphere:
        kw["atmosphere"] = {"type": "molecular", "has_absorption": False}
        return CanopyAtmosphereExperiment(**kw), RefCanopyAtmosphere(**kw)
    return CanopyExperiment(**kw), RefCanopy(**kw)


def set_modes(mode):
    eradiate_tpu.set_mode(mode)
    eradiate_tpu_torch.set_mode(mode)


@pytest.fixture
def modes():
    yield set_modes
    set_modes("mono")


def run_pair(port, ref, spp=SPP):
    out = eradiate_tpu_torch.run(port, spp=spp, seed_state=eradiate_tpu_torch.SeedState(SEED),
                                 device="cpu")
    return out, eradiate_tpu.run(ref, spp=spp, seed_state=SeedState(SEED), mesh=None)


def gate(out, ref, max_rel=2e-3):
    """The canopy gate on the radiance (I); with Stokes output Q, U and V
    within |z| <= 5 of I's standard deviation. Returns (max |z|, max rel,
    median rel)."""
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    sd = np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    assert rad.shape == rad_ref.shape and np.isfinite(rad).all()
    lit = rad_ref > 0
    assert lit.mean() > 0.5
    np.testing.assert_array_equal(rad[~lit], 0.0)
    z = np.abs(rad - rad_ref)[lit] / sd[lit]
    rel = np.abs(rad - rad_ref)[lit] / rad_ref[lit]
    assert z.max() <= 5.0, z.max()
    assert rel.max() <= max_rel, rel.max()
    assert np.median(rel) <= 1e-4, np.median(rel)
    for c in ("Q", "U", "V") if "Q" in ref.data_vars else ():
        dz = np.abs(np.asarray(out[c]) - np.asarray(ref[c]))[lit] / sd[lit]
        assert dz.max() <= 5.0, (c, dz.max())
    return z.max(), rel.max(), np.median(rel)


@pytest.mark.parametrize("mode, atmosphere", [("mono_single", False), ("mono_single", True),
                                              ("mono_polarized_single", False)])
def test_spot_canopy_matches_reference(modes, mode, atmosphere):
    modes(mode)
    stokes = mode.startswith("mono_polarized")
    out, ref = run_pair(*experiments(atmosphere=atmosphere, stokes=stokes))
    assert set(out.data_vars) == set(ref.data_vars)
    gate(out, ref)


def test_spot_over_trees_matches_reference(modes):
    """Abstract trees: the trunks' any-hit sweep ends at the spot too."""
    modes("mono_single")
    out, ref = run_pair(*experiments("tree"))
    gate(out, ref)


def test_spot_distant_sensor_agrees_statistically(modes):
    modes("mono_single")
    out, ref = run_pair(*experiments(measure=MDISTANT))
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    z = np.abs(rad - rad_ref) / np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    rel = np.abs(rad - rad_ref) / rad_ref
    assert np.isfinite(rad).all() and (rad_ref > 0).all()
    assert z.max() <= 5.0 and np.median(rel) <= 1e-4


def test_spot_distant_sensor_double_matches_reference_under_x64(modes):
    """The scene of :func:`test_spot_distant_sensor_agrees_statistically` in
    ``mono_double``, the reference under x64: every pixel's radiance and
    second moment within 1e-10, so the float32 run's spread comes from its
    rounding, not from the spot's terms."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        modes("mono_double")
        out, ref = run_pair(*experiments(measure=MDISTANT))
    finally:
        jax.config.update("jax_enable_x64", old)
    for k in ("radiance", "m2"):
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype == np.float64, k
        assert (b > 0).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0, err_msg=k)


def test_spot_refused_by_the_scalar_atmosphere_tracer(modes):
    """As in the reference (``tests/system/test_spot.py``): a distant sensor
    bank over a plain surface cannot see a point source."""
    modes("mono_single")
    kw = dict(illumination=dict(SPOT), measures=dict(MDISTANT),
              surface={"type": "lambertian", "reflectance": 0.5}, atmosphere=None)
    for run, exp in ((eradiate_tpu.run, RefExperiment(**kw)),
                     (eradiate_tpu_torch.run, AtmosphereExperiment(**kw))):
        extra = {"mesh": None} if run is eradiate_tpu.run else {"device": "cpu"}
        with pytest.raises(NotImplementedError, match="canopy tracer only"):
            run(exp, spp=8, **extra)


def test_spot_polarized_atmosphere_renders_as_reference(modes):
    """The reference's polarized plane-parallel tracer reads the spot's axis
    and intensity as a sun's direction and irradiance; the port renders the
    same, within 1e-5."""
    modes("mono_polarized_single")
    kw = dict(illumination=dict(SPOT), measures=dict(MDISTANT),
              surface={"type": "lambertian", "reflectance": 0.5},
              atmosphere={"type": "molecular"}, integrator={"type": "volpath", "stokes": True})
    out, ref = run_pair(AtmosphereExperiment(**kw), RefExperiment(**kw), spp=64)
    for k in ("I", "Q", "U"):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(np.asarray(ref["I"])).max()))


def test_spot_spherical_renders_as_reference(modes):
    """So does the reference's spherical tracer: the port renders the same,
    by c4's gate (|z| <= 5 a pixel) and within 1e-4."""
    modes("mono_single")
    kw = dict(illumination=dict(SPOT), measures=dict(MDISTANT),
              surface={"type": "lambertian", "reflectance": 0.5},
              atmosphere={"type": "molecular"}, geometry="spherical_shell")
    out, ref = run_pair(AtmosphereExperiment(**kw), RefExperiment(**kw), spp=64)
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    z = np.abs(rad - rad_ref) / np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    assert (rad_ref > 0).all() and z.max() <= 5.0
    np.testing.assert_allclose(rad, rad_ref, rtol=1e-4, atol=0)


def _shadow_rays(port_exp, ref_exp, B=4096, seed=3):
    """Shadow rays from points of the canopy toward a spot inside its crowns
    (10 m up at the plot's centre), ending there; the compiled leaves and
    triangles of both packages."""
    m, rm = port_exp.measures[0], ref_exp.measures[0]
    port = port_exp.compile_canopy_scene(m, port_exp.spectral_context(m))
    ref = ref_exp.compile_canopy_scene(rm, ref_exp.spectral_context(rm))
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-0.015, 0.015, B), rng.uniform(-0.015, 0.015, B),
                  rng.uniform(0.0, 0.015, B)], axis=-1).astype(np.float32)
    v = np.array([0.0, 0.0, 0.010], np.float32) - p
    r = np.linalg.norm(v, axis=-1).astype(np.float32)
    d = (v / r[:, None]).astype(np.float32)
    return p, d, r, port, ref


@pytest.mark.parametrize("form", ["instanced", "flat", "tree"])
def test_finite_t_max_any_hit_matches_reference(modes, form):
    """The any-hit sweeps' plain versions on shadow rays with a finite
    ``t_max`` equal the jitted reference's sweeps lane for lane, and the
    finite ``t_max`` matters: rays that meet a leaf only beyond the spot
    are not shadowed."""
    modes("mono_single")
    port_exp, ref_exp = experiments(form)
    p, d, r, port, ref = _shadow_rays(port_exp, ref_exp)
    leaves, _, tris, _ = canopy_from_reference(port[4], port[3], "cpu", port[5], port[6])
    args = [torch.as_tensor(x) for x in (p, d, r)]
    far = torch.full_like(args[2], 1e6)
    ref_args = [jnp.asarray(x) for x in (p, d, r)]
    occ = canopy.leaf_occluded(*args, leaves).numpy()
    ref_occ = np.asarray(jax.jit(lambda a, b, c: ref_canopy.leaf_occluded(a, b, c, ref[4]))(
        *ref_args))
    np.testing.assert_array_equal(occ, ref_occ)
    assert 0 < occ.sum() < canopy.leaf_occluded(args[0], args[1], far, leaves).numpy().sum()
    if form == "tree":
        occ = mesh.tri_occluded(*args, tris).numpy()
        ref_occ = np.asarray(jax.jit(lambda a, b, c: ref_mesh.tri_occluded(a, b, c, ref[5]))(
            *ref_args))
        np.testing.assert_array_equal(occ, ref_occ)
        assert occ.any()
