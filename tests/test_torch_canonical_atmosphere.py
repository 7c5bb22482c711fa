"""The reference's canonical atmosphere scenes in the port, against the JAX
package, on the CPU; the spherical tracer's and the polarized tracer's
system checks.

The scene factories are the port's copies of
``eradiate_tpu/test_tools/test_cases.py``: the RPV floor under the AFGL 1986
column (``rpv_afgl1986``), the RAMI4ATM case (Rayleigh with a continental
aerosol layer), the two GRASP oceans (no atmosphere, an 8-wavelength
``multi_delta`` response) and the spherical-shell RPV case
(``spherical_rpv``: a target at the Earth's radius, the shell flight). Each
runs in ``mono_single`` through ``eradiate_tpu_torch.run(...,
device="cpu")`` and ``eradiate_tpu.run`` at the same seed, at small spp and
few views, under its tracer's gate: the plane-parallel ones within 1e-5
relative on every pixel (radiance, second moment and BRF); ``spherical_rpv`` under c4's gate (every pixel
within |z| <= 5 of the two runs' variances and 2e-3 relative, the median
within 1e-4).

System checks of the port alone (counterparts of
``tests/system/test_spherical.py`` and ``tests/system/test_sos_anchor.py``):
in spherical shells without an atmosphere the BRF is the Lambertian
reflectance; in a Rayleigh column at SZA 20 the spherical BRF is the
plane-parallel one within 5 sigma plus 1%; the sun's slant optical depth,
from the tracers' table and from the exact slant depth, agrees with a
brute-force march. The port's copy of ``physics/vector_sos.py`` agrees with
its copy of ``physics/vector_doubling.py`` as the reference's two do, and
the port's polarized c1 (a Rayleigh column of one composition, so that it
is the solvers' homogeneous slab of the same optical depth) agrees with the
successive orders of scattering within the anchor's tolerances.
"""

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.test_tools import test_cases as ref_cases
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.ops import spherical as sph
from eradiate_tpu_torch.physics.vector_doubling import rayleigh_stokes_toa
from eradiate_tpu_torch.physics.vector_sos import rayleigh_stokes_toa_sos
from eradiate_tpu_torch.test_tools import test_cases as cases

torch.set_num_threads(1)

SEED = 7

#: scene -> (factory, its arguments): small spp, few views
PLANE_PARALLEL = {
    "rpv_afgl1986": ("create_rpv_afgl1986_brfpp", dict(spp=64, n_vza=5)),
    "rami4atm": ("create_rami4atm_toa_brfpp", dict(spp=64, n_vza=5)),
    "ocean_grasp_coastal": ("create_ocean_grasp_coastal_no_atm", dict(spp=16)),
    "ocean_grasp_open": ("create_ocean_grasp_open_no_atm", dict(spp=16)),
}


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def both(factory, **kwargs):
    """The scene rendered by the reference and by the port at one seed."""
    ref = eradiate_tpu.run(getattr(ref_cases, factory)(**kwargs),
                           seed_state=eradiate_tpu.SeedState(SEED), mesh=None)
    out = eradiate_tpu_torch.run(getattr(cases, factory)(**kwargs),
                                 seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)
    assert np.isfinite(np.asarray(out["brf"])).all()
    return out, ref


def test_every_factory_is_copied():
    assert cases.__all__ == ref_cases.__all__
    assert cases.OCEAN_GRASP_WAVELENGTHS == ref_cases.OCEAN_GRASP_WAVELENGTHS


@pytest.mark.parametrize("scene", list(PLANE_PARALLEL))
def test_plane_parallel_scene_matches_reference(mono_single, scene):
    factory, kwargs = PLANE_PARALLEL[scene]
    out, ref = both(factory, **kwargs)
    if scene.startswith("ocean"):
        assert np.asarray(out["brf"]).shape == (8, 25)  # the 8 multi_delta wavelengths
    for k in ("radiance", "m2", "brf"):  # var = m2 - radiance^2 cancels
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=0, err_msg=k)


def test_spherical_rpv_matches_reference(mono_single):
    out, ref = both("create_spherical_rpv_brfpp", spp=64)
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    assert rad.shape == (1, 15)
    z = np.abs(rad - rad_ref) / np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    rel = np.abs(rad - rad_ref) / np.abs(rad_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert np.median(rel) <= 1e-4


# -- the spherical tracer's system checks (tests/system/test_spherical.py) ----


def _hplane(zeniths, spp):
    return {"type": "mdistant", "construct": "hplane", "zeniths": zeniths, "azimuth": 0.0,
            "spp": spp, "id": "m"}


def test_spherical_without_atmosphere_gives_the_reflectance(mono_single):
    exp = AtmosphereExperiment(
        geometry={"type": "spherical_shell"},
        illumination={"type": "directional", "zenith": 30.0},
        measures=_hplane([-45.0, 0.0, 45.0], 8),
        surface={"type": "lambertian", "reflectance": 0.4},
        atmosphere=None,
    )
    result = eradiate_tpu_torch.run(exp, seed_state=eradiate_tpu_torch.SeedState(SEED),
                                    device="cpu")
    np.testing.assert_allclose(np.asarray(result["brf"]), 0.4, atol=1e-4)


def test_spherical_converges_to_plane_parallel(mono_single):
    """A Rayleigh column at SZA 20: spherical within 5 sigma plus 1% of
    plane-parallel."""
    kwargs = dict(
        illumination={"type": "directional", "zenith": 20.0},
        measures=_hplane([0.0, 30.0], 4096),
        surface={"type": "lambertian", "reflectance": 0.3},
        atmosphere={"type": "molecular"},
    )
    r_pp = eradiate_tpu_torch.run(AtmosphereExperiment(**kwargs),
                                  seed_state=eradiate_tpu_torch.SeedState(1), device="cpu")
    r_sp = eradiate_tpu_torch.run(AtmosphereExperiment(geometry={"type": "spherical_shell"},
                                                       **kwargs),
                                  seed_state=eradiate_tpu_torch.SeedState(2), device="cpu")
    bp, bs = np.asarray(r_pp["brf"])[0], np.asarray(r_sp["brf"])[0]
    sig = np.pi * np.sqrt(np.asarray(r_pp["var"])[0] + np.asarray(r_sp["var"])[0]) / float(
        np.asarray(r_pp["irradiance"])[0])
    assert np.all(np.abs(bp - bs) < 5 * sig + 0.01 * bp), (bp, bs, sig)


def _marched_tau(r0, mu, radii, sigma, ds=0.01):
    """Brute force: march from radius r0 at local cosine mu in steps of ds
    km, summing the shell's extinction; inf where the ray meets the ground."""
    t = np.arange(1, 400_000) * ds
    p = np.stack([np.sqrt(max(1.0 - mu * mu, 0.0)) * t, np.zeros_like(t), r0 + mu * t], -1)
    r = np.linalg.norm(p, axis=-1)
    if (r <= radii[0]).any():
        return np.inf
    inside = r < radii[-1]
    k = np.clip(np.searchsorted(radii, r[inside]) - 1, 0, sigma.size - 1)
    return float(sigma[k].sum() * ds)


def test_slant_depth_against_brute_force():
    """The sun's slant optical depth from the tracers' table
    (``sun_tau_table_grid`` on a uniform radius grid and the warped cosine
    grid, fetched by ``sun_tau_fetch_fast``) and from ``slant_tau_exact``,
    against a brute-force march: an exponential column of 100 shells."""
    R = 6378.0
    z = np.linspace(0.0, 100.0, 101)
    radii = R + z
    sigma = 0.012 * np.exp(-z[:-1] / 8.0)
    r_grid = np.linspace(radii[0], radii[-1], 401)
    mu_grid, warp = sph.sun_mu_grid_warped()
    table = sph.sun_tau_table_grid(torch.tensor(sigma[None], dtype=torch.float32),
                                   torch.tensor(radii, dtype=torch.float32),
                                   torch.tensor(r_grid, dtype=torch.float32),
                                   torch.tensor(mu_grid, dtype=torch.float32))[0]
    points = [(R + 0.0, 0.8), (R + 20.0, 0.3), (R + 5.0, -0.05), (R + 50.0, 0.05),
              (R + 1.0, -0.9)]
    r0 = torch.tensor([p[0] for p in points], dtype=torch.float32)
    mu = torch.tensor([p[1] for p in points], dtype=torch.float32)
    fetched = sph.sun_tau_fetch_fast(table, torch.tensor(r_grid, dtype=torch.float32), warp,
                                     r0, mu).numpy()
    p = torch.stack([torch.zeros_like(r0), torch.zeros_like(r0), r0], -1)
    exact = torch.stack([
        sph.slant_tau_exact(p[i:i + 1], torch.stack([torch.sqrt(1 - m * m), torch.zeros(()), m]),
                            torch.tensor(radii, dtype=torch.float32),
                            torch.tensor(sigma, dtype=torch.float32))[0]
        for i, m in enumerate(mu)]).numpy()
    for i, (r, m) in enumerate(points):
        marched = _marched_tau(r, m, radii, sigma)
        if np.isinf(marched):  # the planet blocks the sun
            assert exact[i] >= sph.TAU_BLOCKED
            continue
        np.testing.assert_allclose(exact[i], marched, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(fetched[i], marched, rtol=0.02, atol=0.002)


# -- the polarized anchor (tests/system/test_sos_anchor.py) --------------------

MU_V = np.array([0.2, 0.5, 0.8, 0.95])
DPHI = np.array([0.0, 0.7, 2.0, 3.0])


@pytest.mark.parametrize(
    "tau,albedo,depol",
    [(0.1, 0.0, 0.0), (0.5, 0.0, 0.0), (0.5, 0.25, 0.0), (1.0, 0.0, 0.0),
     (1.0, 0.25, 0.0279)],
)
def test_sos_agrees_with_doubling(tau, albedo, depol):
    """The port's two deterministic solvers, which share no code, agree at
    1e-4 of the peak Stokes magnitude, as the reference's do."""
    a = rayleigh_stokes_toa(tau, 0.6, MU_V, DPHI, albedo=albedo, depol=depol)
    b = rayleigh_stokes_toa_sos(tau, 0.6, MU_V, DPHI, albedo=albedo, depol=depol)
    scale = np.abs(a).max()
    np.testing.assert_allclose(b, a, atol=1e-4 * scale)
    assert np.abs(a[:, 1]).max() > 100 * 1e-4 * scale


def test_polarized_c1_matches_successive_orders():
    """c1 (AFGL Rayleigh at 550 nm over a Lambertian 0.5, SZA 30) in
    ``mono_polarized_single`` at 32768 spp against ``vector_sos`` on the
    column's optical depth and depolarization: I within 4 sigma plus 2e-4
    of the first I and 1%; Q/I, U/I, V/I within the larger of 4 sigma/I and
    0.006 (``tests/test_torch_polarized_anchor.py``'s tolerances)."""
    spp, sza = 32768, 30.0
    eradiate_tpu_torch.set_mode("mono_polarized_single")
    try:
        exp = AtmosphereExperiment(
            integrator={"type": "volpath", "stokes": True},
            illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
            # no nadir view: the solvers' Stokes frame is undefined there
            measures=_hplane([-60.0, -20.0, 20.0, 60.0], spp),
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "molecular"},
            geometry={"type": "plane_parallel", "layer_merge_tol": 1e-3},
        )
        m = exp.measures[0]
        scene, sensor, _ = exp.compile_scene(m, exp.spectral_context(m))
        ds = eradiate_tpu_torch.run(exp, seed_state=eradiate_tpu_torch.SeedState(SEED),
                                    device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono")
    medium = scene.medium
    albedo = np.asarray(medium.albedo)
    depol = np.asarray(medium.phase_params[0]["depol"])
    assert (albedo == 1.0).all() and (depol == depol.flat[0]).all()  # one composition
    tau = float(np.asarray(medium.tau_levels)[0, -1])
    d = np.asarray(sensor.directions, np.float64)
    # the sun propagates toward azimuth 180 deg; the solvers' azimuth is the
    # view's relative to the sun's horizontal propagation
    S = rayleigh_stokes_toa_sos(tau, np.cos(np.deg2rad(sza)), d[:, 2],
                                np.arctan2(d[:, 1], d[:, 0]) - np.pi, albedo=0.5,
                                depol=float(depol.flat[0]))
    # as reflectance factors: the solvers' pi S / mu0, the port's Stokes
    # vector scaled as its BRF
    S = S * (np.pi / np.cos(np.deg2rad(sza)))
    I = np.asarray(ds["I"])[0]
    to_brf = np.asarray(ds["brf"])[0] / I
    st = np.stack([np.asarray(ds[c])[0] for c in "IQUV"], -1) * to_brf[:, None]
    sigma_I = np.sqrt(np.asarray(ds["var"])[0]) * to_brf
    np.testing.assert_allclose(st[:, 0], S[:, 0], rtol=0.01,
                               atol=np.max(4 * sigma_I) + 2e-4 * S[0, 0])
    ratio_tol = float(np.max(np.maximum(4 * sigma_I / S[:, 0], 0.006)))
    for c in (1, 2):
        np.testing.assert_allclose(st[:, c] / st[:, 0], S[:, c] / S[:, 0], atol=ratio_tol)
    np.testing.assert_allclose(st[:, 3] / st[:, 0], 0.0, atol=ratio_tol)
    assert np.abs(S[:, 1] / S[:, 0]).max() > 2 * ratio_tol  # the views are polarized
