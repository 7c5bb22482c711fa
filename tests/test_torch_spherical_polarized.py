"""The port's polarized spherical-shell tracer against the JAX package.

Polarized c4 (``bench.py`` ``_c4`` with the ``stokes`` integrator, in
``mono_polarized_single``): the Rayleigh AFGL column in 232 merged shells
over Hapke, 15 view zeniths; at SZA 75 the sun-tau table NEE (K2's plain
twin here), at SZA 85 the exact NEE (K3's), and path B, the ``lr_flight``
primal (K2 then K4). Same seed, same samples:

- ``run`` at 256 spp against ``eradiate_tpu.run``: the c4 gate on I (every
  pixel within |z| <= 5 and 2e-3 relative, at least 12 of 15 within 1e-4,
  the median within 1e-4 at SZA 75, 1e-5 at SZA 85), Q, U and V within
  |z| <= 5 of I's variances. As in scalar c4, a few grazing lanes flip a
  collide decision and the reference rounds the table's radius weights to
  bf16, so the renders are not bitwise.
- Path B against the reference's path B, the same gate, and bit for bit
  against the exact-NEE render of the scene without its table, iteration
  counts included.
- The reference splits the samples into chunks by itself (2^21 paths a
  dispatch), each with its own key: chunked renders at a small ``spp_chunk``
  agree under the gate, and the default chunks equal the reference's
  formula at c4's full width.
- A Rayleigh + continental aerosol column (``tab_polarized``) in spherical
  shells, under the same gate.
- Analogs of ``tests/system/test_spherical_polarized.py``: it polarizes;
  it agrees with the plane-parallel polarized tracer at nadir and moderate
  SZA; V stays zero; the scalar spherical tracer traces the same paths and
  its radiance agrees with I.
- The estimate does not depend on the lane count.
"""

import dataclasses

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.ops import tracer as ref_tracer
from eradiate_tpu.ops.tracer_spherical_polarized import (
    render_spherical_polarized as ref_render_spherical_polarized,
)
from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.ops.tracer import MAX_PATHS_PER_DISPATCH, chunk_plan
from eradiate_tpu_torch.ops.tracer_spherical import render_spherical
from eradiate_tpu_torch.ops.tracer_spherical_polarized import render_spherical_polarized
from test_torch_spherical_experiment import _compile_kwargs as _compile
from test_torch_spherical_experiment import lane_gate

torch.set_num_threads(1)

SPP = 256
MODE = "mono_polarized_single"


def c4_kwargs(sza=75.0, zeniths=np.arange(-85.0, 65.0, 10.0)):
    """BASELINE config 4 (``bench.py`` ``_c4``) with the ``stokes``
    integrator and the sun at ``sza``."""
    return dict(
        geometry="spherical_shell",
        integrator={"type": "volpath", "stokes": True},
        illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": zeniths,
            "azimuth": 0.0,
            "target": [0.0, 0.0, EARTH_RADIUS_KM],
            "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
    )


@pytest.fixture
def polarized():
    eradiate_tpu.set_mode(MODE)
    eradiate_tpu_torch.set_mode(MODE)
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def _pair(kwargs):
    """The port's and the reference's compiled scene, one spectral context."""
    out, ctx = _compile(AtmosphereExperiment, kwargs)
    ref, _ = _compile(RefExperiment, kwargs, ctx)
    return out, ref


def gate(stokes, ref_stokes, var, median_bound, pixels_within=None):
    """The c4 gate on I (|z| <= 5 of ``var``, the two runs' variances of I
    summed, every pixel within 2e-3, ``pixels_within`` (default all but 3)
    within 1e-4, the median within ``median_bound``), and |z| <= 5 on Q, U
    and V with I's variances."""
    stokes, ref_stokes = np.asarray(stokes), np.asarray(ref_stokes)
    assert stokes.shape == ref_stokes.shape and stokes.shape[-1] == 4
    assert np.isfinite(stokes).all() and (stokes[..., 0] > 0).all()
    I, ref_I = stokes[..., 0], ref_stokes[..., 0]
    rel = np.abs(I - ref_I) / np.abs(ref_I)
    z = np.abs(stokes - ref_stokes) / np.sqrt(var)[..., None]
    assert z.max() <= 5.0, z.max(axis=-2)
    assert rel.max() <= 2e-3, rel
    n = I.size - 3 if pixels_within is None else pixels_within
    assert (rel <= 1e-4).sum() >= n, rel
    assert np.median(rel) <= median_bound, rel


def _var(out, ref, spp):
    """The two renders' variances of I summed (``m2`` holds I's second
    moment)."""
    rad, ref_rad = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    return (np.asarray(out["m2"]) - rad**2 + np.asarray(ref["m2"]) - ref_rad**2) / spp


@pytest.mark.parametrize("sza, median_bound", [(75.0, 1e-4), (85.0, 1e-5)])
def test_run_matches_reference(polarized, sza, median_bound):
    ref = eradiate_tpu.run(RefExperiment(**c4_kwargs(sza)), spp=SPP, seed_state=SeedState(7),
                           mesh=None)
    exp = AtmosphereExperiment(**c4_kwargs(sza))
    out = eradiate_tpu_torch.run(exp, spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7),
                                 device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    assert {"I", "Q", "U", "V", "dolp"} <= set(out.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    stokes, ref_stokes = (np.stack([np.asarray(ds[c]) for c in "IQUV"], -1) for ds in (out, ref))
    assert stokes.shape == (1, 15, 4)
    gate(stokes, ref_stokes, np.asarray(out["var"]) + np.asarray(ref["var"]), median_bound)
    assert exp.measures[0].results["raw"]["iterations"] > 0


def _render_pair(out_scene, ref_scene, spp, seed, lr_flight=False, spp_chunk=None):
    (scene, sensor, config), (r_scene, r_sensor, r_config) = out_scene, ref_scene
    out = render_spherical_polarized(
        scene, sensor, dataclasses.replace(config, lr_flight=lr_flight), spp, seed=seed,
        spp_chunk=spp_chunk, device="cpu")
    ref = ref_render_spherical_polarized(
        r_scene.medium, r_scene.surface, r_scene.illumination, r_sensor,
        dataclasses.replace(r_config, lr_flight=lr_flight), spp=spp, seed=seed,
        spp_chunk=spp_chunk)
    return out, ref


def test_lr_flight_matches_reference(polarized):
    """Path B (K2 then K4) against the reference's render with
    ``lr_flight``: the c4 gate."""
    out, ref = _render_pair(*_pair(c4_kwargs(75.0)), SPP, seed=3, lr_flight=True)
    gate(out["stokes"].numpy(), ref["stokes"], _var(out, ref, SPP), 1e-4)


def test_lr_flight_equals_the_exact_nee_bitwise(polarized):
    """Flight plus slant depth is what the event twin fuses: with the table
    off the polarized render runs the event twin, and the two renders are
    equal bit for bit, iteration counts included."""
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, c4_kwargs(75.0))
    assert scene.medium.sun_tau is not None
    lr = render_spherical_polarized(scene, sensor, dataclasses.replace(config, lr_flight=True),
                                    64, seed=3, device="cpu")
    medium = dataclasses.replace(scene.medium, sun_tau=None, mu_grid=None, sun_r_grid=None,
                                 sun_mu_warp=None)
    exact = render_spherical_polarized(dataclasses.replace(scene, medium=medium), sensor,
                                       config, 64, seed=3, device="cpu")
    assert lr["iterations"] == exact["iterations"] > 0
    for k in ("stokes", "m2"):
        assert torch.equal(lr[k], exact[k])


def test_chunked_renders_match_reference(polarized):
    """64 spp in chunks of 40 (the last of 24), each with the reference's
    key ``fold_in(fold_in(key(seed), row), chunk)``: the renders within
    |z| <= 5, and the second chunk's lanes (key ``chunk = 1``; the first
    chunk's is every unchunked render's) hold the lane gate: none of its 45
    lanes takes another branch at this seed, at most 2 may."""
    out_scene, ref_scene = _pair(c4_kwargs(85.0))
    out, ref = _render_pair(out_scene, ref_scene, 64, seed=5, spp_chunk=40)
    assert out["spp"] == ref["spp"] == 64
    z = np.abs(out["stokes"].numpy() - np.asarray(ref["stokes"])) / np.sqrt(
        _var(out, ref, 64))[..., None]
    assert z.max() <= 5.0
    assert chunk_plan(64, 40, 1, 15, MAX_PATHS_PER_DISPATCH) == [40, 24]
    lane_gate(out_scene, ref_scene, 24, seed=5, max_flips=2, chunk_id=1)


def test_default_chunks_follow_the_reference():
    """The default split equals the reference's formula, by arithmetic:
    ``MAX_PATHS_PER_DISPATCH // (S * n_pix)`` samples a chunk. At c4's full
    width (1 row, 15 pixels, 2097152 spp) that is 15 chunks of 139810 and
    one of 2; below the cap, one chunk."""
    assert MAX_PATHS_PER_DISPATCH == ref_tracer.MAX_PATHS_PER_DISPATCH
    step = ref_tracer.MAX_PATHS_PER_DISPATCH // 15
    full = chunk_plan(2097152, None, 1, 15, MAX_PATHS_PER_DISPATCH)
    assert full == [step] * 15 + [2097152 - 15 * step]
    assert step == 139810 and len(full) == 16
    assert chunk_plan(256, None, 1, 15, MAX_PATHS_PER_DISPATCH) == [256]
    assert chunk_plan(100, 40, 1, 15, MAX_PATHS_PER_DISPATCH) == [40, 40, 20]


def aerosol_kwargs(n_vza=5):
    """c2's atmosphere (``test_cases.create_rpv_afgl1986_continental_brfpp``:
    AFGL Rayleigh with a 0-2 km continental aerosol layer, tau 0.2 at 550
    nm) and RPV floor in spherical shells, sun at SZA 30."""
    return dict(
        geometry="spherical_shell",
        integrator={"type": "volpath", "stokes": True},
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "target": [0.0, 0.0, EARTH_RADIUS_KM],
            "id": "m",
        },
        surface={"type": "rpv"},
        atmosphere={
            "type": "heterogeneous",
            "molecular_atmosphere": {"type": "molecular"},
            "particle_layers": [{"type": "particle_layer", "bottom": 0.0, "top": 2.0,
                                 "tau_ref": 0.2, "dataset": "govaerts_2021-continental"}],
        },
    )


def test_aerosol_column_matches_reference(polarized):
    """The Rayleigh + continental aerosol column (``tab_polarized``) over
    RPV in spherical shells, 5 view zeniths, 256 spp: the lane gate (at
    most 8 of 160 lanes take another branch; the aerosol's forward peak and
    the +-75 degree views make flips likelier than in c4), the renders
    within |z| <= 5 on I, Q, U and V."""
    out_scene, ref_scene = _pair(aerosol_kwargs())
    assert out_scene[2].phase_kinds == ref_scene[2].phase_kinds == ("rayleigh", "tab_polarized")
    lane_gate(out_scene, ref_scene, SPP, seed=7, max_flips=8)


@pytest.mark.parametrize("sza", [75.0, 85.0])
def test_estimate_independent_of_lane_count(polarized, sza):
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, c4_kwargs(sza))
    out = [
        render_spherical_polarized(scene, sensor, config, 64, seed=3, device="cpu",
                                   lanes_target=lt)["stokes"].numpy()
        for lt in (15 * 8, 15 * 3)  # 8 and 3 lanes per pixel
    ]
    np.testing.assert_allclose(out[1][..., 0], out[0][..., 0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-6 * out[0][..., :1].max())


def _homogeneous(geometry, spp=2048):
    """The scene of ``tests/system/test_spherical_polarized.py``: a
    homogeneous Rayleigh layer (sigma_s 0.02 / km, 20 km) over a dark
    Lambertian floor, SZA 60, one view at VZA 45 in the backward plane."""
    exp = AtmosphereExperiment(
        integrator={"type": "volpath", "stokes": True},
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0, "irradiance": 1.0},
        measures={"type": "mdistant", "construct": "from_angles", "angles": [[45.0, 180.0]],
                  "spp": spp, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.05},
        atmosphere={"type": "homogeneous", "sigma_s": 0.02, "top": 20.0},
        geometry={"type": geometry, "toa_altitude": 20.0},
    )
    ds = eradiate_tpu_torch.run(exp, seed_state=eradiate_tpu_torch.SeedState(42), device="cpu")
    return {k: float(np.asarray(ds[k]).ravel()[0]) for k in ("I", "Q", "U", "V", "dolp", "var")}


@pytest.fixture(scope="module")
def homogeneous():
    eradiate_tpu_torch.set_mode(MODE)
    try:
        yield {g: _homogeneous(g) for g in ("spherical_shell", "plane_parallel")}
    finally:
        eradiate_tpu_torch.set_mode("mono")


def test_spherical_polarizes(homogeneous):
    """Single-scattering Rayleigh at ~75 degrees over a dark floor is
    clearly polarized."""
    ss = homogeneous["spherical_shell"]
    assert np.isfinite(ss["I"]) and ss["I"] > 0
    assert 0.2 < ss["dolp"] <= 1.0


def test_spherical_matches_plane_parallel(homogeneous):
    """At VZA 45 and SZA 60 over a 20 km layer the curvature is negligible:
    I within 5 sigma (or 5%), Q of the same sign and within 15% (or 5
    sigma)."""
    ss, pp = homogeneous["spherical_shell"], homogeneous["plane_parallel"]
    sigma = np.sqrt(ss["var"] + pp["var"])
    assert abs(ss["I"] - pp["I"]) < max(5 * sigma, 0.05 * pp["I"])
    assert np.sign(ss["Q"]) == np.sign(pp["Q"])
    assert abs(ss["Q"] - pp["Q"]) < max(0.15 * abs(pp["Q"]), 5 * sigma)


def test_spherical_v_stays_zero(homogeneous):
    """Rayleigh and a Lambertian floor never make circular polarization."""
    ss = homogeneous["spherical_shell"]
    assert abs(ss["V"]) < 1e-6 * ss["I"]


def test_i_agrees_with_the_scalar_tracer(polarized):
    """Both tracers draw the same uniforms from the same slots, so at one
    seed they trace the same paths (the same event iterations, on c4 at SZA
    75 and through path B); I differs from the scalar radiance only where
    multiple scattering carries polarization (vector against scalar
    transport, a few percent for Rayleigh): within 2e-2, the reference
    system test's bound."""
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, c4_kwargs(75.0))
    for lr_flight in (False, True):
        pol = render_spherical_polarized(scene, sensor,
                                         dataclasses.replace(config, lr_flight=lr_flight), 64,
                                         seed=9, device="cpu")
        scalar = render_spherical(scene, sensor,
                                  dataclasses.replace(config, polarized=False,
                                                      lr_flight=lr_flight), 64,
                                  seed=9, device="cpu")
        assert pol["iterations"] == scalar["iterations"]
        np.testing.assert_allclose(pol["radiance"].numpy(), scalar["radiance"].numpy(),
                                   rtol=2e-2, atol=0)


@pytest.mark.parametrize("field, value, error, name", [
    ("polarized", False, ValueError, "render_spherical"),
    ("surface_kind", "no_such_kind", ValueError, "'no_such_kind'"),
    ("geometry", "plane_parallel", NotImplementedError, "plane_parallel"),
])
def test_unported_features_raise(polarized, field, value, error, name):
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, c4_kwargs(75.0))
    with pytest.raises(error, match=name):
        render_spherical_polarized(scene, sensor, dataclasses.replace(config, **{field: value}),
                                   8, device="cpu")
