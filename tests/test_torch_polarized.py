"""The port's polarized plane-parallel tracer against the JAX package.

Same seed, same samples: on a tiny c1-class scene (8 Rayleigh layers with
air's depolarization, 4 view zeniths, 4 spectral rows) over Lambertian,
Maignan, Mishchenko-ocean and RPV (a depolarizer) floors, the port's ``render_polarized`` gives
the reference's I within 1e-5 relative per pixel (the c1 gate) and its Q, U
and V within 1e-5 of I; so does ``run()`` on c1 in ``mono_polarized_single``,
with the same dataset layout (Stokes components and ``dolp``). The estimate
does not change with the lane count or the host's check interval. Each
collision goes through the collision fetch (K1's plain twin here). The
scalar tracer refuses a polarized config and names the polarized renderer;
``run()`` takes a polarized spherical-shell scene to the polarized
spherical tracer (held against the reference in
``test_torch_spherical_polarized.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.ops.scene_state import SurfaceArrays
from eradiate_tpu.ops.tracer_polarized import render_polarized as ref_render_polarized
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.kernels import collision_fetch as cf
from eradiate_tpu_torch.ops import tracer_polarized
from eradiate_tpu_torch.ops.scene_state import from_reference
from eradiate_tpu_torch.ops.tracer import render
from eradiate_tpu_torch.ops.tracer_polarized import render_polarized

torch.set_num_threads(1)

SEED = 3
RTOL = 1e-5
S = 4

SURFACES = {
    "lambertian": {"reflectance": 0.5},
    "maignan": {"rho_0": 0.183, "k": 0.78, "g": -0.1, "rho_c": 0.183, "C": 5.0, "ndvi": 0.8,
                "refr_re": 1.5, "refr_im": 0.0, "ext_ior": 1.000277},
    "ocean_mishchenko": {"wind_speed": 2.0, "eta": 1.33, "k": 0.0, "ext_ior": 1.000277,
                         "shadowing": 1.0},
    "rpv": {"rho_0": 0.183, "k": 0.78, "g": -0.1, "rho_c": 0.183},
}


def tiny(kind):
    """The tiny scene of ``__graft_entry__`` with air's depolarization and
    the ``kind`` floor, polarized; numpy arrays and plain values only go
    into the port."""
    scene, sensor, config = __graft_entry__._tiny_scene(S=S)
    med = dataclasses.replace(
        scene.medium, phase_params=({"depol": jnp.full((S, 8), 0.0279)},)
    )
    surface = SurfaceArrays(params={k: jnp.full(S, v, jnp.float32)
                                    for k, v in SURFACES[kind].items()})
    scene = dataclasses.replace(scene, medium=med, surface=surface)
    return scene, sensor, dataclasses.replace(config, polarized=True, surface_kind=kind)


def _port(scene, sensor, config, spp, **kw):
    s, se, c = from_reference(scene, sensor, config, "cpu")
    return render_polarized(s, se, c, spp, seed=SEED, device="cpu", **kw)


def gate(stokes, ref_stokes):
    """I within 1e-5 relative per pixel, Q, U and V within 1e-5 of I."""
    stokes, ref_stokes = np.asarray(stokes), np.asarray(ref_stokes)
    assert stokes.shape == ref_stokes.shape and stokes.shape[-1] == 4
    assert np.isfinite(stokes).all()
    I = ref_stokes[..., 0]
    assert (I > 0).all()
    np.testing.assert_allclose(stokes[..., 0], I, rtol=RTOL, atol=0)
    assert (np.abs(stokes[..., 1:] - ref_stokes[..., 1:]) <= RTOL * I[..., None]).all()


@pytest.mark.parametrize("kind", list(SURFACES))
def test_render_polarized_matches_reference(kind):
    scene, sensor, config = tiny(kind)
    ref = ref_render_polarized(scene, sensor, config, 256, seed=SEED)
    cf_launches = cf.launches
    out = _port(scene, sensor, config, 256)
    assert out["spp"] == ref["spp"] == 256
    gate(out["stokes"], ref["stokes"])
    np.testing.assert_allclose(out["m2"].numpy(), np.asarray(ref["m2"]), rtol=RTOL, atol=0)
    torch.testing.assert_close(out["radiance"], out["stokes"][..., 0], rtol=0, atol=0)
    # the scene polarizes: Q and U are not noise around 0
    assert np.abs(out["stokes"][..., 1].numpy()).max() > 1e-3 * out["radiance"].max().item()
    assert cf.launches == cf_launches  # CPU tensors run the twin, never the kernel


def test_estimate_does_not_depend_on_lane_count():
    scene, sensor, config = tiny("maignan")
    a = _port(scene, sensor, config, 512, lanes_target=32)
    b = _port(scene, sensor, config, 512, lanes_target=4096)
    for k in ("stokes", "m2"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=RTOL, atol=1e-9)


def test_host_check_interval_is_bitwise_neutral():
    scene, sensor, config = tiny("lambertian")
    a = _port(scene, sensor, config, 64, check_every=1)
    b = _port(scene, sensor, config, 64, check_every=5)
    assert b["iterations"] >= a["iterations"]
    assert torch.equal(a["stokes"], b["stokes"]) and torch.equal(a["m2"], b["m2"])


def test_each_iteration_runs_one_collision_fetch(monkeypatch):
    calls = []
    saved = tracer_polarized.collision_fetch

    def counted(*args):
        calls.append(args[0].shape[0])
        return saved(*args)

    monkeypatch.setattr(tracer_polarized, "collision_fetch", counted)
    out = _port(*tiny("lambertian"), 64)
    assert len(calls) == out["iterations"] > 0


def c1_kwargs(n_vza=11, surface=None):
    """BASELINE config 1 (``bench.py`` ``_c1``) at ``n_vza`` view zeniths
    with Stokes output."""
    return dict(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.linspace(-75, 75, n_vza), "azimuth": 0.0, "id": "m"},
        surface=surface or {"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        integrator={"type": "volpath", "stokes": True},
    )


@pytest.fixture
def mono_polarized_single():
    eradiate_tpu.set_mode("mono_polarized_single")
    eradiate_tpu_torch.set_mode("mono_polarized_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("surface", [None, {"type": "maignan"}])
def test_run_matches_reference(mono_polarized_single, surface):
    ref = eradiate_tpu.run(RefExperiment(**c1_kwargs(surface=surface)), spp=64,
                           seed_state=eradiate_tpu.SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(AtmosphereExperiment(**c1_kwargs(surface=surface)), spp=64,
                                 seed_state=eradiate_tpu_torch.SeedState(7), device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    assert {"I", "Q", "U", "V", "dolp"} <= set(out.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    gate(np.stack([np.asarray(out[c]) for c in "IQUV"], -1),
         np.stack([np.asarray(ref[c]) for c in "IQUV"], -1))
    for k in ("radiance", "brf"):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=RTOL, atol=0)
    np.testing.assert_allclose(np.asarray(out["dolp"]), np.asarray(ref["dolp"]), rtol=0,
                               atol=4 * RTOL)
    dolp = np.asarray(out["dolp"])
    assert ((dolp >= 0.0) & (dolp <= 1.0)).all() and dolp.max() > 0.05


def test_scalar_tracer_refuses_polarized_config():
    scene, sensor, config = tiny("lambertian")
    with pytest.raises(NotImplementedError, match="render_polarized"):
        render(scene, sensor, config, 8, device="cpu")
    with pytest.raises(ValueError, match="polarized is False"):
        render_polarized(scene, sensor, dataclasses.replace(config, polarized=False), 8,
                         device="cpu")


@pytest.mark.parametrize(
    "field, value, error, name",
    [("geometry", "spherical_shell", NotImplementedError, "spherical_shell"),
     ("surface_kind", "no_such_kind", ValueError, "'no_such_kind'")],
)
def test_unported_features_raise(field, value, error, name):
    """Unported features raise ``NotImplementedError`` naming them; an
    unknown surface kind raises ``ValueError`` naming it."""
    scene, sensor, config = tiny("lambertian")
    with pytest.raises(error, match=name):
        render_polarized(scene, sensor, dataclasses.replace(config, **{field: value}), 8,
                         device="cpu")


def test_polarized_spherical_run_renders(mono_polarized_single):
    """``run()`` takes a polarized spherical-shell scene to
    ``render_spherical_polarized``: Stokes vectors in the polarized
    layout."""
    exp = AtmosphereExperiment(**{**c1_kwargs(), "geometry": "spherical_shell",
                                  "measures": {"type": "mdistant", "construct": "hplane",
                                               "zeniths": [0.0, 30.0],
                                               "target": [0.0, 0.0, 6378.1]}})
    ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
    stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
    assert stokes.shape == (1, 2, 4) and np.isfinite(stokes).all() and (stokes[..., 0] > 0).all()
    assert exp.measures[0].results["raw"]["iterations"] > 0


@pytest.mark.parametrize("kind", ["maignan", "ocean_mishchenko"])
def test_polarized_surface_rows_cross_over(kind):
    """``from_reference`` carries every row of a polarized floor bit for bit
    and refuses a scene that lacks one."""
    scene, sensor, config = tiny(kind)
    out, _, _ = from_reference(scene, sensor, config, "cpu")
    assert set(out.surface.params) == set(SURFACES[kind])
    for k, v in scene.surface.params.items():
        np.testing.assert_array_equal(out.surface.params[k].numpy(), np.asarray(v))
    params = dict(scene.surface.params)
    params.pop("ext_ior")
    scene = dataclasses.replace(scene, surface=SurfaceArrays(params=params))
    with pytest.raises(ValueError, match="ext_ior"):
        from_reference(scene, sensor, config, "cpu")
