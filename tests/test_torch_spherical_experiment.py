"""The port's spherical-shell path (BASELINE config 4) against the JAX package.

c4 (``bench.py`` ``_c4``): a Rayleigh AFGL column in spherical shells over a
Hapke surface, sun at SZA 75 (the sun-tau table NEE, shell-flight kernel)
or SZA 85 (the exact NEE, shell-event kernel), 15 view zeniths.

- ``compile_scene``: every leaf bitwise the reference's, except the sun-tau
  table, within 2e-6 relative (the reference contracts the shells in
  float32, the port in float64).
- ``run`` at 256 spp and one seed against ``eradiate_tpu.run``: every pixel
  within |z| <= 5 of the two runs' variances and within 2e-3 relative, at
  least 12 of the 15 pixels within 1e-4, and the median pixel within 1e-5
  (SZA 85) or 1e-4 (SZA 75). The port follows the reference's sample
  stream bit for bit, but a scattered direction can differ from the
  reference's in its last few ulps (torch's and XLA's libm, and the fused
  multiply-adds XLA forms in the frame rotations), and along near-tangent
  rays the event point is ill-conditioned in the direction: the ulps grow
  until a collide decision flips and the rest of that path differs. At one
  seed 4 of 480 lanes (8 samples each) differ by more than 1e-4, and the
  same 4 lanes differ the same way when the reference's own
  ``shell_flight`` and ``shell_event`` run inside the port, so the kernels'
  twins do not cause them. This seed moves three grazing views by up to
  7.6e-4. At SZA 75 the reference also rounds the table fetch's radius
  weights to bf16, which moves the other pixels by up to ~5e-5.
- The estimate does not depend on the lane count.
- ``render_spherical`` with ``config.lr_flight`` (the primal of the
  likelihood-ratio flight: shell flight, then the exact slant depth at the
  event point) against the reference's render with the same config, within
  the same gate; and against the port's own exact-NEE render of the scene
  without its sun-tau table, bit for bit (the event twin fuses the same two
  steps).
- c4, scalar and polarized, runs with ``jax`` and ``eradiate_tpu`` blocked.
- At SZA 60 and view zeniths of +-60 (the target at the sub-sensor surface
  point) the lanes follow the reference's but for at most 2 of 160, in the
  scalar and the polarized tracer (``lane_gate``): the edge pixels were 8-10%
  low until the rays' start at the top of the atmosphere was rounded as the
  jitted reference rounds it.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.ops import tracer_spherical as ref_ts
from eradiate_tpu.ops import tracer_spherical_polarized as ref_tsp
from eradiate_tpu.ops.scene_state import IlluminationArrays as RefIllumination
from eradiate_tpu.ops.tracer import lane_partition as ref_lane_partition
from eradiate_tpu.ops.tracer_spherical import render_spherical as ref_render_spherical
from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.ops import tracer_spherical as ts
from eradiate_tpu_torch.ops import tracer_spherical_polarized as tsp
from eradiate_tpu_torch.ops.scene_state import from_reference
from eradiate_tpu_torch.ops.tracer import lane_partition, row_key
from eradiate_tpu_torch.ops.tracer_spherical import render_spherical

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SPP = 256


def c4_kwargs(sza=75.0):
    """BASELINE config 4 (``bench.py`` ``_c4``) with the sun at ``sza``."""
    return dict(
        geometry="spherical_shell",
        illumination={"type": "directional", "zenith": sza, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0),
            "azimuth": 0.0,
            "target": [0.0, 0.0, EARTH_RADIUS_KM],
            "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
    )


@pytest.fixture
def mono_single():
    # each package has its own mode registry
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


def _compile_kwargs(exp_cls, kwargs, ctx=None):
    """``exp_cls(**kwargs)``'s first measure compiled in ``ctx`` (default its
    own spectral context): ``((scene, sensor, config), ctx)``."""
    exp = exp_cls(**kwargs)
    m = exp.measures[0]
    ctx = exp.spectral_context(m) if ctx is None else ctx
    return exp.compile_scene(m, ctx), ctx


def _compile(exp_cls, sza, ctx=None):
    return _compile_kwargs(exp_cls, c4_kwargs(sza), ctx)


@pytest.mark.parametrize("sza", [75.0, 85.0])
def test_compile_scene_matches(mono_single, sza):
    out, ctx = _compile(AtmosphereExperiment, sza)
    ref, _ = _compile(RefExperiment, sza, ctx)
    ref, out = _leaves(ref), _leaves(out)
    assert out.keys() == ref.keys()
    table = "[0].medium.sun_tau"
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            if k == table:
                np.testing.assert_allclose(out[k], v, rtol=2e-6, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k
    # the default 1e-3 shell merge folds the 1200-layer column to 232 shells;
    # the table is on up to SZA 80
    assert ref["[0].medium.radii"].shape == (233,)
    assert (ref[table] is None) == (sza > 80.0)
    if sza <= 80.0:
        assert ref[table].shape == (1, 128, 128)


@pytest.mark.parametrize("sza, median_bound", [(75.0, 1e-4), (85.0, 1e-5)])
def test_run_matches_reference(mono_single, sza, median_bound):
    ref = eradiate_tpu.run(
        RefExperiment(**c4_kwargs(sza)), spp=SPP, seed_state=SeedState(7), mesh=None
    )
    out = eradiate_tpu_torch.run(
        AtmosphereExperiment(**c4_kwargs(sza)), spp=SPP,
        seed_state=eradiate_tpu_torch.SeedState(7), device="cpu",
    )
    assert set(out.data_vars) == set(ref.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    brf, brf_ref = np.asarray(out["brf"]), np.asarray(ref["brf"])
    assert brf.shape == brf_ref.shape == (1, 15)
    assert np.isfinite(brf).all()
    rad, rad_ref = np.asarray(out["radiance"]), np.asarray(ref["radiance"])
    z = np.abs(rad - rad_ref) / np.sqrt(np.asarray(out["var"]) + np.asarray(ref["var"]))
    rel = np.abs(brf - brf_ref) / np.abs(brf_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert (rel <= 1e-4).sum() >= 12
    assert np.median(rel) <= median_bound


@pytest.mark.parametrize("sza", [75.0, 85.0])
def test_estimate_independent_of_lane_count(mono_single, sza):
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, sza)
    out = [
        render_spherical(scene, sensor, config, spp=64, seed=3, device="cpu", lanes_target=lt)[
            "radiance"
        ].numpy()
        for lt in (15 * 8, 15 * 3)  # 8 and 3 lanes per pixel
    ]
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=0)


def test_lr_flight_matches_reference(mono_single):
    """The c4 gate. Over seeds 1 to 8 the pixels beyond 1e-4 are the ones
    that also leave the reference's path on the table branch (the flight
    flips them, not the slant depth): 2 to 6 of 15, at most 3.4e-3."""
    (scene, sensor, config), ctx = _compile(AtmosphereExperiment, 75.0)
    (ref_scene, ref_sensor, ref_config), _ = _compile(RefExperiment, 75.0, ctx)
    assert not config.lr_flight
    out = render_spherical(
        scene, sensor, dataclasses.replace(config, lr_flight=True), spp=SPP, seed=3,
        device="cpu",
    )
    ref = ref_render_spherical(
        ref_scene.medium, ref_scene.surface, ref_scene.illumination, ref_sensor,
        dataclasses.replace(ref_config, lr_flight=True), spp=SPP, seed=3,
    )
    rad, rad_ref = out["radiance"].numpy(), np.asarray(ref["radiance"])
    assert rad.shape == rad_ref.shape == (1, 15)
    assert np.isfinite(rad).all() and (rad > 0).all()
    var = (out["m2"].numpy() - rad**2 + np.asarray(ref["m2"]) - rad_ref**2) / SPP
    z = np.abs(rad - rad_ref) / np.sqrt(var)
    rel = np.abs(rad - rad_ref) / np.abs(rad_ref)
    assert z.max() <= 5.0
    assert rel.max() <= 2e-3
    assert (rel <= 1e-4).sum() >= 12
    assert np.median(rel) <= 1e-5


def test_lr_flight_equals_the_exact_nee_bitwise(mono_single):
    """Flight plus slant depth is what the event twin fuses: with the table
    off the default config runs the event twin, and the two renders are
    equal bit for bit, iteration counts included."""
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, 75.0)
    lr = render_spherical(
        scene, sensor, dataclasses.replace(config, lr_flight=True), spp=64, seed=3,
        device="cpu",
    )
    medium = dataclasses.replace(
        scene.medium, sun_tau=None, mu_grid=None, sun_r_grid=None, sun_mu_warp=None
    )
    exact = render_spherical(
        dataclasses.replace(scene, medium=medium), sensor, config, spp=64, seed=3, device="cpu"
    )
    assert lr["iterations"] == exact["iterations"]
    for k in ("radiance", "m2"):
        assert torch.equal(lr[k], exact[k])
    # and the table branch is another estimate of the same radiance
    table = render_spherical(scene, sensor, config, spp=64, seed=3, device="cpu")
    assert not torch.equal(table["radiance"], lr["radiance"])
    np.testing.assert_allclose(table["radiance"].numpy(), lr["radiance"].numpy(), rtol=5e-2)


def _row0(x):
    x = jnp.asarray(x)
    return x[0] if x.ndim else x


def _ref_lanes(scene, sensor, config, spp, seed, chunk_id=0):
    """Per-lane sums of the reference's regenerative shell trace (its
    ``_render_row_spherical`` or the polarized ``_render_row``, jitted, row 0
    of chunk ``chunk_id``): ``(sums [B] or [B, 4], m2 [B])``."""
    med, il = scene.medium, scene.illumination
    directions, target = jnp.asarray(sensor.directions), jnp.asarray(sensor.target)
    n_pix = directions.shape[0]
    trace = (ref_tsp.trace_paths_spherical_polarized_regen if config.polarized
             else ref_ts.trace_paths_spherical_regen)

    def lanes(med, surface, il, key):
        medium_row = ref_ts.SphericalMediumArrays(
            radii=med.radii, sigma_t=med.sigma_t[0], sigma_majorant=med.sigma_majorant[0],
            albedo=med.albedo[0], phase_weights=med.phase_weights[0],
            phase_params=jax.tree_util.tree_map(lambda x: x[0], med.phase_params),
            sun_tau=None if med.sun_tau is None else med.sun_tau[0], mu_grid=med.mu_grid,
            sun_r_grid=med.sun_r_grid, sun_mu_warp=med.sun_mu_warp)
        surface_row = jax.tree_util.tree_map(lambda x: x[0], surface)
        illum_row = RefIllumination(direction=il.direction, irradiance=il.irradiance[0],
                                    cos_cutoff=il.cos_cutoff, sky_radiance=_row0(il.sky_radiance))
        _, pix, _, lane_first, quota = ref_lane_partition(
            n_pix, spp, lanes_target=ref_ts.spherical_lanes_target(n_pix, spp))
        w_v = directions[pix]
        _, t_far, _ = ref_ts.ray_sphere_intersect(jnp.broadcast_to(target, w_v.shape), w_v,
                                                  medium_row.radii[-1])
        init_p = target[None, :] + w_v * t_far[:, None]
        return trace(config, medium_row, surface_row, illum_row, init_p, -w_v, key, lane_first,
                     quota, 512)

    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 0), chunk_id)
    return [np.asarray(x) for x in jax.jit(lanes)(med, scene.surface, il, key)]


def _port_lanes(scene, sensor, config, spp, seed, chunk_id=0):
    """The port's per-lane sums as :func:`_ref_lanes`, and the lanes a
    pixel."""
    scene, sensor, config = from_reference(scene, sensor, config, "cpu")
    n_pix = sensor.directions.shape[0]
    medium_row, surface_row, illum_row = ts.spherical_row(scene, 0)
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, ts.spherical_lanes_target(n_pix, spp), "cpu")
    init_p, init_d = ts.toa_rays(sensor.directions[pix], sensor.target, medium_row.radii[-1])
    trace = (tsp.trace_paths_spherical_polarized_regen if config.polarized
             else ts.trace_paths_spherical_regen)
    out = trace(config, medium_row, surface_row, illum_row, init_p, init_d,
                row_key(seed, 0, chunk_id, "cpu"), lane_first, quota)
    return [o.numpy() for o in out[:2]], lp


def lane_gate(out_scene, ref_scene, spp, seed, max_flips, chunk_id=0):
    """The lanes (each rendering ``spp / lanes_per_pixel`` samples of row 0)
    whose sum of I differs from the reference's by more than 1e-3 relative
    have taken another branch (a collide decision or a surface re-hit
    flipped; such a flip moves a sample by 1e-2 to 1e-1, last-ulp
    differences and the reference's bf16 table weights by 1e-7 to 1e-4): at
    most ``max_flips`` of them, and the pixels' sums over every other lane
    within 5e-5 of the reference's. Then the
    pixels' estimates within |z| <= 5 (I's variances; Q, U, V too where
    polarized). Returns the flips a pixel."""
    (sums, m2), lp = _port_lanes(*out_scene, spp, seed, chunk_id)
    ref_sums, ref_m2 = _ref_lanes(*ref_scene, spp, seed, chunk_id)
    n_pix = sums.shape[0] // lp
    I, ref_I = (sums[:, 0], ref_sums[:, 0]) if sums.ndim == 2 else (sums, ref_sums)
    flip = np.abs(I - ref_I) > 1e-3 * np.abs(ref_I)
    assert flip.sum() <= max_flips, flip.reshape(n_pix, lp).sum(1)
    kept, ref_kept = (np.where(flip, 0.0, x).reshape(n_pix, lp).sum(1) for x in (I, ref_I))
    np.testing.assert_allclose(kept, ref_kept, rtol=5e-5, atol=0)

    def pixels(x):
        return x.reshape(n_pix, lp, -1).sum(1) / spp

    st, ref_st, sq, ref_sq = pixels(sums), pixels(ref_sums), pixels(m2), pixels(ref_m2)
    var = (sq - st[:, :1] ** 2 + ref_sq - ref_st[:, :1] ** 2) / spp
    assert np.isfinite(st).all() and (np.abs(st - ref_st) / np.sqrt(var) <= 5.0).all()
    return flip.reshape(n_pix, lp).sum(1)


def sza60_kwargs(polarized):
    """Rayleigh over Lambertian in spherical shells, sun at SZA 60, view
    zeniths -60 to 60, the target at the sub-sensor surface point."""
    return dict(
        geometry="spherical_shell",
        integrator={"type": "volpath", "stokes": True} if polarized else None,
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": [-60.0, -30.0, 0.0, 30.0, 60.0], "azimuth": 0.0,
                  "target": [0.0, 0.0, EARTH_RADIUS_KM], "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
    )


@pytest.mark.parametrize("mode_id", ["mono_single", "mono_polarized_single"])
def test_sza60_edge_pixels_match_reference(mode_id):
    """SZA 60, view zeniths +-60: the port once lost 60-75% of the edge
    pixels' lanes after their first surface bounce (those pixels 8-10%
    low, |z| 2-3 at 256 spp on every seed). It rounded ``|p|^2 - r^2`` of
    the rays' start at the top of the atmosphere twice, where the jitted
    reference fuses it; the start then differed in the last ulps, the
    ground hit rounded one ulp inside the ground, and the surface offset
    (1e-4 km, below half an ulp at 6378 km) could not lift the next flight
    out of it. Now at most 2 of the 160 lanes (32 a pixel, 8 samples each)
    take another branch, as elsewhere in c4, and the rest agree within
    5e-5; with the start rounded as before, this test fails."""
    eradiate_tpu.set_mode(mode_id)
    eradiate_tpu_torch.set_mode(mode_id)
    try:
        out, ctx = _compile_kwargs(AtmosphereExperiment, sza60_kwargs(mode_id != "mono_single"))
        ref, _ = _compile_kwargs(RefExperiment, sza60_kwargs(mode_id != "mono_single"), ctx)
        flips = lane_gate(out, ref, SPP, seed=7, max_flips=2)
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    assert flips.shape == (5,)


def _unported(kind, scene, config):
    if kind == "lr_flight":
        # lr_flight renders; a polarized config belongs to the polarized tracer
        return scene, dataclasses.replace(config, lr_flight=True, polarized=True)
    if kind == "polarized":
        return scene, dataclasses.replace(config, polarized=True)
    medium = dataclasses.replace(scene.medium, sun_r_grid=None)
    return dataclasses.replace(scene, medium=medium), config


@pytest.mark.parametrize(
    "kind, name",
    [("lr_flight", "lr_flight"), ("polarized", "polarized"), ("legacy", "sun_tau_fetch")],
)
def test_unported_features_raise(mono_single, kind, name):
    (scene, sensor, config), _ = _compile(AtmosphereExperiment, 75.0)
    scene, config = _unported(kind, scene, config)
    with pytest.raises(NotImplementedError, match="polarized" if kind == "lr_flight" else name):
        render_spherical(scene, sensor, config, spp=8, device="cpu")


def test_runs_with_jax_blocked():
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["eradiate_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import eradiate_tpu_torch as etp
        etp.set_mode("mono_single")
        for sza in (75.0, 85.0):
            exp = etp.AtmosphereExperiment(
                geometry="spherical_shell",
                illumination={{"type": "directional", "zenith": sza}},
                measures={{"type": "mdistant", "construct": "hplane",
                          "zeniths": np.arange(-85.0, 65.0, 10.0), "azimuth": 0.0,
                          "target": [0.0, 0.0, {EARTH_RADIUS_KM!r}]}},
                surface={{"type": "hapke"}},
                atmosphere={{"type": "molecular"}},
            )
            ds = etp.run(exp, spp=64, seed_state=etp.SeedState(7), device="cpu")
            brf = np.asarray(ds["brf"])
            assert brf.shape == (1, 15) and np.isfinite(brf).all(), brf
        # polarized c4 through render_spherical_polarized
        etp.set_mode("mono_polarized_single")
        exp = etp.AtmosphereExperiment(
            geometry="spherical_shell",
            integrator={{"type": "volpath", "stokes": True}},
            illumination={{"type": "directional", "zenith": 75.0}},
            measures={{"type": "mdistant", "construct": "hplane",
                      "zeniths": np.arange(-85.0, 65.0, 10.0), "azimuth": 0.0,
                      "target": [0.0, 0.0, {EARTH_RADIUS_KM!r}]}},
            surface={{"type": "hapke"}},
            atmosphere={{"type": "molecular"}},
        )
        ds = etp.run(exp, spp=32, seed_state=etp.SeedState(7), device="cpu")
        stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
        assert stokes.shape == (1, 15, 4) and np.isfinite(stokes).all(), stokes
        assert "eradiate_tpu_torch.ops.tracer_spherical_polarized" in sys.modules
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
