"""The port's tracer and its phase/BSDF pieces against the JAX package.

Same seed, same samples: per-pixel radiance and second moment agree with
``eradiate_tpu.ops.tracer.render`` within 1e-5 relative. The bound covers
float32 summation order and ulp-level differences between the two
libraries' ``log1p``/``exp``/``cbrt``; a larger difference is a fault.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import phase_ops as ref_phase
from eradiate_tpu.ops.tracer import render as ref_render
from eradiate_tpu_torch.ops import bsdf_ops, phase_ops
from eradiate_tpu_torch.ops.scene_state import SceneConfig, from_reference
from eradiate_tpu_torch.ops.tracer import lane_partition, render

torch.set_num_threads(1)

SEED = 3
RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    return __graft_entry__._tiny_scene()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port(scene, sensor, config, spp, **kw):
    s, se, c = from_reference(scene, sensor, config, "cpu")
    return render(s, se, c, spp, seed=SEED, device="cpu", **kw)


@pytest.mark.parametrize("spp", [64, 200])
def test_render_matches_reference(tiny, spp):
    scene, sensor, config = tiny
    ref = ref_render(scene, sensor, config, spp, seed=SEED)
    out = _port(scene, sensor, config, spp, lanes_target=2**14)
    assert out["spp"] == ref["spp"] == spp
    for k in ("radiance", "m2"):
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), rtol=RTOL, atol=0)


def test_render_with_target_extent_matches_reference(tiny):
    """Rectangle targets jitter every sample's origin (origin uniforms)."""
    scene, sensor, config = tiny
    sensor = dataclasses.replace(sensor, target_extent=jnp.asarray([3.0, 2.0]))
    ref = ref_render(scene, sensor, config, 64, seed=SEED)
    out = _port(scene, sensor, config, 64)
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), rtol=RTOL, atol=0)


def test_estimate_does_not_depend_on_lane_count(tiny):
    scene, sensor, config = tiny
    n_pix = sensor.directions.shape[0]
    spp = 1024
    lanes = [lane_partition(n_pix, spp, lt, "cpu")[0] for lt in (64, 4096)]
    assert lanes[0] != lanes[1]
    a = _port(scene, sensor, config, spp, lanes_target=64)
    b = _port(scene, sensor, config, spp, lanes_target=4096)
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(_np(a[k]), _np(b[k]), rtol=RTOL, atol=0)


def test_host_check_interval_is_bitwise_neutral(tiny):
    scene, sensor, config = tiny
    a = _port(scene, sensor, config, 64, check_every=1)
    b = _port(scene, sensor, config, 64, check_every=7)
    assert b["iterations"] >= a["iterations"]
    assert torch.equal(a["radiance"], b["radiance"])
    assert torch.equal(a["m2"], b["m2"])


@pytest.mark.parametrize("spp", [1, 7, 64, 1000])
def test_lane_partition_tiles_sample_ids(spp):
    n_pix = 5
    lp, pix, _, first, quota = lane_partition(n_pix, spp, 64, "cpu")
    ids = torch.cat([f + torch.arange(q) for f, q in zip(first, quota)])
    assert pix.shape[0] == n_pix * lp
    assert torch.equal(torch.sort(ids).values, torch.arange(n_pix * spp))


@pytest.mark.parametrize(
    "field, value, error, name",
    [
        ("polarized", True, NotImplementedError, "render_polarized"),
        ("geometry", "spherical_shell", NotImplementedError, "spherical_shell"),
        ("phase_kinds", ("tab_polarized",), NotImplementedError, "'tab_polarized'"),
        ("surface_kind", "no_such_kind", ValueError, "'no_such_kind'"),
        ("illumination_kind", "spot", NotImplementedError, "spot"),
    ],
)
def test_unported_features_raise(tiny, field, value, error, name):
    """Unported features raise ``NotImplementedError`` naming them; an
    unknown surface kind raises ``ValueError`` naming it."""
    scene, sensor, _ = tiny
    config = SceneConfig(max_depth=8, **{field: value})
    with pytest.raises(error, match=name):
        render(scene, sensor, config, 8, device="cpu")


# -- phase and BSDF pieces ---------------------------------------------------

N = 2048


def _unit(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _dirs(seed, n=N):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_cbrt_matches_jnp_cbrt():
    t = np.concatenate([2.0 * _unit(70, N) - 1.0, [0.0, -1.0, 1.0, 1e-30, -8.0]])
    t = t.astype(np.float32)
    np.testing.assert_allclose(
        phase_ops._cbrt(torch.as_tensor(t)).numpy(), np.asarray(jnp.cbrt(t)),
        rtol=1e-6, atol=0,
    )


def test_rayleigh_eval_and_sample():
    depol = np.float32(0.0283)
    cos = (2.0 * _unit(71, N) - 1.0).astype(np.float32)
    u = _unit(72, (N, 2))
    np.testing.assert_allclose(
        phase_ops.rayleigh_eval(torch.full((N,), depol), torch.as_tensor(cos)).numpy(),
        np.asarray(ref_phase.rayleigh_eval(jnp.float32(depol), jnp.asarray(cos))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        phase_ops.rayleigh_sample_cos(torch.full((N,), depol), torch.as_tensor(u)).numpy(),
        np.asarray(ref_phase.rayleigh_sample_cos(jnp.float32(depol), jnp.asarray(u))),
        rtol=1e-6, atol=1e-7,
    )


def test_direction_from_cos_u():
    d = _dirs(73)
    d[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]
    cos = (2.0 * _unit(74, N) - 1.0).astype(np.float32)
    u = _unit(75, N)
    ref = ref_phase.direction_from_cos_u(jnp.asarray(d), jnp.asarray(cos), jnp.asarray(u))
    out = phase_ops.direction_from_cos_u(
        torch.as_tensor(d), torch.as_tensor(cos), torch.as_tensor(u)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["lambertian", "black"])
def test_bsdf_eval_and_sample(kind):
    params = {"reflectance": np.float32(0.37)}
    wi, wo = _dirs(76), _dirs(77)
    u = _unit(78, (N, 2))
    ref_f = ref_bsdf.bsdf_eval(kind, {k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(wi), jnp.asarray(wo))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    f = bsdf_ops.bsdf_eval(kind, tparams, torch.as_tensor(wi), torch.as_tensor(wo))
    np.testing.assert_array_equal(f.numpy(), np.asarray(ref_f))
    ref_w, ref_wt = ref_bsdf.bsdf_sample_from_uniforms(
        kind, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(wo),
        jnp.asarray(u),
    )
    w, wt = bsdf_ops.bsdf_sample_from_uniforms(kind, tparams, torch.as_tensor(wo),
                                               torch.as_tensor(u))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(ref_wt))
