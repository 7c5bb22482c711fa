"""The port's surface kinds against the JAX package, function by function.

Every kind of the reference's ``_EVAL`` that the earlier slices left out
(``rtls``, ``bilambertian`` as a ground, the two oceans, with and without
the tables' ``n_water`` and ``r_water``, ``mqdiffuse``, ``bitmap``,
``checkerboard``), the scalar (I-I) components of ``maignan`` and
``ocean_mishchenko``, and the three composites, on seeded numpy inputs:
random directions in both hemispheres, grazing ones, exact specular pairs,
exact hot spots and near-specular pairs, and surface points of both signs
beyond the maps' extents. The jitted reference is the oracle.

- ``bsdf_eval`` with a position and with None, and
  ``bsdf_sample_from_uniforms`` with both.
- float32: the port's value is no farther from the exact one (the port's
  formula in float64, itself within 1e-12 of the reference's in float64)
  than twice the reference's float32 value is, or within 4 ulp of the
  array's largest value or 2e-6 relative. The two libraries' ``exp``,
  ``pow``, ``acos`` and ``atan2`` differ in the last ulp, and XLA:CPU
  contracts products into fused multiply-adds and turns ``a / sqrt(b)``
  into ``a * rsqrt(b)``; near the glint and the hot spot the float32
  cancellations amplify both packages' ulps alike. At the exact hot spot
  (``wi == wo`` bit for bit) ``rpv``'s and ``rtls``' float32 azimuth term
  takes the root of a cancelled difference, which XLA's contractions
  cancel to nothing and the port's roundings to ~1e-7: there within 5e-3
  of the reference. A render's sun and view directions meet there only by
  chance; ``tests/test_torch_surfaces_render.py`` holds the hot-spot view
  of c1 within 1e-5.
- float64 under x64: within 1e-12 relative (and 1e-15 of the largest value,
  for the glint's underflow, which XLA:CPU flushes to zero).
- A float32 sampled direction in float64 path state (the double modes):
  within 1e-12 relative for every kind but ``mqdiffuse`` and
  ``ocean_mishchenko``, whose float32 pieces (``acos`` and ``atan2`` of the
  direction; XLA's float32 ``rsqrt``) differ from torch's in the last ulp:
  within 2e-6 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import bsdf_polarized as ref_bpol
from eradiate_tpu_torch.ops import bsdf_ops, bsdf_polarized

torch.set_num_threads(1)

N = 4096
EPS32 = float(np.finfo(np.float32).eps)

_rng = np.random.default_rng(19)
RTLS = {"f_iso": 0.209, "f_vol": 0.081, "f_geo": 0.004}
PARAMS = {
    "rtls": RTLS,
    "bilambertian": {"reflectance": 0.4, "transmittance": 0.1},
    "ocean_legacy": {"wind_speed": 0.01, "wind_azimuth": 0.0, "chlorinity": 19.0,
                     "pigmentation": 0.3, "wavelength": 550.0, "n_water": 1.3383,
                     "r_water": 0.0052},
    "ocean_legacy, fallbacks": {"wind_speed": 5.0, "wind_azimuth": 0.0, "chlorinity": 19.0,
                                "pigmentation": 0.3, "wavelength": 440.0},
    "ocean_grasp": {"wind_speed": 2.0, "eta": 1.34, "water_body_reflectance": 0.02},
    "mqdiffuse": {"data": _rng.uniform(0.05, 0.5, (6, 9, 5))},
    "bitmap": {"data": _rng.uniform(0.0, 1.0, (5, 7)), "extent": 20.0},
    "checkerboard": {"reflectance_a": 0.2, "reflectance_b": 0.8, "scale_pattern": 2.0,
                     "extent": 13.0},
    "maignan": {"rho_0": 0.183, "k": 0.78, "g": -0.1, "rho_c": 0.183, "C": 5.0, "ndvi": 0.8,
                "refr_re": 1.5, "refr_im": 0.0, "ext_ior": 1.000277},
    "ocean_mishchenko": {"wind_speed": 2.0, "eta": 1.33, "k": 0.0, "ext_ior": 1.000277,
                         "shadowing": 1.0},
    "central_patch:rtls:lambertian": {**{f"bg_{k}": v for k, v in RTLS.items()},
                                      "patch_reflectance": 0.7, "patch_edges": 10.0},
    "opacity_mask:rpv": {"nested_rho_0": 0.2, "nested_k": 0.8, "nested_g": -0.1,
                         "nested_rho_c": 0.2, "opacity_map": _rng.uniform(0, 1, (4, 4)),
                         "mask_extent": 50.0},
    "select:lambertian:rtls:black": {"c0_reflectance": 0.1,
                                     **{f"c1_{k}": v for k, v in RTLS.items()},
                                     "index_map": _rng.integers(0, 3, (3, 4)).astype(float),
                                     "select_extent": 20.0},
}
#: their float32 pieces on a float32 sampled direction are not XLA's bit
#: for bit (see the module's docstring)
LOOSE_MIXED = {"mqdiffuse": 2e-6, "ocean_mishchenko": 2e-6}


def kind_of(name):
    return name.split(",")[0]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def inputs(seed=3):
    """``(wi, wo, p)`` float64: random pairs in both hemispheres, grazing
    ones, exact and near specular pairs, exact hot spots, zenith and nadir;
    points of both signs out to 8 times the maps' extents."""
    rng = np.random.default_rng(seed)
    wi, wo = _unit(rng.normal(size=(N, 3))), _unit(rng.normal(size=(N, 3)))
    q = N // 8
    wo[q:5 * q, 2] = np.abs(wo[q:5 * q, 2])
    wi[q:2 * q] = wo[q:2 * q] * [-1.0, -1.0, 1.0]  # specular
    wi[2 * q:3 * q] = _unit(wo[2 * q:3 * q] * [-1.0, -1.0, 1.0]
                            + rng.normal(scale=1e-3, size=(q, 3)))
    wi[2 * q:3 * q, 2] = np.abs(wi[2 * q:3 * q, 2])
    wi[3 * q:4 * q] = wo[3 * q:4 * q]  # hot spot
    wi[4 * q:5 * q, 2] = rng.uniform(1e-7, 1e-2, q) * np.sign(rng.normal(size=q))  # grazing
    wi[4 * q:5 * q] = _unit(wi[4 * q:5 * q])
    wi[:4] = [[0, 0, 1], [0, 0, -1], [0, 0, 1], [1, 0, 0]]
    wo[:4] = [[0, 0, 1], [0, 0, 1], [0, 0, -1], [0, 0, 1]]
    p = rng.uniform(-80.0, 80.0, (N, 2))
    p[:q] *= 1e-2
    return wi, wo, p


@pytest.fixture
def x64():
    """Switch the JAX package's x64 on around a test, and back off."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _ref(kind, params, wi, wo, p, u):
    """The jitted reference's eval with and without a position, and its
    sample from the same uniforms with and without."""
    def fn(params, wi, wo, p, u):
        out = [ref_bsdf.bsdf_eval(kind, params, wi, wo, p), ref_bsdf.bsdf_eval(kind, params, wi, wo)]
        for q in (p, None):
            out += list(ref_bsdf.bsdf_sample_from_uniforms(kind, params, wo, u, q))
        return out

    rp = {k: jnp.asarray(v) for k, v in params.items()}
    return [np.asarray(x) for x in jax.jit(fn)(rp, wi, wo, p, u)]


def _port(kind, params, wi, wo, p, u):
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    wi, wo, p, u = (torch.as_tensor(x) for x in (wi, wo, p, u))
    out = [bsdf_ops.bsdf_eval(kind, tp, wi, wo, p), bsdf_ops.bsdf_eval(kind, tp, wi, wo)]
    for q in (p, None):
        out += list(bsdf_ops.bsdf_sample_from_uniforms(kind, tp, wo, u, q))
    return [x.numpy() for x in out]


def _cast(params, dtype):
    return {k: np.asarray(v, dtype) for k, v in params.items()}


HOT_SPOT = slice(3 * (N // 8), 4 * (N // 8))  # the lanes of inputs() with wi == wo


def close64(out, ref, rtol=1e-12, hot_spot=False):
    """Within ``rtol`` relative (and 1e-15 of the largest value); with
    ``hot_spot`` the exact hot-spot lanes of :func:`inputs` within 1e-5:
    there ``rtls`` and ``rpv`` take the root of a difference that cancels to
    nothing (``D2``, ``G``), which turns the last ulp of each package's
    rounding into ~1e-8 times the tangents."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    if hot_spot:
        np.testing.assert_allclose(out[HOT_SPOT], ref[HOT_SPOT], rtol=1e-5, atol=1e-15 * scale)
        out, ref = np.delete(out, HOT_SPOT, 0), np.delete(ref, HOT_SPOT, 0)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-15 * scale)


@pytest.mark.parametrize("name", PARAMS)
def test_matches_reference_in_float32(name):
    """``bsdf_eval`` by the float32 gate of the module's docstring; the
    sampled directions within 4 ulp of the reference's (torch's and XLA's
    square roots and azimuth rounding differ in the last ulp in float32), and
    the sample's weight pi times the port's ``bsdf_eval`` there, as the
    reference's is."""
    kind = kind_of(name)
    wi, wo, p = inputs()
    u = np.random.default_rng(4).uniform(0.0, 1.0, (N, 2))
    params32 = _cast(PARAMS[name], np.float32)
    args32 = (params32, *(x.astype(np.float32) for x in (wi, wo, p, u)))
    ref32, out32 = _ref(kind, *args32), _port(kind, *args32)
    with jax.enable_x64(True):
        ref64 = _ref(kind, _cast(PARAMS[name], np.float64), wi, wo, p, u)
    out64 = _port(kind, _cast(PARAMS[name], np.float64), wi, wo, p, u)
    for i in (0, 1):  # the values with and without a position
        o32, r32, o64 = out32[i], ref32[i], out64[i]
        assert o32.dtype == r32.dtype == np.float32, i
        close64(o64, ref64[i], hot_spot=True)
        np.testing.assert_allclose(o32[HOT_SPOT], r32[HOT_SPOT], rtol=5e-3,
                                   atol=4 * EPS32 * float(np.max(np.abs(r32))))
        o32, r32, o64 = (np.delete(x, HOT_SPOT, 0) for x in (o32, r32, o64))
        scale = float(np.max(np.abs(o64)))
        err_port, err_ref = np.abs(o32 - o64), np.abs(r32 - o64)
        floor = np.maximum(4 * EPS32 * scale, 2e-6 * np.abs(o64))
        bad = err_port > np.maximum(2.0 * err_ref, floor)
        assert not bad.any(), (i, bad.sum(), o32[bad][:4], r32[bad][:4], o64[bad][:4])
    tp = {k: torch.as_tensor(v) for k, v in params32.items()}
    wo32, p32 = torch.as_tensor(wo.astype(np.float32)), torch.as_tensor(p.astype(np.float32))
    for i, q in ((2, p32), (4, None)):
        assert out32[i].dtype == ref32[i].dtype == np.float32
        # z = sqrt(1 - x^2 - y^2) cancels near the horizon: 4 ulp of 1 / z
        tol = 4 * EPS32 * np.array([1.0, 1.0, 0.0]) + 4 * EPS32 / np.array([np.inf, np.inf, 1.0]) \
            / np.maximum(ref32[i][:, 2:], 1e-30)
        assert (np.abs(out32[i] - ref32[i]) <= tol).all()
        f = bsdf_ops.bsdf_eval(kind, tp, torch.as_tensor(out32[i]), wo32, q).numpy()
        np.testing.assert_array_equal(out32[i + 1], f * np.float32(np.pi))


@pytest.mark.parametrize("name", PARAMS)
def test_matches_reference_under_x64(name, x64):
    """float64 within 1e-12 (the hot spot as :func:`close64` says); then a
    float32 sampled direction in float64 path state, as the double modes
    sample the surface: the direction bit for bit, the weight within 1e-12
    (``mqdiffuse`` and ``ocean_mishchenko``: 2e-6)."""
    kind = kind_of(name)
    wi, wo, p = inputs(5)
    u = np.random.default_rng(6).uniform(0.0, 1.0, (N, 2))
    args = (_cast(PARAMS[name], np.float64), wi, wo, p, u)
    ref, out = _ref(kind, *args), _port(kind, *args)
    for i, (o, r) in enumerate(zip(out, ref)):
        close64(o, r, hot_spot=i < 2)
    args = (_cast(PARAMS[name], np.float64), wi, np.abs(wo), p, u.astype(np.float32))
    ref, out = _ref(kind, *args), _port(kind, *args)
    for i in (2, 4):
        assert out[i].dtype == ref[i].dtype == np.float32
        np.testing.assert_array_equal(out[i], ref[i])
    for i in (3, 5):
        close64(out[i], ref[i], rtol=LOOSE_MIXED.get(kind, 1e-12))


def test_position_none_semantics():
    """With no position (the spherical tracers): ``bitmap`` takes its map's
    mean, ``checkerboard`` its ``reflectance_a``, ``central_patch`` its
    background, ``opacity_mask`` its nested BSDF and ``select`` its child 0;
    with one, each looks the point up."""
    wi, wo = torch.tensor([[0.3, 0.0, 0.9539392]]), torch.tensor([[0.0, 0.0, 1.0]])
    far, near = torch.tensor([[30.0, -40.0]]), torch.tensor([[0.1, 0.2]])

    def f(kind, params, p):
        params = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in params.items()}
        return float(bsdf_ops.bsdf_eval(kind, params, wi, wo, p)[0]) * np.pi

    data = np.array([[0.2, 0.4], [0.6, 1.0]])
    assert f("bitmap", {"data": data, "extent": 1.0}, None) == pytest.approx(0.55, rel=1e-6)
    checker = PARAMS["checkerboard"]
    assert f("checkerboard", checker, None) == pytest.approx(0.2, rel=1e-6)
    assert f("checkerboard", checker, torch.tensor([[7.0, 0.0]])) == pytest.approx(0.8, rel=1e-6)
    patch = {"bg_reflectance": 0.2, "patch_reflectance": 0.8, "patch_edges": 1.0}
    assert f("central_patch:lambertian:lambertian", patch, None) == pytest.approx(0.2, rel=1e-6)
    assert f("central_patch:lambertian:lambertian", patch, near) == pytest.approx(0.8, rel=1e-6)
    assert f("central_patch:lambertian:lambertian", patch, far) == pytest.approx(0.2, rel=1e-6)
    mask = {"nested_reflectance": 0.6, "opacity_map": np.full((2, 2), 0.5), "mask_extent": 5.0}
    assert f("opacity_mask:lambertian", mask, None) == pytest.approx(0.6, rel=1e-6)
    assert f("opacity_mask:lambertian", mask, far) == pytest.approx(0.3, rel=1e-6)
    select = {"c0_reflectance": 0.1, "c1_reflectance": 0.9, "index_map": [[0.0, 1.0]],
              "select_extent": 20.0}
    assert f("select:lambertian:lambertian", select, None) == pytest.approx(0.1, rel=1e-6)
    assert f("select:lambertian:lambertian", select, torch.tensor([[5.0, 0.0]])) == \
        pytest.approx(0.9, rel=1e-6)


def test_supported_kinds_are_the_references():
    """Every tracer takes the reference's kinds; the kinds with a Mueller
    matrix of their own stay the two polarized ones."""
    assert bsdf_ops.SUPPORTED_BSDFS == ref_bsdf.SUPPORTED_BSDFS
    assert len(bsdf_ops.SUPPORTED_BSDFS) == 13
    assert bsdf_ops.POLARIZED_SURFACES == ref_bpol.POLARIZED_SURFACES
    for kind in bsdf_ops.SUPPORTED_BSDFS:
        bsdf_ops.check_kind(kind)
    for kind in ("central_patch:rtls:bitmap", "opacity_mask:ocean_legacy", "select:black",
                 "select:rpv:hapke:mqdiffuse"):
        bsdf_ops.check_kind(kind)


@pytest.mark.parametrize("kind, name", [
    ("no_such_kind", "'no_such_kind'"),
    ("central_patch:lambertian:no_such_kind", "'no_such_kind'"),
    ("central_patch:lambertian", "'central_patch:lambertian'"),
    ("mask:lambertian", "'mask:lambertian'"),
    ("select:opacity_mask:lambertian", "'opacity_mask'"),
])
def test_unknown_kind_raises(kind, name):
    """An unknown kind raises ``ValueError`` naming it, as the reference's
    dispatch does; a nested composite is unknown to both."""
    wi = torch.tensor([[0.0, 0.0, 1.0]])
    with pytest.raises(ValueError, match=name):
        bsdf_ops.bsdf_eval(kind, {}, wi, wi)
    with pytest.raises(ValueError, match=name):
        bsdf_ops.bsdf_sample_from_uniforms(kind, {}, wi, torch.zeros(1, 2))
    with pytest.raises(ValueError, match=name):
        bsdf_polarized.surface_mueller(kind, {}, wi, wi)
