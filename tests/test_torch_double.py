"""The port's double-precision modes on the plane-parallel atmosphere
experiment, against the JAX package under x64.

The port runs path state in float64 whenever a double mode is set (no x64
switch of its own); the JAX package does so with ``jax_enable_x64`` on, which
these tests switch on and back off around each reference call, as
``tests/conftest.py`` does. Uniforms stay float32 in both, and the port
rounds the float32 arithmetic on them as the jitted reference does
(``ops/fastmath``: the depth sample's ``log1p``, the cube root of the
Rayleigh sample, the azimuth's polynomials and the cosine-hemisphere
direction). Gates, at the same seed:

- c1 (Rayleigh over Lambertian), c2 (RPV floor under the continental
  aerosol) and c3 (the synthetic CKD database at 2 bins x 2 g-points), each
  scalar and polarized: every raw pixel's radiance and second moment within
  1e-10 relative, Q, U and V within 1e-10 of I;
- the sensitivity case: the port's single-precision render of the same c1
  scene misses that gate (its path state is float32);
- every double mode id and alias resolves to float64 path state and renders
  a small plane-parallel and a small spherical scene and a small leaf
  canopy in float64; a canopy with triangles raises naming the mode;
- ``compile_scene`` in a double mode gives the reference's leaves under x64
  bit for bit, float64 each (plane-parallel and spherical: no sun-tau table,
  which is float32 only);
- ``ops/fastmath``'s float32 pieces against the jitted reference, bit for
  bit: ``log1p(-u)`` and ``cbrt(2u - 1)`` on every uniform of the 2^-24
  grid (XLA's own float32 ``log1p``; glibc's ``powf``, which XLA:CPU calls
  for ``cbrt``), the fused azimuth polynomials, the cosine-hemisphere and
  cone directions and ``sqrt(1 - c^2)`` on seeded uniforms.
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
from eradiate_tpu.physics.absorption import make_synthetic_ckd_db as ref_ckd_db
from eradiate_tpu.test_tools.test_cases import create_rpv_afgl1986_continental_brfpp as ref_c2
from eradiate_tpu.core import warp as ref_warp
from eradiate_tpu.ops import fastmath as ref_fastmath
from eradiate_tpu.ops import phase_ops as ref_phase
from eradiate_tpu_torch import AtmosphereExperiment, CanopyAtmosphereExperiment
from eradiate_tpu_torch.ops import fastmath
from eradiate_tpu_torch.physics.absorption import make_synthetic_ckd_db
from eradiate_tpu_torch.test_tools.test_cases import (
    create_het01_brfpp,
    create_rpv_afgl1986_continental_brfpp,
)
from test_torch_canopy_experiment import _with_tree
from test_torch_experiment import _leaves

torch.set_num_threads(1)

RTOL = 1e-10
SPP = 64
DOUBLE_MODES = ("mono_double", "mono_polarized_double", "ckd_double", "ckd_polarized_double")
ALIASES = {"mono": "mono_double", "mono_polarized": "mono_polarized_double",
           "ckd": "ckd_double", "ckd_polarized": "ckd_polarized_double"}
MEASURES = {"type": "mdistant", "construct": "hplane", "zeniths": [-60.0, -20.0, 0.0, 45.0],
            "azimuth": 0.0, "id": "m"}


def c1_kwargs():
    return dict(illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
                measures=MEASURES, surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "molecular"})


def c3_kwargs(db):
    """c3's scene at 2 bins (two delta wavelengths) x 2 g-points."""
    return dict(illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
                measures={**MEASURES, "srf": {"type": "delta", "wavelengths": [650.0, 665.0]}},
                surface={"type": "lambertian", "reflectance": 0.2},
                atmosphere={"type": "molecular", "absorption_data": db},
                ckd_quad_config={"ng_max": 2})


SCENES = {
    "c1": (lambda: RefExperiment(**c1_kwargs()), lambda: AtmosphereExperiment(**c1_kwargs())),
    "c2": (lambda: ref_c2(n_vza=4), lambda: create_rpv_afgl1986_continental_brfpp(n_vza=4)),
    "c3": (lambda: RefExperiment(**c3_kwargs(ref_ckd_db(base_sigma=2e-3, ng=2))),
           lambda: AtmosphereExperiment(**c3_kwargs(make_synthetic_ckd_db(base_sigma=2e-3, ng=2)))),
}


def render_pair(scene, ref_mode, port_mode, spp=SPP):
    """The reference's raw result in ``ref_mode`` under x64 and the port's in
    ``port_mode`` on the CPU, at one seed."""
    make_ref, make_port = SCENES[scene]
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    eradiate_tpu.set_mode(ref_mode)
    try:
        ref = make_ref()
        eradiate_tpu.run(ref, spp=spp, seed_state=SeedState(7), mesh=None)
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode(port_mode)
    try:
        out = make_port()
        eradiate_tpu_torch.run(out, spp=spp, seed_state=eradiate_tpu_torch.SeedState(7),
                               device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono")
    return ({k: np.asarray(v) for k, v in ref.measures[0].results["raw"].items()},
            out.measures[0].results["raw"])


def double_gate(raw, ref):
    """Every pixel's radiance and second moment within 1e-10 relative, and
    with Stokes output Q, U and V within 1e-10 of I. Returns the worst
    relative radiance difference."""
    for k in ("radiance", "m2"):
        assert raw[k].dtype == ref[k].dtype == np.float64 and raw[k].shape == ref[k].shape, k
        np.testing.assert_allclose(raw[k], ref[k], rtol=RTOL, atol=0, err_msg=k)
    if "stokes" in ref:
        st, ref_st = raw["stokes"], ref["stokes"]
        assert st.dtype == np.float64 and st.shape == ref_st.shape
        I = np.abs(ref_st[..., :1])
        assert (np.abs(st - ref_st) <= RTOL * I).all(), np.max(np.abs(st - ref_st) / I)
    return float(np.max(np.abs(raw["radiance"] / ref["radiance"] - 1.0)))


@pytest.mark.parametrize("scene, mode", [
    ("c1", "mono_double"), ("c1", "mono_polarized_double"),
    ("c2", "mono_double"), ("c2", "mono_polarized_double"),
    ("c3", "ckd_double"), ("c3", "ckd_polarized_double"),
])
def test_plane_parallel_matches_reference_under_x64(scene, mode):
    ref, raw = render_pair(scene, mode, mode)
    double_gate(raw, ref)
    assert raw["radiance"].shape[-1] == 4 and (raw["radiance"] > 0).all()
    if scene == "c3":
        assert raw["radiance"].shape[0] == 4  # 2 bins x 2 g-points


def test_single_precision_misses_the_double_gate():
    """The sensitivity case: the port's ``mono_single`` render of the same c1
    scene, held to the x64 reference, fails the 1e-10 gate (float32 path
    state is off by ~1e-7), so the gate tells the modes apart."""
    ref, raw = render_pair("c1", "mono_double", "mono_single")
    assert raw["radiance"].dtype == np.float32
    with pytest.raises(AssertionError):
        double_gate({k: np.asarray(raw[k], np.float64) for k in ("radiance", "m2")}, ref)
    rel = np.max(np.abs(raw["radiance"] / ref["radiance"] - 1.0))
    assert 1e-9 < rel < 1e-4


def _small(mode_id, spherical):
    kw = (c3_kwargs(make_synthetic_ckd_db(base_sigma=2e-3, ng=2))
          if mode_id.startswith("ckd") else c1_kwargs())
    if spherical:
        kw = {**kw, "geometry": "spherical_shell", "surface": {"type": "hapke"},
              "measures": {**kw["measures"], "target": [0.0, 0.0, 6378.1]}}
    return AtmosphereExperiment(**kw)


@pytest.mark.parametrize("mode_id", [*DOUBLE_MODES, *ALIASES])
def test_every_double_mode_renders_in_float64(mode_id):
    """Each double mode id and alias: float64 path state, a small
    plane-parallel and a small spherical render, a small leaf canopy
    rendered in float64 (the float64 builds of the leaf sweeps), and a
    canopy with triangles (a tree's trunks) rendered in float64 too (the
    float64 builds of the triangle sweeps)."""
    eradiate_tpu_torch.set_mode(mode_id)
    try:
        m = eradiate_tpu_torch.mode()
        assert m.id == ALIASES.get(mode_id, mode_id)
        assert m.device_dtype is torch.float64 and m.host_dtype is np.float64
        for spherical in (False, True):
            exp = _small(mode_id, spherical)
            ds = eradiate_tpu_torch.run(exp, spp=8, seed_state=eradiate_tpu_torch.SeedState(3),
                                        device="cpu")
            raw = exp.measures[0].results["raw"]
            assert raw["radiance"].dtype == np.float64
            assert np.isfinite(np.asarray(ds["brf"])).all()
            assert ("stokes" in raw) == m.is_polarized
        canopy = CanopyAtmosphereExperiment(
            canopy=create_het01_brfpp(n_vza=1, n_leaves=20).canopy,
            measures={"type": "mdistant", "construct": "hplane", "zeniths": [0.0]})
        ds = eradiate_tpu_torch.run(canopy, spp=8, seed_state=eradiate_tpu_torch.SeedState(3),
                                    device="cpu")
        assert canopy.measures[0].results["raw"]["radiance"].dtype == np.float64
        assert np.isfinite(np.asarray(ds["brf"])).all()
        tree = _with_tree()
        ds = eradiate_tpu_torch.run(tree, spp=8, seed_state=eradiate_tpu_torch.SeedState(3),
                                    device="cpu")
        assert tree.measures[0].results["raw"]["radiance"].dtype == np.float64
        assert np.isfinite(np.asarray(ds["brf"])).all()
    finally:
        eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("scene, mode", [("c1", "mono_double"), ("c3", "ckd_double"),
                                         ("c4", "mono_polarized_double")])
def test_compile_scene_leaves_bitwise_under_x64(scene, mode):
    if scene == "c4":
        kw = {**c1_kwargs(), "geometry": "spherical_shell", "surface": {"type": "hapke"},
              "illumination": {"type": "directional", "zenith": 75.0, "azimuth": 0.0},
              "measures": {**MEASURES, "target": [0.0, 0.0, 6378.1]}}
        make_ref, make_port = (lambda: RefExperiment(**kw)), (lambda: AtmosphereExperiment(**kw))
    else:
        make_ref, make_port = SCENES[scene]
    eradiate_tpu_torch.set_mode(mode)
    try:
        exp = make_port()
        ctx = exp.spectral_context(exp.measures[0])
        out = _leaves(exp.compile_scene(exp.measures[0], ctx))
    finally:
        eradiate_tpu_torch.set_mode("mono")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    eradiate_tpu.set_mode(mode)
    try:
        ref_exp = make_ref()
        ref = _leaves(ref_exp.compile_scene(ref_exp.measures[0], ctx))
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
    assert out.keys() == ref.keys()
    floats = 0
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
            floats += v.dtype == np.float64
        else:
            assert out[k] == v, k
    assert floats >= 8
    if scene == "c4":
        assert out["[0].medium.sun_tau"] is None


def _grid(lo, hi):
    """The uniforms ``k * 2^-24`` for ``k`` in ``[lo, hi)``, float32."""
    return (np.arange(lo, hi, dtype=np.int64) * 2.0**-24).astype(np.float32)


def _same_bits(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype == np.float32
    bad = out.view(np.int32) != ref.view(np.int32)
    assert not bad.any(), f"{int(bad.sum())} values differ, e.g. at {np.nonzero(bad)[0][:4]}"


@pytest.mark.parametrize("fn", ["log1p", "cbrt"])
def test_float32_functions_on_every_uniform(fn):
    """Every uniform ``u`` of the 2^-24 grid, in chunks: ``log1p(-u)`` (the
    depth sample) and ``cbrt(2u - 1)`` (the Rayleigh sample's cube root),
    bit for bit with the jitted reference."""
    if fn == "log1p":
        ref, port = jax.jit(lambda u: jnp.log1p(-u)), fastmath.log1p_neg_xla
    else:
        ref, port = jax.jit(jnp.cbrt), fastmath.cbrt_xla
    for lo in range(0, 1 << 24, 1 << 22):
        u = _grid(lo, lo + (1 << 22))
        x = u if fn == "log1p" else (2.0 * u - 1.0).astype(np.float32)
        _same_bits(port(torch.from_numpy(x)), ref(jnp.asarray(x)))
    edges = np.float32([1.0, -1.0, 0.0, 2.0**-23, -(2.0**-23)])
    if fn == "cbrt":
        _same_bits(port(torch.from_numpy(edges)), ref(jnp.asarray(edges)))


#: The sun's cone: the directional sun of every BASELINE config, and a
#: solar disk.
CUTOFFS = (np.float64(1.0), np.float64(0.99998))


def test_fused_float32_sampling_pieces():
    """On seeded uniforms: the azimuth's polynomials with fused steps, the
    cosine-hemisphere direction and ``sqrt(1 - c^2)`` bit for bit with the
    jitted reference (the hemisphere's ``z`` up to the sign of a zero); the
    scattered direction about a float64 axis within 4e-16; the cone around
    the sun with a float64 ``cos_cutoff``, bit for bit for the directional
    sun and within 2e-9 for a solar disk (there XLA rounds ``(1 - u) + u
    cos_cutoff`` with a float64 fused multiply-add, and ``1 - cos^2``
    cancels that last ulp into ~1e-9 of the sine)."""
    rng = np.random.default_rng(11)
    u = (rng.integers(0, 1 << 24, (1 << 20, 2)) * 2.0**-24).astype(np.float32)
    u[:4] = [[0.0, 0.0], [0.5, 0.25], [1 - 2.0**-24, 0.75], [0.25, 1 - 2.0**-24]]
    ut = torch.from_numpy(u)
    for got, want in zip(fastmath.cos_sin_2pi(ut[:, 1], fused=True),
                         jax.jit(ref_fastmath.cos_sin_2pi)(jnp.asarray(u[:, 1]))):
        _same_bits(got, want)
    got = fastmath.cosine_hemisphere_xla(ut).numpy()
    want = np.asarray(jax.jit(ref_warp.square_to_cosine_hemisphere)(jnp.asarray(u)))
    _same_bits(got[:, :2], want[:, :2])
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    c = (2.0 * u[:, 0] - 1.0).astype(np.float32)
    sin_ref = jax.jit(lambda c: jnp.sqrt(jnp.clip(1.0 - c * c, 0.0, 1.0)))(jnp.asarray(c))
    _same_bits(fastmath.sin_from_cos_xla(torch.from_numpy(c)), sin_ref)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        cone = jax.jit(ref_warp.square_to_uniform_cone)
        want = [np.asarray(cone(jnp.asarray(u), jnp.asarray(cc))) for cc in CUTOFFS]
        d = np.asarray(jax.jit(ref_phase.direction_from_cos_u)(
            jnp.asarray(np.tile([0.0, 0.6, 0.8], (len(u), 1))), jnp.asarray(c),
            jnp.asarray(u[:, 1])))
    finally:
        jax.config.update("jax_enable_x64", old)
    for cc, w, tol in zip(CUTOFFS, want, (0.0, 2e-9)):
        got = fastmath.uniform_cone_xla(ut, torch.tensor(cc)).numpy()
        assert got.dtype == w.dtype == np.float64
        np.testing.assert_allclose(got, w, rtol=0, atol=tol)
    from eradiate_tpu_torch.ops.phase_ops import direction_from_cos_u

    axis = torch.tensor([[0.0, 0.6, 0.8]], dtype=torch.float64).expand(len(u), 3)
    got = direction_from_cos_u(axis, torch.from_numpy(c), ut[:, 1]).numpy()
    np.testing.assert_allclose(got, d, rtol=0, atol=4e-16)
