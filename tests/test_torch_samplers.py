"""The port's threefry key stream, samplers and one-shot tracer against the
JAX package.

``core.threefry``'s tensor functions reproduce ``jax.random``'s ``fold_in``,
``split``, ``bits``, ``uniform`` (float32, and float64 under x64) and
``permutation`` bit for bit (``jax_threefry_partitionable`` on, JAX's
default); ``ops.samplers`` reproduces every ``primary_samples`` kind of the
jitted reference, ``owen_scrambled_vdc`` and ``padded_bounce_uniforms`` bit
for bit; the legacy ``threefry`` stream of ``ops.fastrng`` likewise. The
one-shot loop (``trace_paths``) agrees with the reference's lane by lane
within 1e-5 relative at the same keys, the port's one-shot and regenerative
loops give the same estimate (the reference's own gate), and ``render`` with
a structured sampler or the threefry stream agrees with the reference's
within 1e-5 a pixel. The spherical and canopy tracers ignore the sampler, as
the reference's do, and follow the threefry stream as the reference's do
(the spherical within 1e-5, the canopy in ``mono_double`` under x64 within
1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.ops import fastrng as ref_rng
from eradiate_tpu.ops import samplers as ref_samplers
from eradiate_tpu.ops import scene_state as ref_state
from eradiate_tpu.ops import tracer as ref_tracer
from eradiate_tpu.ops.tracer_canopy import render_canopy as ref_render_canopy
from eradiate_tpu.ops.tracer_spherical import render_spherical as ref_render_spherical
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.core import threefry
from eradiate_tpu_torch.ops import fastrng, samplers
from eradiate_tpu_torch.ops import tracer
from eradiate_tpu_torch.ops.tracer_canopy import render_canopy
from eradiate_tpu_torch.ops.tracer_spherical import render_spherical
from eradiate_tpu_torch.ops.scene_state import from_reference

from test_torch_canopy_experiment import port_exp as canopy_port_exp
from test_torch_canopy_experiment import ref_exp as canopy_ref_exp

torch.set_num_threads(1)

SEED = 5
RTOL = 1e-5
SHAPES = [(1,), (7,), (1000,), (3, 5), ()]
STRUCTURED = ("stratified", "multijitter", "orthogonal", "ldsampler")


def _keys(seed, n=6):
    """Key words of ``n`` keys, the extremes among them."""
    kd = np.random.default_rng(seed).integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    kd[0], kd[1] = (0, 0), (2**32 - 1, 2**32 - 1)
    kd = kd.astype(np.uint32)
    return jax.random.wrap_key_data(jnp.asarray(kd)), torch.as_tensor(kd.astype(np.int64))


def _int(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


# -- threefry on tensors -------------------------------------------------------


def test_fold_in_over_a_batch_bitwise():
    ref_keys, keys = _keys(1)
    data = np.random.default_rng(2).integers(0, 2**32, size=6, dtype=np.uint64).astype(np.uint32)
    ref = jax.random.key_data(jax.vmap(jax.random.fold_in)(ref_keys, jnp.asarray(data)))
    np.testing.assert_array_equal(threefry.fold_in_t(keys, torch.as_tensor(_int(data))).numpy(),
                                  _int(ref))


@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split_bitwise(num):
    ref_keys, keys = _keys(3)
    ref = jax.random.key_data(jax.vmap(lambda k: jax.random.split(k, num))(ref_keys))
    np.testing.assert_array_equal(threefry.split_t(keys, num).numpy(), _int(ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_bitwise(shape):
    ref_keys, keys = _keys(4)
    ref = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(ref_keys)
    np.testing.assert_array_equal(threefry.bits_t(keys, shape).numpy(), _int(ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_float32_bitwise(shape):
    ref_keys, keys = _keys(5)
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(ref_keys))
    out = threefry.uniform_t(keys, shape).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_float64_bitwise_under_x64(x64, shape):
    ref_keys, keys = _keys(6)
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float64))(ref_keys))
    out = threefry.uniform_t(keys, shape, torch.float64).numpy()
    assert ref.dtype == out.dtype == np.float64
    np.testing.assert_array_equal(out.view(np.int64), ref.view(np.int64))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 2000])
def test_permutation_bitwise(n):
    """1 and 7 take no round and one round of sorts, 2000 two (JAX's count
    ``ceil(3 ln n / ln(2^32 - 1))``)."""
    ref_keys, keys = _keys(7)
    ref = jax.vmap(lambda k: jax.random.permutation(k, n))(ref_keys)
    np.testing.assert_array_equal(threefry.permutation_t(keys, n).numpy(), _int(ref))


# -- the legacy threefry stream --------------------------------------------------


def test_threefry_stream_bitwise():
    ref_keys, keys = _keys(8, n=64)
    sid = np.arange(64, dtype=np.int32) * 977 + 3
    depth = np.arange(64, dtype=np.int32) % 9
    ref = jax.random.key_data(ref_rng.derive_keys("threefry", ref_keys, jnp.asarray(sid)))
    np.testing.assert_array_equal(
        fastrng.derive_keys(keys, torch.as_tensor(_int(sid)), "threefry").numpy(), _int(ref))
    row = keys[3]
    np.testing.assert_array_equal(
        fastrng.derive_keys(row, torch.as_tensor(_int(sid)), "threefry").numpy(),
        fastrng.derive_keys(row.expand(64, 2), torch.as_tensor(_int(sid)), "threefry").numpy())
    for n in (2, 8, 10):
        ref = np.asarray(ref_rng.bounce_uniforms("threefry", ref_keys, jnp.asarray(depth), n))
        out = fastrng.bounce_uniforms(keys, torch.as_tensor(_int(depth)), n, "threefry").numpy()
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    ref = np.asarray(ref_rng.origin_uniforms("threefry", ref_keys, 2))
    out = fastrng.origin_uniforms(keys, 2, "threefry").numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_threefry_origin_uniforms_float64_bitwise_under_x64(x64):
    ref_keys, keys = _keys(9, n=64)
    ref = np.asarray(ref_rng.origin_uniforms("threefry", ref_keys, 2, dtype=jnp.float64))
    out = fastrng.origin_uniforms(keys, 2, "threefry", torch.float64).numpy()
    assert ref.dtype == out.dtype == np.float64
    np.testing.assert_array_equal(out.view(np.int64), ref.view(np.int64))


def test_unknown_rng_impl_raises():
    _, keys = _keys(10)
    with pytest.raises(ValueError, match="xoshiro"):
        fastrng.bounce_uniforms(keys, torch.zeros(6, dtype=torch.int64), 4, "xoshiro")


# -- samplers -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ref_samplers.SAMPLER_KINDS)
@pytest.mark.parametrize("spp", [1, 7, 64, 1000])
def test_primary_samples_bitwise(kind, spp):
    """Against the jitted reference (XLA rewrites the division by spp into a
    product with its reciprocal and contracts multijitter's inner product
    and sum into a fused multiply-add)."""
    ref_keys, keys = _keys(11)
    ref = np.asarray(jax.jit(jax.vmap(lambda k: ref_samplers.primary_samples(kind, spp, k)))(
        ref_keys))
    out = samplers.primary_samples(kind, spp, keys).numpy()
    assert out.shape == (6, spp) and out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert ((out >= 0.0) & (out < 1.0)).all()


def test_unknown_sampler_kind_raises():
    with pytest.raises(ValueError, match="halton"):
        samplers.primary_samples("halton", 8, _keys(12)[1])


def _words(seed, n=20000):
    w = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    return w.astype(np.uint32)


def test_owen_scrambled_vdc_bitwise():
    idx, seed = _words(13), _words(14)
    ref = np.asarray(ref_samplers.owen_scrambled_vdc(jnp.asarray(idx), jnp.asarray(seed)))
    out = samplers.owen_scrambled_vdc(torch.as_tensor(_int(idx)),
                                      torch.as_tensor(_int(seed))).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_padded_bounce_uniforms_bitwise():
    slot, seed = _words(15), _words(16)
    depth = np.random.default_rng(17).integers(0, 64, size=slot.size).astype(np.int32)
    ref = np.asarray(ref_samplers.padded_bounce_uniforms(
        jnp.asarray(slot), jnp.asarray(seed), jnp.asarray(depth)))
    out = samplers.padded_bounce_uniforms(*(torch.as_tensor(_int(x))
                                            for x in (slot, seed, depth))).numpy()
    assert out.shape == (slot.size, 10)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


# -- the one-shot loop -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A c1-class column of eight layers, one spectral row, four views."""
    return __graft_entry__._tiny_scene(S=1)


def _rows(scene):
    """Spectral row 0 of a reference scene, for the reference's loops."""
    med, il = scene.medium, scene.illumination
    mr = ref_state.MediumArrays(
        z_levels=med.z_levels, tau_levels=med.tau_levels[0], albedo=med.albedo[0],
        phase_weights=med.phase_weights[0],
        phase_params=jax.tree_util.tree_map(lambda a: a[0], med.phase_params))
    sr = ref_state.SurfaceArrays(params={k: v[0] for k, v in scene.surface.params.items()})
    ir = ref_state.IlluminationArrays(direction=il.direction, irradiance=il.irradiance[0],
                                      cos_cutoff=il.cos_cutoff, sky_radiance=il.sky_radiance[0])
    return mr, sr, ir


@pytest.mark.parametrize("sampler", ["independent", "stratified", "ldsampler"])
def test_trace_paths_matches_reference_lane_by_lane(tiny, sampler):
    """The one-shot loop at the same keys, first-flight uniforms and padded
    points: every lane within 1e-5 relative (1e-12 absolute)."""
    scene, sensor, config = tiny
    config = dataclasses.replace(config, sampler=sampler)
    n_pix, spp = sensor.directions.shape[0], 128
    B = n_pix * spp
    key = jax.random.fold_in(jax.random.key(SEED), 0)
    pix = np.repeat(np.arange(n_pix), spp)
    slot = np.tile(np.arange(spp), n_pix)
    z_top = float(np.asarray(scene.medium.z_levels)[-1])
    init_d = -np.asarray(sensor.directions)[pix]
    ref_keys = ref_rng.derive_keys("pcg4d", jnp.broadcast_to(key, (B,)),
                                   jnp.asarray(pix * spp + slot))
    u0 = ld = None
    if sampler != "independent":
        u0 = np.asarray(jax.vmap(lambda k: ref_samplers.primary_samples(sampler, spp, k))(
            jax.random.split(key, n_pix))).reshape(B)
        ld = (slot.astype(np.uint32), _words(18, n_pix)[pix])
    ref = np.asarray(ref_tracer.trace_paths(
        config, *_rows(scene), jnp.full(B, z_top, jnp.float32), jnp.zeros((B, 2)),
        jnp.asarray(init_d, jnp.float32), ref_keys,
        None if u0 is None else jnp.asarray(u0),
        None if ld is None else tuple(jnp.asarray(x) for x in ld)))

    s, se, c = from_reference(scene, sensor, config, "cpu")
    rows = tracer.row_arrays(s, 0)
    L, iterations = tracer.trace_paths(
        c, *rows, torch.full((B,), z_top), torch.zeros((B, 2)),
        torch.as_tensor(init_d, dtype=torch.float32),
        torch.as_tensor(_int(jax.random.key_data(ref_keys))),
        u0_dist=None if u0 is None else torch.tensor(u0),
        ld=None if ld is None else tuple(torch.as_tensor(_int(x)) for x in ld))
    assert 1 <= iterations <= config.max_depth
    np.testing.assert_allclose(L.numpy(), ref, rtol=RTOL, atol=1e-12)
    assert (ref > 0).mean() > 0.5


def test_one_shot_equals_regenerative(tiny):
    """The reference's gate, in the port: the one-shot loop's keys depend on
    (pixel, global sample id) as the regenerative loop's, so both render the
    same sample set (the regenerative one with many samples a lane)."""
    scene, sensor, config = tiny
    s, se, c = from_reference(scene, sensor, config, "cpu")
    rows = tracer.row_arrays(s, 0)
    n_pix, spp = se.directions.shape[0], 512
    key = tracer.row_key(9, 0, 0, "cpu")
    args = (c, n_pix, spp, *rows, se.directions, key, se.target, se.ray_offset, None)
    rad_a, m2_a, _ = tracer._render_row(*args, tracer.CHECK_EVERY)
    lp, quota = tracer._lane_plan(n_pix, spp, 64)
    assert quota > 1
    rad_b, m2_b, _ = tracer._render_row_regen(*args, 64, tracer.CHECK_EVERY)
    np.testing.assert_allclose(rad_a.numpy(), rad_b.numpy(), rtol=5e-6)
    np.testing.assert_allclose(m2_a.numpy(), m2_b.numpy(), rtol=5e-6)


def test_one_shot_check_interval_is_bitwise_neutral(tiny):
    scene, sensor, config = tiny
    s, se, c = from_reference(scene, sensor, dataclasses.replace(config, sampler="stratified"),
                              "cpu")
    a = tracer.render(s, se, c, 64, seed=SEED, device="cpu", check_every=1)
    b = tracer.render(s, se, c, 64, seed=SEED, device="cpu", check_every=5)
    assert torch.equal(a["radiance"], b["radiance"]) and torch.equal(a["m2"], b["m2"])


# -- render ------------------------------------------------------------------------


@pytest.mark.parametrize("sampler, rng", [("independent", "threefry"),
                                          ("stratified", "threefry")])
def test_render_matches_reference(tiny, sampler, rng):
    """The threefry stream through either loop: per pixel within 1e-5 of the
    reference (the pcg4d stream's structured samplers:
    :func:`test_run_with_a_structured_sampler_matches_reference`)."""
    scene, sensor, config = tiny
    config = dataclasses.replace(config, sampler=sampler, rng=rng)
    ref = ref_tracer.render(scene, sensor, config, 128, seed=SEED)
    s, se, c = from_reference(scene, sensor, config, "cpu")
    out = tracer.render(s, se, c, 128, seed=SEED, device="cpu")
    assert out["spp"] == ref["spp"] == 128
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=0)


@pytest.mark.parametrize("spp_chunk", [48])
def test_structured_chunks_round_up(tiny, spp_chunk):
    """The budget rounds up to whole chunks, each with its own key, and
    ``spp`` reports what was traced (reference ``render``)."""
    scene, sensor, config = tiny
    config = dataclasses.replace(config, sampler="multijitter")
    ref = ref_tracer.render(scene, sensor, config, 100, seed=SEED, spp_chunk=spp_chunk)
    s, se, c = from_reference(scene, sensor, config, "cpu")
    out = tracer.render(s, se, c, 100, seed=SEED, device="cpu", spp_chunk=spp_chunk)
    assert out["spp"] == ref["spp"] == spp_chunk * -(-100 // spp_chunk)
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=0)


def test_chunk_plan_of_the_one_shot_loop():
    """Uniform chunks, the budget rounded up; the regenerative renders'
    plan keeps a short last chunk."""
    cap = tracer.MAX_PATHS_PER_DISPATCH
    assert tracer.one_shot_chunks(100, None, cap // 16) == [16] * 7
    assert tracer.one_shot_chunks(10, None, 4) == [10]
    assert tracer.one_shot_chunks(100, 30, 4) == [30] * 4
    assert tracer.one_shot_chunks(5, None, 2 * cap) == [1] * 5
    assert tracer.chunk_plan(100, None, 1, 4, 64) == [16] * 6 + [4]


def _c1(n_vza, sampler):
    return dict(illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": np.linspace(-60, 60, n_vza), "azimuth": 0.0, "id": "m",
                          "sampler": sampler},
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "molecular"})


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("sampler", STRUCTURED)
def test_run_with_a_structured_sampler_matches_reference(mono_single, sampler):
    """``run`` on c1's column (merged as c1 runs) at 4 views, 128 spp: every
    variable of the dataset within 1e-5 a pixel."""
    ref = eradiate_tpu.run(RefExperiment(**_c1(4, sampler)), spp=128,
                           seed_state=SeedState(SEED), mesh=None)
    out = eradiate_tpu_torch.run(AtmosphereExperiment(**_c1(4, sampler)), spp=128,
                                 seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    for k in ("radiance", "brf", "m2"):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=RTOL, atol=0)


def test_spherical_ignores_the_sampler(mono_single):
    """The spherical tracer renders any sampler as ``independent`` (the
    reference's never reads it): the stratified render equals the
    independent one bit for bit, and the reference's within 1e-5."""
    kw = dict(_c1(3, "stratified"), geometry="spherical_shell")
    ref = eradiate_tpu.run(RefExperiment(**kw), spp=64, seed_state=SeedState(SEED), mesh=None)
    out = eradiate_tpu_torch.run(AtmosphereExperiment(**kw), spp=64,
                                 seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    ind = eradiate_tpu_torch.run(
        AtmosphereExperiment(**dict(_c1(3, "independent"), geometry="spherical_shell")),
        spp=64, seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    np.testing.assert_array_equal(np.asarray(out["radiance"]), np.asarray(ind["radiance"]))
    np.testing.assert_allclose(np.asarray(out["radiance"]), np.asarray(ref["radiance"]),
                               rtol=RTOL, atol=0)


def test_canopy_ignores_the_sampler(mono_single):
    """The canopy tracer (the canopy tests' small HET01) renders any sampler
    as ``independent``, as the reference's: the ldsampler render equals the independent one bit for
    bit, and the reference's ldsampler render within the canopy gate."""
    from test_torch_canopy_experiment import gate

    def with_sampler(exp):
        exp.measures[0].sampler = "ldsampler"
        return exp

    out = eradiate_tpu_torch.run(with_sampler(canopy_port_exp(atmosphere=False)), spp=64,
                                 seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    ind = eradiate_tpu_torch.run(canopy_port_exp(atmosphere=False), spp=64,
                                 seed_state=eradiate_tpu_torch.SeedState(SEED), device="cpu")
    ref = eradiate_tpu.run(with_sampler(canopy_ref_exp(atmosphere=False)), spp=64,
                           seed_state=SeedState(SEED), mesh=None)
    np.testing.assert_array_equal(np.asarray(out["radiance"]), np.asarray(ind["radiance"]))
    gate(out, ref)


def test_spherical_threefry_matches_reference(mono_single):
    """The threefry stream in the spherical tracer: every pixel within 1e-5
    of the reference's at the same seed, and not the pcg4d render."""
    kw = dict(_c1(3, "independent"), geometry="spherical_shell")
    port, ref_exp = AtmosphereExperiment(**kw), RefExperiment(**kw)
    ctx = port.spectral_context(port.measures[0])
    scene, sensor, config = port.compile_scene(port.measures[0], ctx)
    r_scene, r_sensor, r_config = ref_exp.compile_scene(ref_exp.measures[0], ctx)
    out = render_spherical(scene, sensor, dataclasses.replace(config, rng="threefry"), spp=64,
                           seed=SEED, device="cpu")
    ref = ref_render_spherical(r_scene.medium, r_scene.surface, r_scene.illumination, r_sensor,
                               dataclasses.replace(r_config, rng="threefry"), spp=64, seed=SEED)
    pcg = render_spherical(scene, sensor, config, spp=64, seed=SEED, device="cpu")
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=0,
                                   err_msg=k)
    assert (out["radiance"] > 0).all()
    assert not torch.equal(out["radiance"], pcg["radiance"])


def test_canopy_threefry_matches_reference_under_x64(x64):
    """The threefry stream in the canopy tracer (the canopy tests' small
    HET01) in ``mono_double``, the reference under x64: every pixel's
    radiance and second moment within 1e-10 of the reference's at the same
    seed, and not the pcg4d render."""
    from test_torch_canopy_experiment import compiled

    eradiate_tpu.set_mode("mono_double")
    eradiate_tpu_torch.set_mode("mono_double")
    try:
        out_c = compiled(canopy_port_exp(atmosphere=False))
        ref_c = compiled(canopy_ref_exp(atmosphere=False))
        args = (out_c[0], out_c[3], out_c[4], out_c[1])
        out = render_canopy(*args, dataclasses.replace(out_c[2], rng="threefry"), spp=64,
                            seed=SEED, device="cpu")
        ref = ref_render_canopy(ref_c[0], ref_c[3], ref_c[4], ref_c[1],
                                dataclasses.replace(ref_c[2], rng="threefry"), spp=64, seed=SEED)
        pcg = render_canopy(*args, out_c[2], spp=64, seed=SEED, device="cpu")
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    for k in ("radiance", "m2"):
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype == np.float64 and (b > 0).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0, err_msg=k)
    assert not torch.equal(out["radiance"], pcg["radiance"])


def threefry_canopy_lanes(seed, spp=64):
    """The threefry stream in the float32 canopy tracer, lane by lane: the
    small HET01 under the Rayleigh atmosphere (``mono_single``, one
    spectral row, ``spp`` samples a pixel in the reference's lane plan)
    traced by the reference's jitted ``trace_paths_canopy_regen``, by the
    reference's bounce (``_make_bounce_canopy``) jitted alone and stepped
    on the host through the same regenerative updates, and by the port.
    Returns the three lanes' sums (numpy)."""
    from eradiate_tpu.ops import tracer_canopy as ref_tc
    from eradiate_tpu.ops.fastrng import derive_keys as ref_derive
    from eradiate_tpu.ops.fastrng import origin_uniforms as ref_origin
    from eradiate_tpu_torch.ops import tracer_canopy
    from eradiate_tpu_torch.ops.scene_state import canopy_from_reference
    from test_torch_canopy_experiment import compiled

    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    try:
        scene, sensor, config, leaf_params, leaves = compiled(canopy_ref_exp())[:5]
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    config = dataclasses.replace(config, rng="threefry")
    n_pix = sensor.directions.shape[0]
    _, pix, _, lane_first, quota = ref_tracer.lane_partition(n_pix, spp)
    med, il = scene.medium, scene.illumination
    mr = ref_state.MediumArrays(
        z_levels=med.z_levels, tau_levels=med.tau_levels[0], albedo=med.albedo[0],
        phase_weights=med.phase_weights[0],
        phase_params=jax.tree.map(lambda x: x[0], med.phase_params))
    sr = jax.tree.map(lambda x: x[0] if getattr(x, "ndim", 0) else x, scene.surface)
    ir = ref_state.IlluminationArrays(
        direction=il.direction, irradiance=il.irradiance[0], cos_cutoff=il.cos_cutoff,
        sky_radiance=il.sky_radiance[0] if il.sky_radiance.ndim else il.sky_radiance,
        position=il.position)
    leaf_row = {k: v[0] for k, v in leaf_params.items()}
    w_v = jnp.asarray(sensor.directions)[pix]
    B = pix.shape[0]
    tgt = jnp.broadcast_to(jnp.asarray(sensor.target), (B, 3))
    ext = jnp.broadcast_to(jnp.asarray(sensor.target_extent), (B, 2))
    init_pos = tgt + w_v * ((mr.z_levels[-1] - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6))[:, None]
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 0), 0)

    loop = jax.jit(ref_tc.trace_paths_canopy_regen, static_argnums=(0,))(
        config, mr, sr, leaf_row, leaves, ir, init_pos, -w_v, key, lane_first, quota, ext=ext)[0]

    helpers = ref_tc._canopy_helpers(config, mr, leaf_row, leaves, ir, None, None)
    bounce = jax.jit(ref_tc._make_bounce_canopy(
        config, mr, sr, leaf_row, leaves, ir, None, None, helpers["tau_z"], helpers["nee_dir"],
        helpers["nee_at"], 1e-6, spheres=helpers["spheres"], tris_accel=helpers["tris_accel"]))
    row_keys = jnp.broadcast_to(key, (B,))

    def origin(k):
        jit = (ref_origin(config.rng, k, 2, dtype=jnp.float32) - 0.5) * ext
        return init_pos + jnp.concatenate([jit, jnp.zeros((B, 1))], -1)

    keys = ref_derive(config.rng, row_keys, lane_first)
    pos, d, beta = origin(keys), -w_v, jnp.ones(B)
    depth = s_local = jnp.zeros(B, jnp.int32)
    L_cur = L_sum = jnp.zeros(B)
    done = jnp.zeros(B, bool)
    while not bool(done.all()):
        L_add, pos2, d2, beta2, alive2 = bounce(depth, pos, d, beta, keys)
        active = ~done
        L_cur = L_cur + jnp.where(active, L_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))
        L_sum = L_sum + jnp.where(path_end, L_cur, 0.0)
        s_local = s_local + path_end.astype(jnp.int32)
        done = done | (s_local >= quota)
        regen = path_end & ~done
        keys_new = ref_derive(config.rng, row_keys, lane_first + s_local)
        keys = jnp.where(regen, keys_new, keys)
        pos = jnp.where(regen[:, None], origin(keys_new), pos2)
        d = jnp.where(regen[:, None], -w_v, d2)
        beta = jnp.where(regen, 1.0, beta2)
        L_cur = jnp.where(path_end, 0.0, L_cur)
        depth = jnp.where(regen, 0, depth)

    sc, se, cf = from_reference(scene, sensor, config, "cpu")
    p_leaves, p_params, _, _ = canopy_from_reference(leaves, leaf_params, "cpu")
    medium_row, surface_row, illum_row = tracer.row_arrays(sc, 0)
    _, p_pix, _, p_first, p_quota = tracer.lane_partition(n_pix, spp, 2**14, "cpu")
    p_pos, p_d, p_ext = tracer_canopy.lane_rays(medium_row, se.directions, se.target,
                                                se.ray_offset, se.target_extent, p_pix)
    port = tracer_canopy.trace_paths_canopy_regen(
        cf, medium_row, surface_row, {k: v[0] for k, v in p_params.items()}, p_leaves,
        illum_row, p_pos, p_d, torch.as_tensor(_int(jax.random.key_data(key))), p_first,
        p_quota, ext=p_ext)[0]
    return np.asarray(loop), np.asarray(L_sum), port.numpy()


@pytest.mark.parametrize("seed", [2, 5])
def test_canopy_threefry_follows_the_reference_bounce(seed):
    """The float32 canopy tracer with the threefry stream equals, on every
    lane within 1e-5 relative (float summation order), the reference's
    bounce jitted alone and stepped on the host. The reference's jitted
    ``while_loop`` leaves that path on a few lanes of these seeds (2: lane
    0; 5: lanes 13 and 29): XLA compiles the loop's body with the threefry
    stream in it otherwise than the bounce alone, which the port follows
    (``tools/threefry_canopy_lanes.py`` counts the lanes over 32 seeds)."""
    _, stepped, port = threefry_canopy_lanes(seed)
    assert (stepped > 0).any()
    np.testing.assert_allclose(port, stepped, rtol=RTOL, atol=1e-12)
