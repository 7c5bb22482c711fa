"""The port's aerosol path (BASELINE c2) against the JAX package.

c2 (``bench.py`` ``_c2``: RPV surface, AFGL Rayleigh with a 0-2 km
continental aerosol layer) compiles to the blend ``("rayleigh", "tab")``
over an ``rpv`` floor. Held here: the new device functions (RPV, the
Henyey-Greenstein, isotropic and tabulated phase functions, the bracketed
table fetches) against the reference's under ``jax.jit`` on seeded inputs,
each with its tolerance; the host side of ``tab`` and the packaged
continental dataset bit for bit, read from the port's own store and not from
the analytic surrogate; c2's compiled leaves bit for bit; c2 end to end at
the same seed within 1e-5 relative per pixel. In a polarized mode the
aerosol compiles to ``tab_polarized`` (bit for bit, carried across by
``from_reference``), and polarized c2 holds the polarized c1 gate.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import medium as ref_medium
from eradiate_tpu.ops import phase_ops as ref_phase
from eradiate_tpu.scenes.atmosphere import aerosols as ref_aerosols
from eradiate_tpu.test_tools.test_cases import (
    create_rpv_afgl1986_continental_brfpp as ref_c2,
)
from eradiate_tpu_torch.data import resolve_data
from eradiate_tpu_torch.ops import bsdf_ops, medium, phase_ops
from eradiate_tpu_torch.ops.scene_state import from_reference
from eradiate_tpu_torch.scenes.atmosphere import aerosols
from eradiate_tpu_torch.test_tools.test_cases import create_rpv_afgl1986_continental_brfpp

torch.set_num_threads(1)

PORT = Path(eradiate_tpu_torch.__file__).resolve().parent
DATASET = "govaerts_2021-continental"
N = 4096


def _unit(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _dirs(seed, n=N, up=False):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    if up:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


# -- the host side of tab and the dataset --------------------------------------


def test_dataset_is_the_packaged_file_bit_for_bit():
    """The port resolves the continental dataset in its own store, reads the
    file (not ``_surrogate``), and its arrays equal the reference's."""
    path = resolve_data(f"aerosol/{DATASET}.npz")
    assert path is not None and Path(path).resolve().is_relative_to(PORT / "data" / "store")
    ds, ref = aerosols.load_particle_dataset(DATASET), ref_aerosols.load_particle_dataset(DATASET)
    assert ds.id == ref.id == DATASET
    surrogate = aerosols._surrogate(DATASET)
    assert ds.mu.shape != surrogate.mu.shape or not np.array_equal(ds.phase, surrogate.phase)
    for name in ("w", "sigma_t", "albedo", "mu", "phase", "phase_12", "phase_33", "phase_34"):
        got, want = getattr(ds, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_missing_dataset_falls_back_like_the_reference():
    """The fallback the test above guards against is the reference's own."""
    ds = aerosols.load_particle_dataset("no-such-aerosol")
    ref = ref_aerosols.load_particle_dataset("no-such-aerosol")
    assert ds.id == ref.id == "surrogate-no-such-aerosol"
    np.testing.assert_array_equal(ds.phase, ref.phase)


@pytest.mark.parametrize("grid", ["dataset", "uniform mu", "random"])
def test_tab_tables_and_theta_grid_bit_for_bit(grid):
    rng = np.random.default_rng(5)
    if grid == "dataset":
        ds = ref_aerosols.load_particle_dataset(DATASET)
        mu, values = ds.mu, ds.phase
    elif grid == "uniform mu":
        mu = np.linspace(-1.0, 1.0, 101)
        values = rng.uniform(0.01, 3.0, (4, 101))
    else:
        mu = np.sort(np.concatenate([[-1.0, 1.0], rng.uniform(-1, 1, 60)]))
        values = rng.uniform(0.01, 3.0, 62)
    for got, want in zip(phase_ops.tab_phase_tables(mu, values),
                         ref_phase.tab_phase_tables(mu, values)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert phase_ops.theta_grid_params(mu) == ref_phase.theta_grid_params(mu)
    assert (phase_ops.theta_grid_params(mu) is not None) == (grid == "dataset")


# -- device functions against the jitted reference -----------------------------


def _tab_params(grid):
    """``tab`` parameters of one spectral row as float32 numpy: the
    continental dataset at 550 nm (theta-uniform, 181 nodes, ``tg0`` and
    ``itg``) or a random irregular grid of 64 nodes."""
    rng = np.random.default_rng(9)
    if grid == "theta-uniform":
        ds = ref_aerosols.load_particle_dataset(DATASET)
        mu, values = ds.mu, ds.phase[7]
    else:
        mu = np.sort(np.concatenate([[-1.0, 1.0], rng.uniform(-1, 1, 62)]))
        values = rng.uniform(0.01, 3.0, 64)
    v, cdf = ref_phase.tab_phase_tables(mu, values)
    params = {"mu": mu, "values": v, "cdf": cdf}
    tg = ref_phase.theta_grid_params(mu)
    if tg is not None:
        params.update(tg0=tg[0], itg=tg[1])
    return {k: np.asarray(x, np.float32) for k, x in params.items()}


def _cosines(mu, seed):
    """Uniform cosines, every node and one ulp either side, and +-1."""
    c = 2.0 * _unit(seed, N) - 1.0
    nodes = mu.astype(np.float32)
    extra = np.concatenate([nodes, np.nextafter(nodes, np.float32(2)),
                            np.nextafter(nodes, np.float32(-2)), [-1.0, 1.0, 0.0]])
    return np.clip(np.concatenate([c, extra]), -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("grid", ["theta-uniform", "irregular"])
def test_tab_eval(grid):
    """Within 2 ulp of the larger table value around the cosine's cell:
    XLA:CPU contracts ``v0 + frac * dv`` into one FMA under ``jit`` (which
    rounds once where the port rounds twice, and the sum may cancel), and a
    cosine within an ulp of a node may take the cell on its other side
    through the two libraries' ``acos`` (the interpolation is continuous
    there)."""
    params = _tab_params(grid)
    assert ("tg0" in params) == (grid == "theta-uniform")
    c = _cosines(params["mu"], 11)
    want = np.asarray(jax.jit(ref_phase.tab_eval)(_j(params), jnp.asarray(c)))
    got = phase_ops.tab_eval(_t(params), torch.as_tensor(c)).numpy()
    v, M = params["values"], params["values"].size
    k = np.clip(np.searchsorted(params["mu"], c, side="right") - 1, 0, M - 2)
    scale = np.max([v[np.clip(k + j, 0, M - 1)] for j in (-1, 0, 1, 2)], axis=0)
    assert (np.abs(got - want) <= 2.4e-7 * scale).all()
    assert np.isfinite(got).all() and (got > 0).all()


@pytest.mark.parametrize("grid", ["theta-uniform", "irregular"])
def test_tab_sample_cos(grid):
    """Within 2e-7 absolute (an ulp of a cosine near 1; the FMA above), and
    inside [-1, 1]; uniforms at 0, 1 and every CDF node among them."""
    params = _tab_params(grid)
    u = _unit(12, (N, 2))
    u[: params["cdf"].size, 0] = params["cdf"]
    u[-2:, 0] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    want = np.asarray(jax.jit(ref_phase.tab_sample_cos)(_j(params), jnp.asarray(u)))
    got = phase_ops.tab_sample_cos(_t(params), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert (np.abs(got) <= 1.0).all()


@pytest.mark.parametrize("g", [0.7, -0.35, 0.0, 5e-5])
def test_hg_and_isotropic(g):
    """HG value within 4 ulp of its terms' magnitude, amplified by the
    cancellation of ``1 + g^2 + 2 g cos`` (which XLA:CPU rounds once, as an
    FMA, and the port twice) and by the power 1.5; the sampled cosine within
    2e-6 absolute (a quotient of differences that loses digits near
    |cos| = 1); isotropic exactly."""
    c = _cosines(np.linspace(-1, 1, 9), 13)
    u = _unit(14, (N, 2))
    gt, gj = torch.tensor(np.float32(g)), jnp.float32(g)
    got = phase_ops.hg_eval(gt, torch.as_tensor(c)).numpy()
    want = np.asarray(jax.jit(ref_phase.hg_eval)(gj, jnp.asarray(c)))
    g64, c64 = np.float64(np.float32(g)), c.astype(np.float64)
    cond = 1.5 * (1.0 + g64 * g64 + 2.0 * abs(g64) * np.abs(c64)) / (
        1.0 + g64 * g64 + 2.0 * g64 * c64)
    assert (np.abs(got - want) <= 4 * 2.0**-23 * (1.0 + cond) * np.abs(want)).all()
    np.testing.assert_allclose(
        phase_ops.hg_sample_cos(gt, torch.as_tensor(u)).numpy(),
        np.asarray(jax.jit(ref_phase.hg_sample_cos)(gj, jnp.asarray(u))), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(phase_ops.iso_eval(torch.as_tensor(c)).numpy(),
                                  np.asarray(jax.jit(ref_phase.iso_eval)(jnp.asarray(c))))


def test_phase_blend_of_every_scalar_kind():
    """The blend dispatch with each component's own parameters: rayleigh,
    hg, isotropic and tab at fetched weights, value and sampled direction
    against the reference's per-path functions under ``vmap``."""
    kinds = ("rayleigh", "hg", "isotropic", "tab")
    params = ({"depol": np.zeros(3, np.float32)}, {"g": np.float32(0.6)},
              {"_": np.float32(0.0)}, _tab_params("theta-uniform"))
    rng = np.random.default_rng(15)
    weights = rng.dirichlet(np.ones(4), N).astype(np.float32)
    depol = rng.uniform(0.0, 0.05, N).astype(np.float32)
    c = (2.0 * _unit(16, N) - 1.0).astype(np.float32)
    d = _dirs(17)
    u_sel, u_cos, u_phi = _unit(18, N), _unit(19, (N, 2)), _unit(20, N)
    at = ({"depol": depol}, {}, {}, {})
    tparams = tuple(_t(p) for p in params)
    tat = tuple(_t(a) for a in at)
    jparams = tuple(_j(p) for p in params)

    want = jax.jit(jax.vmap(lambda w, dp, cc: ref_phase.phase_eval_at(
        kinds, jparams, w, ({"depol": dp}, {}, {}, {}), cc)))(weights, depol, c)
    got = phase_ops.phase_eval_at(kinds, tparams, torch.as_tensor(weights), tat,
                                  torch.as_tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)

    want = jax.jit(jax.vmap(lambda w, dp, dd, us, uc, up: ref_phase.phase_sample_at(
        kinds, jparams, w, ({"depol": dp}, {}, {}, {}), dd, us, uc, up)))(
            weights, depol, d, u_sel, u_cos, u_phi)
    got = phase_ops.phase_sample_at(kinds, tparams, torch.as_tensor(weights), tat,
                                    *map(torch.as_tensor, (d, u_sel, u_cos, u_phi)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=4e-6)


def test_interp_fetch():
    """Bracket, fraction and pairs equal the reference's gather branch bit
    for bit on queries below, inside and above the table, on its nodes and
    on a flat run."""
    rng = np.random.default_rng(21)
    x_table = np.sort(rng.uniform(-2.0, 3.0, 40)).astype(np.float32)
    x_table[10:13] = x_table[10]
    ys = tuple(rng.uniform(-1.0, 1.0, 40).astype(np.float32) for _ in range(2))
    x = np.concatenate([rng.uniform(-3.0, 4.0, N), x_table]).astype(np.float32)
    ref = jax.jit(ref_medium.interp_fetch)(jnp.asarray(x), jnp.asarray(x_table),
                                           tuple(map(jnp.asarray, ys)))
    out = medium.interp_fetch(torch.as_tensor(x), torch.as_tensor(x_table),
                              tuple(map(torch.as_tensor, ys)))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for (y0, dy), (ry0, rdy) in zip(out[2], ref[2]):
        np.testing.assert_array_equal(y0.numpy(), np.asarray(ry0))
        np.testing.assert_array_equal(dy.numpy(), np.asarray(rdy))


def test_fetch_pairs_at():
    """Pairs at given brackets, the last node's (dy = 0) among them, bit for
    bit."""
    rng = np.random.default_rng(22)
    ys = tuple(rng.uniform(-1.0, 1.0, 50).astype(np.float32) for _ in range(2))
    idx = np.concatenate([rng.integers(0, 49, N), [0, 48, 49]]).astype(np.int32)
    ref = jax.jit(ref_medium.fetch_pairs_at)(jnp.asarray(idx), tuple(map(jnp.asarray, ys)))
    out = medium.fetch_pairs_at(torch.as_tensor(idx).long(), tuple(map(torch.as_tensor, ys)))
    for (y0, dy), (ry0, rdy) in zip(out, ref):
        np.testing.assert_array_equal(y0.numpy(), np.asarray(ry0))
        np.testing.assert_array_equal(dy.numpy(), np.asarray(rdy))


RPV = [{"rho_0": 0.183, "k": 0.780, "g": -0.1, "rho_c": 0.183},
       {"rho_0": 0.05, "k": 1.3, "g": 0.25, "rho_c": 0.4}]


@pytest.mark.parametrize("params", RPV, ids=["grassland", "bright hot spot"])
def test_rpv_eval_and_sample(params):
    """RPV on random pairs of directions, 64 of them at the hot spot, and
    the cosine-hemisphere sample (directions within 1e-6, weight f pi). The
    port rounds each operation once, as the eager reference does: within
    4e-7 relative of it everywhere. Under ``jit`` XLA:CPU contracts into
    FMAs the hot spot's ``tan^2 i + tan^2 o - 2 tan i tan o cos dphi``,
    whose square root ``G`` amplifies the cancelled difference (4e-4 of the
    value), and the horizon's ``sqrt(1 - r^2)`` of the sampled directions:
    the value is held to the jitted reference within 2e-6 relative at least
    0.1 rad from the hot spot, and the sample's weight to the jitted eval at
    the port's directions. Zero below the horizon."""
    p = {k: np.float32(v) for k, v in params.items()}
    wi, wo = _dirs(23), _dirs(24, up=True)
    wi[:64] = wo[:64]
    u = _unit(25, (N, 2))

    def ref_eval(a, b):
        return ref_bsdf.bsdf_eval("rpv", _j(p), a, b)

    def ref_sample(a, b):
        return ref_bsdf.bsdf_sample_from_uniforms("rpv", _j(p), a, b)

    got = bsdf_ops.bsdf_eval("rpv", _t(p), torch.as_tensor(wi), torch.as_tensor(wo)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_eval(wi, wo)), rtol=4e-7, atol=0)
    off = np.sum(wi * wo, axis=1) < np.cos(0.1)
    np.testing.assert_allclose(got[off], np.asarray(jax.jit(ref_eval)(wi, wo))[off],
                               rtol=2e-6, atol=0)
    assert (got[wi[:, 2] <= 0] == 0).all() and (got[wi[:, 2] > 1e-3] > 0).all()

    w, wt = bsdf_ops.bsdf_sample_from_uniforms("rpv", _t(p), torch.as_tensor(wo),
                                               torch.as_tensor(u))
    rw, rwt = ref_sample(wo, u)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(rwt), rtol=4e-7, atol=0)
    w = w.numpy()
    off = np.sum(w * wo, axis=1) < np.cos(0.1)
    np.testing.assert_allclose(wt.numpy()[off],
                               np.pi * np.asarray(jax.jit(ref_eval)(w, wo))[off],
                               rtol=2e-6, atol=0)


# -- c2 -------------------------------------------------------------------------


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


def test_c2_compile_scene_leaves_bitwise(mono_single):
    ref_exp, exp = ref_c2(n_vza=11), create_rpv_afgl1986_continental_brfpp(n_vza=11)
    ctx = exp.spectral_context(exp.measures[0])
    np.testing.assert_array_equal(ctx["w"], ref_exp.spectral_context(ref_exp.measures[0])["w"])
    ref = _leaves(ref_exp.compile_scene(ref_exp.measures[0], ctx))
    out = _leaves(exp.compile_scene(exp.measures[0], ctx))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k
    # the blend, the floor and the tab grid the slice was written for
    assert out["[2].phase_kinds"] == ("rayleigh", "tab") and out["[2].surface_kind"] == "rpv"
    assert out["[0].medium.phase_params[1][mu]"].shape == (1, 181)
    assert out["[0].medium.phase_params[1][tg0]"].shape == (1,)
    assert out["[0].medium.z_levels"].size == 47


def test_c2_run_matches_reference(mono_single):
    """c2 at 11 view zeniths and 256 spp, one seed: every pixel within 1e-5
    relative (the c1 gate), the same dataset layout."""
    ref = eradiate_tpu.run(ref_c2(n_vza=11), spp=256, seed_state=SeedState(7), mesh=None)
    exp = create_rpv_afgl1986_continental_brfpp(n_vza=11)
    out = eradiate_tpu_torch.run(exp, spp=256, seed_state=eradiate_tpu_torch.SeedState(7),
                                 device="cpu")
    assert set(out.data_vars) == set(ref.data_vars)
    assert set(out.coords) == set(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    for k in ("radiance", "brf"):
        assert out[k].shape == ref[k].shape == (1, 11)
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=0)
    assert exp.measures[0].results["raw"]["iterations"] > 0


def test_transfer_refuses_a_tab_component_without_its_tables(mono_single):
    """``from_reference`` carries the tab tables bit for bit and refuses a
    component that lacks one."""
    exp = create_rpv_afgl1986_continental_brfpp(n_vza=3)
    scene, sensor, config = exp.compile_scene(exp.measures[0],
                                              exp.spectral_context(exp.measures[0]))
    out, _, _ = from_reference(scene, sensor, config, "cpu")
    for k, v in scene.medium.phase_params[1].items():
        np.testing.assert_array_equal(out.medium.phase_params[1][k].numpy(), v)
    tab = {k: v for k, v in scene.medium.phase_params[1].items() if k != "cdf"}
    med = dataclasses.replace(scene.medium,
                              phase_params=(scene.medium.phase_params[0], tab))
    with pytest.raises(ValueError, match="cdf"):
        from_reference(dataclasses.replace(scene, medium=med), sensor, config, "cpu")


@pytest.fixture
def mono_polarized_single():
    eradiate_tpu.set_mode("mono_polarized_single")
    eradiate_tpu_torch.set_mode("mono_polarized_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def test_polarized_aerosol_compiles_to_tab_polarized(mono_polarized_single):
    """In a polarized mode the dataset's Mueller rows compile to
    ``tab_polarized``: the port's compiled leaves equal the reference's bit
    for bit, ``from_reference`` carries every row of the component bit for
    bit and refuses a component that lacks one."""
    ref_exp, exp = ref_c2(n_vza=3), create_rpv_afgl1986_continental_brfpp(n_vza=3)
    ctx = exp.spectral_context(exp.measures[0])
    ref_scene = ref_exp.compile_scene(ref_exp.measures[0], ctx)
    scene, sensor, config = exp.compile_scene(exp.measures[0], ctx)
    ref, got = _leaves(ref_scene), _leaves((scene, sensor, config))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert config.phase_kinds == ("rayleigh", "tab_polarized") and config.polarized
    tab = ref_scene[0].medium.phase_params[1]
    assert set(tab) == {"mu", "values", "cdf", "m12", "m22", "m33", "m34", "m44", "tg0", "itg"}
    out, _, _ = from_reference(*ref_scene, "cpu")
    for k, v in tab.items():
        np.testing.assert_array_equal(out.medium.phase_params[1][k].numpy(), np.asarray(v))
    med = dataclasses.replace(ref_scene[0].medium, phase_params=(
        ref_scene[0].medium.phase_params[0], {k: v for k, v in tab.items() if k != "m34"}))
    with pytest.raises(ValueError, match="m34"):
        from_reference(dataclasses.replace(ref_scene[0], medium=med), *ref_scene[1:], "cpu")


def test_polarized_c2_matches_reference(mono_polarized_single):
    """Polarized c2 (the aerosol layer as ``tab_polarized``) at 11 view
    zeniths and 256 spp, one seed: I within 1e-5 relative per pixel (the c1
    gate), Q, U and V within 1e-5 of I, the same dataset layout."""
    ref = eradiate_tpu.run(ref_c2(n_vza=11), spp=256, seed_state=SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(create_rpv_afgl1986_continental_brfpp(n_vza=11), spp=256,
                                 seed_state=eradiate_tpu_torch.SeedState(7), device="cpu")
    assert set(out.data_vars) == set(ref.data_vars) and {"I", "Q", "U", "V", "dolp"} <= set(
        out.data_vars)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    stokes, ref_stokes = (np.stack([np.asarray(ds[c]) for c in "IQUV"], -1) for ds in (out, ref))
    assert stokes.shape == (1, 11, 4) and np.isfinite(stokes).all()
    I = ref_stokes[..., 0]
    np.testing.assert_allclose(stokes[..., 0], I, rtol=1e-5, atol=0)
    assert (np.abs(stokes[..., 1:] - ref_stokes[..., 1:]) <= 1e-5 * I[..., None]).all()
    assert np.asarray(out["dolp"]).max() > 0.05
