"""The port's Mueller calculus, polarized surfaces and Mueller phase blend
against the JAX package, and its collision fetch against the reference's
``z_at_tau``.

Seeded numpy inputs go through the reference's functions op by op (eager
JAX, so that each operation rounds once, as the port's eager PyTorch does;
under ``jit`` XLA:CPU contracts products into FMAs, which the renders'
tests meet) and through the port's on CPU tensors. Every output agrees
within 4 ulp of the array's largest magnitude or 1e-6 relative, whichever
is looser, the two libraries' ``exp``, ``pow``, ``atan2`` and ``erfc``
differing in the last ulp; angles are compared modulo 2 pi. The frames are
also held where they are hardest to keep: forward and backward scattering
(the arbitrary-perpendicular branch) and nadir and zenith bases (the pole
fallback); the surfaces at the hot spot, the specular direction, a zenith
sun and below the horizon.

``tab_polarized``'s phase matrix equals the jitted reference's bit for
bit: its ``jnp.interp`` rounds ``fp[i - 1] + (delta / dx) * df`` once, as
XLA:CPU contracts it, and the port forms it with one fused multiply-add.

The collision fetch's plain twin (what K1 computes on the card) gives the
reference's layer and altitude on the c1 column bit for bit: against an
eager ``z_at_tau`` as it is, and against the jitted one when its
interpolation is rounded as one fused multiply-add, which is how XLA:CPU
contracts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu_torch
from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import bsdf_polarized as ref_bpol
from eradiate_tpu.ops import mueller as ref_mueller
from eradiate_tpu.ops import tracer_polarized as ref_tracer
from eradiate_tpu.ops.medium import z_at_tau
from eradiate_tpu_torch.kernels.collision_fetch import collision_fetch_plain
from eradiate_tpu_torch.kernels.leaf_intersect import fma
from eradiate_tpu_torch.ops import bsdf_ops, bsdf_polarized, mueller, phase_ops
from eradiate_tpu_torch.ops.tracer_polarized import scatter_frames
from eradiate_tpu_torch.test_tools.collision_fetch import column_operands

torch.set_num_threads(1)

N = 4096
EPS32 = float(np.finfo(np.float32).eps)


def close(out, ref, ulps=4, rtol=1e-6):
    """Within ``ulps`` ulp of the largest |ref| or ``rtol`` relative."""
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.isfinite(out).all() == np.isfinite(ref).all()
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=ulps * EPS32 * scale)


def no_worse(port_fn, ref_fn, *inputs, floor_ulps=4, floor_rtol=1e-6):
    """For ill-conditioned formulas (cancellations amplified by a square
    root or an exponential): the port's float32 result is no farther from
    the exact value than twice the reference's float32 result, or within
    the floor (``floor_ulps`` ulp of the largest magnitude or
    ``floor_rtol`` relative). The exact value is the port's formula in
    float64, which must equal the reference's in float64 (the same formula)
    within 1e-9 relative (float64 rounding, amplified by the same
    cancellations). Outputs are tuples of arrays."""
    def run(dtype):
        out = port_fn(*(torch.as_tensor(np.asarray(x, dtype)) for x in inputs))
        with jax.enable_x64(True):
            ref = ref_fn(*(jnp.asarray(np.asarray(x, dtype)) for x in inputs))
            ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
        out = [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]
        return out, ref

    out32, ref32 = run(np.float32)
    out64, ref64 = run(np.float64)
    for o32, r32, o64, r64 in zip(out32, ref32, out64, ref64):
        assert o32.dtype == r32.dtype == np.float32
        scale = float(np.max(np.abs(o64)))
        np.testing.assert_allclose(o64, r64, rtol=1e-9, atol=1e-12 * scale)
        err_port, err_ref = np.abs(o32 - o64), np.abs(r32 - o64)
        floor = np.maximum(floor_ulps * EPS32 * scale, floor_rtol * np.abs(o64))
        bad = err_port > np.maximum(2.0 * err_ref, floor)
        assert not bad.any(), (
            f"{bad.sum()} elements: port error {err_port[bad][:4]}, reference error "
            f"{err_ref[bad][:4]}, exact {o64[bad][:4]}")


def _unit(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _dirs(seed, n=N, upper=False):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _edge_dirs(seed):
    """Random directions with the poles, the horizon and exact forward and
    backward pairs among them: (a, b) with b = a, b = -a on some lanes."""
    a, b = _dirs(seed), _dirs(seed + 1)
    a[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    b[:4] = [[0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 1, 0]]  # forward, back, forward, back
    b[4:64] = a[4:64]
    b[64:128] = -a[64:128]
    return a, b


def _t(x):
    return torch.as_tensor(np.asarray(x))


def close_angle(out, ref):
    """Angles within 4 ulp of pi, modulo 2 pi (+-pi are one rotation)."""
    diff = np.angle(np.exp(1j * (out.numpy().astype(np.float64) - np.asarray(ref))))
    np.testing.assert_allclose(diff, 0.0, atol=4 * EPS32 * np.pi)


@pytest.fixture
def mono_single():
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("kind", ["random", "poles"])
def test_default_basis(kind):
    d = _dirs(1)
    if kind == "poles":
        d[: N // 2] = [0.0, 0.0, 1.0]
        d[N // 2 :] = [0.0, 0.0, -1.0]
        d[1] = [1e-7, 0.0, 1.0]
    ref = ref_mueller.default_basis(jnp.asarray(d))
    out = mueller.default_basis(_t(d))
    close(out, ref)
    # perpendicular to d (near the poles z - d d_z cancels: a few ulp)
    np.testing.assert_allclose((out * _t(d)).sum(-1).numpy(), 0.0, atol=4e-6)


def test_rotator_and_rotation():
    phi = _unit(2, N, -np.pi, np.pi)
    close(mueller.rotator(_t(phi)), ref_mueller.rotator(jnp.asarray(phi)))
    d, _ = _edge_dirs(3)
    b0 = np.asarray(ref_mueller.default_basis(jnp.asarray(d)))
    b1 = np.cross(d, b0)  # the basis rotated by 90 degrees
    b1[::3] = -b0[::3]  # and by 180 degrees
    b1[1::3] = b0[1::3]  # and not at all
    S = _unit(4, (N, 4), -1.0, 1.0)
    close_angle(mueller.rotate_basis_angle(_t(d), _t(b0), _t(b1)),
                ref_mueller.rotate_basis_angle(jnp.asarray(d), jnp.asarray(b0),
                                               jnp.asarray(b1)))
    close(mueller.stokes_rotate_to_basis(_t(S), _t(d), _t(b0), _t(b1)),
          ref_mueller.stokes_rotate_to_basis(
              jnp.asarray(S), jnp.asarray(d), jnp.asarray(b0), jnp.asarray(b1)))


@pytest.mark.parametrize("depol", [0.0, 0.0279, 0.3])
def test_rayleigh_mueller_and_depolarizer(depol):
    c = _unit(5, N, -1.0, 1.0)
    c[:3] = [-1.0, 0.0, 1.0]
    dp = np.full(N, depol, np.float32)
    close(mueller.rayleigh_mueller(_t(c), _t(dp)),
          ref_mueller.rayleigh_mueller(jnp.asarray(c), jnp.asarray(dp)))
    close(mueller.depolarizer(_t(c)), ref_mueller.depolarizer(jnp.asarray(c)))


def test_matrix_products_are_four_term_sums():
    A, B = _unit(6, (N, 4, 4), -1, 1), _unit(7, (N, 4, 4), -1, 1)
    x = _unit(8, (N, 4), -1, 1)
    a64, b64, x64 = (v.astype(np.float64) for v in (A, B, x))
    # each output is the fixed-order float32 sum of its four products
    want = a64[:, :, 0, None] * b64[:, None, 0, :]
    want = want.astype(np.float32)
    for j in range(1, 4):
        want = (want + (A[:, :, j, None] * B[:, None, j, :])).astype(np.float32)
    np.testing.assert_array_equal(mueller.matmul4(_t(A), _t(B)).numpy(), want)
    close(mueller.matmul4(_t(A), _t(B)), np.einsum("bij,bjk->bik", a64, b64).astype(np.float32),
          ulps=8)
    close(mueller.matvec4(_t(A), _t(x)), np.einsum("bij,bj->bi", a64, x64).astype(np.float32),
          ulps=8)


@pytest.mark.parametrize("edge", [False, True])
def test_scatter_frames(edge):
    l_in, l_out = _edge_dirs(9) if edge else (_dirs(9), _dirs(10))
    ref = ref_tracer._scatter_frames(jnp.asarray(l_in), jnp.asarray(l_out))
    out = scatter_frames(_t(l_in), _t(l_out))
    for o, r in zip(out, ref):
        close(o, r)
    # unit, and perpendicular to their directions
    for h, ell in zip(out, (l_in, l_out)):
        np.testing.assert_allclose(torch.linalg.norm(h, dim=-1).numpy(), 1.0, atol=1e-6)
        np.testing.assert_allclose((h * _t(ell)).sum(-1).numpy(), 0.0, atol=1e-6)


def _tab_polarized_params(seed, M=181):
    """A ``tab_polarized`` row as the scene compiles one: a theta-uniform mu
    grid, a normalized m11 (``values``) with its CDF, and random m12 .. m44
    (float32)."""
    rng = np.random.default_rng(seed)
    mu = np.cos(np.linspace(np.pi, 0.0, M))
    values, cdf = phase_ops.tab_phase_tables(mu, 1.0 + 2.0 * (1.0 + mu) ** 3)
    params = {"mu": mu, "values": values, "cdf": cdf}
    params.update({k: rng.uniform(-0.5, 0.5, M) * values for k in ("m12", "m22", "m33", "m34",
                                                                  "m44")})
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


@pytest.mark.parametrize("second", ["rayleigh", "tab", "tab_polarized"])
@pytest.mark.parametrize("depol", [0.0, 0.0279])
def test_phase_mueller_at(depol, second):
    """The Mueller phase blend against the reference's ``_phase_mueller``
    (a Rayleigh component and a second Rayleigh, a tabulated one, which
    enters as a depolarizer, or a tabulated phase matrix, over 6 layers,
    gathered at random layers)."""
    L = 6
    rng = np.random.default_rng(11)
    weights = rng.uniform(0.1, 1.0, (2, L)).astype(np.float32)
    depols = np.stack([np.full(L, depol), rng.uniform(0.0, 0.1, L)]).astype(np.float32)
    layer = rng.integers(0, L, N).astype(np.int32)
    c = _unit(12, N, -1.0, 1.0)
    kinds = ("rayleigh", second)
    mu = np.linspace(-1.0, 1.0, 41)
    values, cdf = phase_ops.tab_phase_tables(mu, 1.0 + 2.0 * (1.0 + mu) ** 3)
    tab = {k: np.asarray(v, np.float32) for k, v in (("mu", mu), ("values", values),
                                                     ("cdf", cdf))}
    if second == "tab_polarized":
        tab = _tab_polarized_params(13)
    params = ({"depol": depols[0]}, {"depol": depols[1]} if second == "rayleigh" else tab)
    ref = (jax.vmap(lambda l, cc: ref_tracer._phase_mueller(
        kinds, tuple({k: jnp.asarray(v) for k, v in p.items()} for p in params),
        jnp.asarray(weights), l, cc)))(jnp.asarray(layer), jnp.asarray(c))
    at = ({"depol": _t(depols[0][layer])},
          {"depol": _t(depols[1][layer])} if second == "rayleigh" else {})
    out = phase_ops.phase_mueller_at(kinds, tuple({k: _t(v) for k, v in p.items()}
                                                  for p in params),
                                     _t(weights.T[layer]), at, _t(c))
    close(out, ref)


def test_tab_polarized_mueller_bitwise():
    """``tab_polarized``'s phase matrix against the jitted reference
    ``_tab_polarized_mueller`` (``jnp.interp`` on each element), bit for
    bit: on random cosines, on both grid ends, on every node and one ulp
    either side of it, and on the nodes of a flat (zero-width) cell."""
    params = _tab_polarized_params(14)
    mu = params["mu"].copy()
    mu[90] = mu[91]  # a zero-width cell: jnp.interp's guard
    params["mu"] = mu
    c = np.concatenate([
        _unit(15, N, -1.0, 1.0), np.float32([-1.0, 1.0]), mu,
        np.nextafter(mu, np.float32(-2.0)), np.nextafter(mu, np.float32(2.0)),
    ]).astype(np.float32)
    ref = jax.jit(ref_tracer._tab_polarized_mueller)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(c))
    out = phase_ops.tab_polarized_mueller({k: _t(v) for k, v in params.items()}, _t(c))
    assert out.shape == (c.size, 4, 4)
    np.testing.assert_array_equal(out.numpy().view(np.int32), np.asarray(ref).view(np.int32))
    assert (out[:, 2, 3] == -out[:, 3, 2]).all() and (out[:, 0, 1] == out[:, 1, 0]).all()


def test_tab_polarized_raises():
    """The split of ``tab_polarized``: the scalar tracers' check refuses it
    by name, the polarized tracers' accepts it, and ``phase_mueller_at``
    computes it (the scalar blend reads its ``tab`` table)."""
    with pytest.raises(NotImplementedError, match="tab_polarized"):
        phase_ops.check_phase_kinds(("rayleigh", "tab_polarized"))
    phase_ops.check_phase_kinds(("rayleigh", "tab_polarized"), polarized=True)
    with pytest.raises(NotImplementedError, match="'mie'"):
        phase_ops.check_phase_kinds(("mie",), polarized=True)
    params = {k: _t(v) for k, v in _tab_polarized_params(16).items()}
    c = _t(_unit(17, 64, -1.0, 1.0))
    m = phase_ops.phase_mueller_at(("tab_polarized",), (params,), torch.ones(64, 1), ({},), c)
    np.testing.assert_array_equal(m.numpy(), phase_ops.tab_polarized_mueller(params, c).numpy())
    scalar = phase_ops.phase_eval_at(("tab_polarized",), (params,), torch.ones(64, 1), ({},), c)
    np.testing.assert_array_equal(scalar.numpy(), phase_ops.tab_eval(params, c).numpy())


MAIGNAN = {"rho_0": 0.183, "k": 0.78, "g": -0.1, "rho_c": 0.183, "C": 5.0, "ndvi": 0.8,
           "refr_re": 1.5, "refr_im": 0.0, "ext_ior": 1.000277}
OCEAN = {"wind_speed": 2.0, "eta": 1.33, "k": 0.0, "ext_ior": 1.000277, "shadowing": 1.0}
SURFACES = {
    "maignan": MAIGNAN,
    "maignan, absorbing": {**MAIGNAN, "refr_im": 0.05, "g": 0.3},
    "ocean_mishchenko": OCEAN,
    "ocean_mishchenko, no shadowing": {**OCEAN, "wind_speed": 10.0, "shadowing": 0.0,
                                       "k": 0.01},
    "lambertian": {"reflectance": 0.37},
    "hapke": {"w": 0.5, "b": 0.3, "c": 0.4, "theta": 0.3, "B_0": 0.5, "h": 0.1},
}


def _tparams(values, like):
    return {k: torch.tensor(v, dtype=like.dtype) for k, v in values.items()}


def _jparams(values, like):
    return {k: jnp.asarray(v, dtype=like.dtype) for k, v in values.items()}


def _surface_dirs(seed):
    wi, wo = _dirs(seed, upper=True), _dirs(seed + 1, upper=True)
    wo[:16] = wi[:16]  # the hot spot and the specular peak's own direction
    wo[16:32] = wi[16:32] * np.float32([-1, -1, 1])  # mirror directions
    wi[32:48] = [0.0, 0.0, 1.0]  # the sun at zenith
    wi[48:64, 2] = -wi[48:64, 2]  # below the horizon
    return wi, wo


@pytest.mark.parametrize("name", list(SURFACES))
def test_surface_mueller(name):
    """The Mueller BRDFs: at the hot spot, the Fresnel peak's tan(gamma) =
    sqrt(1 - cos^2) / cos turns one ulp of cos(gamma) into 3.5e-4 of the
    peak, and the glint's exp(-tan^2(beta) / sigma^2) multiplies the
    relative error of its argument by up to ~50: so the port is held to
    the float64 formula no worse than the reference (:func:`no_worse`)."""
    kind = name.split(",")[0]
    values = SURFACES[name]
    no_worse(
        lambda a, b: bsdf_polarized.surface_mueller(kind, _tparams(values, a), a, b),
        lambda a, b: ref_bpol.surface_mueller(kind, _jparams(values, a), a, b),
        *_surface_dirs(13),
    )
    # the scalar component is the registered scalar eval
    wi, wo = (_t(x) for x in _surface_dirs(13))
    f = bsdf_ops.bsdf_eval(kind, _tparams(values, wi), wi, wo)
    M = bsdf_polarized.surface_mueller(kind, _tparams(values, wi), wi, wo)
    np.testing.assert_array_equal(f.numpy(), M[:, 0, 0].numpy())


@pytest.mark.parametrize("name", ["maignan", "ocean_mishchenko"])
def test_polarized_surface_sampling(name):
    """Cosine-hemisphere continuations with weight f pi, as the reference.
    The glint's weight near the facet normal (tan^2(beta) = (1 - cos^2) /
    cos^2 of a cosine within 1e-2 of 1) moves by 1e-5 relative for one ulp
    of cos(beta), which the two round differently (the half vector's norm):
    the floor is 2e-5 relative."""
    values = SURFACES[name]
    wo, u = _dirs(15, upper=True), _unit(16, (N, 2))
    no_worse(
        lambda a, b: bsdf_ops.bsdf_sample_from_uniforms(name, _tparams(values, a), a, b),
        lambda a, b: ref_bsdf.bsdf_sample_from_uniforms(name, _jparams(values, a), a, b),
        wo, u, floor_rtol=2e-5,
    )


def test_rpv_eval():
    no_worse(
        lambda a, b: bsdf_ops.rpv_eval(_tparams(MAIGNAN, a), a, b),
        lambda a, b: ref_bsdf.rpv_eval(_jparams(MAIGNAN, a), a, b),
        *_surface_dirs(17),
    )


@pytest.mark.parametrize("m", [(1.33, 0.0), (1.5, 0.02), (0.8, 0.0)])
def test_fresnel_elements(m):
    """For an absorbing medium sqrt(mod - Re w) cancels to ~1e-3 of its
    terms, so one ulp there moves c and d by ~1e-4 relative."""
    cos_i = _unit(18, N, 0.0, 1.0)
    cos_i[:2] = [0.0, 1.0]
    no_worse(
        lambda c: bsdf_polarized.fresnel_mueller_elements(
            c, torch.tensor(m[0], dtype=c.dtype), torch.tensor(m[1], dtype=c.dtype)),
        lambda c: ref_bpol.fresnel_mueller_elements(
            c, jnp.asarray(m[0], c.dtype), jnp.asarray(m[1], c.dtype)),
        cos_i,
    )


def test_scalar_tracers_keep_their_surface_kinds():
    """Every tracer takes the reference's surface kinds, the polarized
    surfaces' scalar (I-I) components among them; the polarized tracers
    give those two their Mueller matrices and depolarize the rest; an
    unknown kind raises ``ValueError`` naming it, as the reference's
    dispatch does."""
    assert bsdf_ops.SUPPORTED_BSDFS == ref_bsdf.SUPPORTED_BSDFS
    assert {"maignan", "ocean_mishchenko", "rpv", "rtls"} <= set(bsdf_ops.SUPPORTED_BSDFS)
    assert bsdf_ops.POLARIZED_SURFACES == ref_bpol.POLARIZED_SURFACES
    with pytest.raises(ValueError, match="'no_such_kind'"):
        bsdf_ops.bsdf_eval("no_such_kind", _tparams(MAIGNAN, _t(_dirs(1))), _t(_dirs(1)),
                           _t(_dirs(2)))


@pytest.mark.parametrize("rounding", ["eager", "jit"])
def test_k1_twin_gives_z_at_tau(mono_single, rounding):
    """The collision fetch's twin against the reference's ``z_at_tau`` on the
    c1 column: seeded queries over the column, every level and one ulp
    either side, 0 and the top."""
    z_levels, tau_levels, tables = column_operands()
    rng = np.random.default_rng(19)
    q = np.concatenate([
        rng.uniform(0.0, tau_levels[-1], 60_000).astype(np.float32),
        tau_levels, np.nextafter(tau_levels, np.float32(np.inf)),
        np.nextafter(tau_levels, np.float32(-np.inf))[1:], [0.0],
    ]).astype(np.float32)
    z_twin, layer, _ = collision_fetch_plain(_t(q), _t(z_levels), _t(tau_levels), _t(tables))
    fn = z_at_tau if rounding == "eager" else jax.jit(z_at_tau)
    z_ref, layer_ref = fn(jnp.asarray(q), jnp.asarray(z_levels), jnp.asarray(tau_levels))
    np.testing.assert_array_equal(layer.numpy(), np.asarray(layer_ref))
    if rounding == "jit":
        # the same bracket and fraction, the interpolation as one FMA
        i = layer.long()
        t0, t1 = _t(tau_levels)[i], _t(tau_levels)[i + 1]
        z0, z1 = _t(z_levels)[i], _t(z_levels)[i + 1]
        frac = torch.clamp((_t(q) - t0) / torch.clamp(t1 - t0, min=1e-30), 0.0, 1.0)
        z_twin = fma(frac, z1 - z0, z0)
    # XLA:CPU flushes subnormal results to zero: the query one ulp above 0
    # lands at a subnormal z, 0 in the reference
    z_twin = torch.where(z_twin.abs() < np.finfo(np.float32).tiny, 0.0, z_twin)
    np.testing.assert_array_equal(z_twin.numpy().view(np.int32),
                                  np.asarray(z_ref).view(np.int32))
