"""The spherical-shell primitives of the port against the JAX package.

The reference functions run under ``jax.jit``, as the reference tracer runs
them: XLA:CPU then contracts products and sums into fused multiply-adds,
which the port's plain functions reproduce (``ops/spherical.py``). Stated
tolerances:

- ``ray_sphere_intersect``: bitwise.
- ``slant_tau_exact``: the blocked lanes exactly; elsewhere 8 ulp (the
  reference sums the shells in float32 in XLA's order, the port in float64
  in level order).
- The shell-flight twin (K2) against ``_shell_flight_xla``: ``collide`` and
  ``layer`` equal except on near-tie lanes, whose query lies within the
  reference's hi/lo-bf16 prefix error (~2^-17 of the column depth) of a
  level; those are found in float64, counted and bounded. ``t_col`` within
  2e-3 km (the same prefix error divided by the shell's extinction).
- The shell-event twin (K3) against the XLA ``shell_event``: as K2, and
  ``tau_sun`` within 8 ulp where ``t_col`` is equal, within 1e-3 relative
  elsewhere (``t_col`` moves the event point).
- Against the Pallas kernels in interpret mode: the tolerances of
  ``tests/unit/test_shell_flight_pallas.py`` (``slant_tau_pallas``: the
  blocked lanes exactly, elsewhere 5e-2 absolute and 2e-2 relative, the
  float32 noise floor of near-tangent rays).
- ``sun_tau_table_grid``: 2e-6 relative (float32 against float64
  contraction over the shells). ``sun_tau_fetch_fast``: within 1e-6
  relative of a float64 bilinear at the same cell location, and within the
  reference's bf16 radius weights (``2^-8`` of the cell's values) plus the
  float32 cell location and rounding of the reference.
- ``fetch_at_index``: bitwise. ``hapke_eval``: 2e-5 relative (torch's and
  XLA's tan, exp, log and atan2 differ in the last ulp); at grazing
  directions within 2e-5 of the reference's jitted or its eager value.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import medium as ref_medium
from eradiate_tpu.ops import spherical as ref
from eradiate_tpu.ops.pallas.shell_flight import (
    shell_event_pallas,
    shell_flight_pallas,
    slant_tau_pallas,
)
from eradiate_tpu_torch.kernels import shell_flight as sf
from eradiate_tpu_torch.ops import bsdf_ops, medium, spherical

torch.set_num_threads(1)

R_EARTH = 6378.1
B = 700


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, order="C")) for a in arrays]


def _shells(L=200, vacuum=False):
    """``tests/unit/test_shell_flight_pallas.py`` ``make_shells`` column;
    ``vacuum`` zeroes every third shell and a run of ten."""
    radii = np.linspace(R_EARTH, R_EARTH + 120.0, L + 1).astype(np.float32)
    sigma = (np.exp(-np.linspace(0, 120, L) / 8.5) * 0.01).astype(np.float32)
    if vacuum:
        sigma[::3] = 0.0
        sigma[L // 2 : L // 2 + 10] = 0.0
    return radii, sigma


def _lanes(radii, seed, kind):
    """Lane states as ``make_shells`` draws them; ``kind`` picks the
    directions and flight caps:

    - ``random``: isotropic directions, t_max uniform in [0.1, 300] km;
    - ``exit``: isotropic, t_max the boundary-exit distance (tracer contract);
    - ``steep``: near-nadir descending rays (tangent below the ground), with
      t_max 200 km (``TestShellFlightGroundAnchor``).
    """
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(R_EARTH + 1e-3, R_EARTH + 119.9, B)
    theta = rng.uniform(0, np.pi / 6, B)
    phi = rng.uniform(0, 2 * np.pi, B)
    p = np.stack(
        [r0 * np.sin(theta) * np.cos(phi), r0 * np.sin(theta) * np.sin(phi), r0 * np.cos(theta)],
        axis=1,
    ).astype(np.float32)
    if kind == "steep":
        d = np.stack(
            [rng.uniform(-0.05, 0.05, B), rng.uniform(-0.05, 0.05, B), -np.ones(B)], axis=1
        )
    else:
        d = rng.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if kind == "random":
        t_max = rng.uniform(0.1, 300.0, B).astype(np.float32)
    elif kind == "steep":
        t_max = np.full(B, 200.0, np.float32)
    else:
        tgn, _, hit = ref.ray_sphere_intersect(p, d, radii[0])
        _, ttf, _ = ref.ray_sphere_intersect(p, d, radii[-1])
        t_ground = np.where(np.asarray(hit) & (np.asarray(tgn) > 1e-4), tgn, np.inf)
        t_max = np.minimum(t_ground, np.maximum(np.asarray(ttf), 1e-4)).astype(np.float32)
    tau_s = rng.exponential(0.3, B).astype(np.float32)
    return p, d, t_max, tau_s


CASES = {
    "random": (200, False, "random"),
    "exit": (200, False, "exit"),
    "vacuum": (200, True, "random"),
    "vacuum-exit": (200, True, "exit"),
    "steep": (232, False, "steep"),
    "steep-vacuum": (232, True, "steep"),
}

W_SUN = np.array([0.3, 0.1, 0.9486833], np.float32)
W_SUN /= np.linalg.norm(W_SUN)


def _case(name):
    L, vacuum, kind = CASES[name]
    radii, sigma = _shells(L, vacuum)
    return (radii, sigma, *_lanes(radii, seed=L + len(name), kind=kind))


@pytest.fixture(params=sorted(CASES), scope="module")
def case(request):
    return _case(request.param)


def _near_ties(radii, sigma, p, d, t_max, tau_s, rel=2.0**-14):
    """Lanes whose collide decision or inverted depth lies within ``rel``
    of the column depth of a decision boundary, evaluated in float64."""
    p, d, radii, sigma = (np.asarray(a, np.float64) for a in (p, d, radii, sigma))
    x0 = np.sum(p * d, axis=1)
    b2 = np.sum(np.cross(p, d) ** 2, axis=1)
    X = np.sqrt(np.maximum(radii[None, :] ** 2 - b2[:, None], 0.0))
    G = np.concatenate([np.zeros((p.shape[0], 1)), np.cumsum(sigma * np.diff(X, axis=1), 1)], 1)
    L = sigma.size

    def G_at(y):
        k = np.clip((X <= y[:, None]).sum(1) - 1, 0, L - 1)
        rows = np.arange(p.shape[0])
        return G[rows, k] + sigma[k] * np.maximum(y - X[rows, k], 0.0)

    desc = x0 < 0.0
    A = G_at(np.abs(x0))
    x_max = x0 + t_max
    Gm = G_at(np.abs(x_max))
    tau_max = np.where(desc, np.where(x_max < 0.0, A - Gm, A + Gm), Gm - A)
    v = np.where(desc & (tau_s < A), A - tau_s, np.where(desc, tau_s - A, A + tau_s))
    eps = rel * np.maximum(G[:, -1], 1e-30)
    near_collide = np.abs(tau_s - tau_max) <= eps
    near_level = np.min(np.abs(G - v[:, None]), axis=1) <= eps
    return near_collide | near_level


def _flight_ref(radii, sigma, p, d, t_max, tau_s):
    out = jax.jit(ref._shell_flight_xla)(p, d, t_max, radii, sigma, tau_s)
    return [np.asarray(o) for o in out]


def _check_decisions(got, want, ties):
    """collide equal, and layer equal on colliding lanes, except on near
    ties; returns the lanes where everything agrees."""
    bad = (got[0] != want[0]) | ((got[2] != want[2]) & want[0])
    assert np.all(ties[bad]), f"{int((bad & ~ties).sum())} lanes differ away from a tie"
    assert bad.sum() <= max(2, B // 200), f"{int(bad.sum())} near-tie lanes differ"
    return ~bad


def test_ray_sphere_intersect_bitwise(case):
    radii, _, p, d, *_ = case
    for radius in (radii[0], radii[-1]):
        want = jax.jit(ref.ray_sphere_intersect)(p, d, radius)
        got = spherical.ray_sphere_intersect(*_t(p, d), torch.tensor(radius))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("zenith", [0.0, 60.0, 85.0, 95.0])
def test_slant_tau_exact(zenith):
    radii, sigma = _shells()
    p, *_ = _lanes(radii, seed=11, kind="random")
    w = np.array([np.sin(np.deg2rad(zenith)), 0.0, np.cos(np.deg2rad(zenith))], np.float32)
    want = np.asarray(jax.jit(ref._slant_tau_exact_xla)(p, w, radii, sigma))
    got = spherical.slant_tau_exact(*_t(p, w, radii, sigma)).numpy()
    blocked = want == ref.TAU_BLOCKED
    np.testing.assert_array_equal(got == spherical.TAU_BLOCKED, blocked)
    assert _ulps(got[~blocked], want[~blocked]).max() <= 8


@pytest.mark.parametrize("zenith", [0.0, 60.0, 85.0, 95.0])
def test_slant_tau_exact_matches_pallas_interpret(zenith):
    # TestSlantTauPallas: x0 and b2 formed outside the kernel, as the
    # reference's dispatch forms them
    radii, sigma = _shells()
    p, *_ = _lanes(radii, seed=11, kind="random")
    w = np.array([np.sin(np.deg2rad(zenith)), 0.0, np.cos(np.deg2rad(zenith))], np.float32)
    x0 = jnp.einsum("bj,j->b", p, w)
    b2 = jnp.sum(jnp.cross(p, jnp.broadcast_to(w, p.shape)) ** 2, axis=-1)
    want = np.asarray(slant_tau_pallas(x0, b2, radii, sigma, block_b=256, interpret=True))
    got = sf.slant_tau(*_t(p, w, radii, sigma)).numpy()
    blocked = want >= ref.TAU_BLOCKED / 2
    np.testing.assert_array_equal(got == spherical.TAU_BLOCKED, blocked)
    assert blocked.any() == (zenith > 80.0)
    np.testing.assert_allclose(got[~blocked], want[~blocked], atol=5e-2, rtol=2e-2)


def test_slant_tau_at_the_event_point_is_the_event_twins(case):
    """Flight, then the slant depth from the event point formed with one
    fused multiply-add per component: what the event twin fuses, bit for
    bit (the ``lr_flight`` branch of the tracer against the exact NEE)."""
    radii, sigma, p, d, t_max, tau_s = case
    args = _t(p, d, t_max, radii, sigma, tau_s)
    w = torch.from_numpy(W_SUN)
    collide, t_col, layer, tau_sun = sf.shell_event_plain(*args, w)
    col2, t2, lay2 = sf.shell_flight(*args)
    assert torch.equal(col2, collide) and torch.equal(t2, t_col) and torch.equal(lay2, layer)
    p_event = spherical.fma(args[1], torch.where(collide, t_col, args[2])[:, None], args[0])
    assert torch.equal(sf.slant_tau(p_event, w, args[3], args[4]), tau_sun)


def test_flight_twin_matches_xla(case):
    radii, sigma, p, d, t_max, tau_s = case
    want = _flight_ref(radii, sigma, p, d, t_max, tau_s)
    got = [o.numpy() for o in sf.shell_flight_plain(*_t(p, d, t_max, radii, sigma, tau_s))]
    assert got[2].dtype == np.int32
    assert got[2].min() >= 0 and got[2].max() <= sigma.size - 1
    agree = _check_decisions(got, want, _near_ties(radii, sigma, p, d, t_max, tau_s))
    both = agree & want[0]
    assert both.any()
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=0, atol=2e-3)
    assert np.all(got[1] <= t_max)


def test_event_twin_matches_xla(case):
    radii, sigma, p, d, t_max, tau_s = case
    want = [
        np.asarray(o)
        for o in jax.jit(ref.shell_event)(p, d, t_max, radii, sigma, tau_s, W_SUN)
    ]
    got = [o.numpy() for o in sf.shell_event_plain(*_t(p, d, t_max, radii, sigma, tau_s, W_SUN))]
    agree = _check_decisions(got, want, _near_ties(radii, sigma, p, d, t_max, tau_s))
    blocked = want[3] == ref.TAU_BLOCKED
    np.testing.assert_array_equal((got[3] == spherical.TAU_BLOCKED)[agree], blocked[agree])
    ok = agree & ~blocked
    same_t = ok & (got[1] == want[1])
    assert same_t.sum() > B // 2
    assert _ulps(got[3][same_t], want[3][same_t]).max() <= 8
    np.testing.assert_allclose(got[3][ok], want[3][ok], rtol=1e-3, atol=0)


@pytest.mark.parametrize("name", ["random", "exit", "steep"])
def test_flight_twin_matches_pallas_interpret(name):
    # the Pallas test file's own inputs: make_shells lanes with random caps
    # (TestShellFlightPallas), with boundary-exit caps
    # (TestShellFlightExitClipped) and steep descents toward the ground
    # (TestShellFlightGroundAnchor, which checks collide and t_col only)
    radii, sigma, p, d, t_max, tau_s = _case(name)
    x0 = jnp.sum(p * d, axis=-1)
    b2 = jnp.sum(jnp.cross(p, d) ** 2, axis=-1)
    col_p, t_p, lay_p = map(
        np.asarray,
        shell_flight_pallas(
            x0, b2, t_max, tau_s, jnp.asarray(radii) ** 2, sigma, block_b=256, interpret=True
        ),
    )
    col, t_col, layer = (o.numpy() for o in sf.shell_flight_plain(*_t(p, d, t_max, radii, sigma, tau_s)))
    np.testing.assert_array_equal(col, col_p)
    both = col & col_p
    if name != "steep":
        np.testing.assert_array_equal(layer[both], lay_p[both])
    np.testing.assert_allclose(t_col[both], t_p[both], atol=1e-2)


@pytest.mark.parametrize("name", ["exit", "vacuum-exit"])
def test_event_twin_matches_pallas_interpret(name):
    # the fused Pallas event kernel assumes the tracer contract: t_max is
    # the boundary-exit distance (``TestShellEventFused``)
    radii, sigma, p, d, t_max, tau_s = _case(name)
    w = jnp.broadcast_to(W_SUN, p.shape)
    col_p, t_p, lay_p, tau_p = map(
        np.asarray,
        shell_event_pallas(
            jnp.sum(p * d, axis=-1),
            jnp.sum(jnp.cross(p, d) ** 2, axis=-1),
            t_max,
            tau_s,
            jnp.sum(p * w, axis=-1),
            jnp.sum(d * w, axis=-1),
            jnp.sum(jnp.cross(p, w) ** 2, axis=-1),
            jnp.asarray(radii) ** 2,
            sigma,
            block_b=256,
            interpret=True,
        ),
    )
    col, t_col, layer, tau = (
        o.numpy() for o in sf.shell_event_plain(*_t(p, d, t_max, radii, sigma, tau_s, W_SUN))
    )
    np.testing.assert_array_equal(col, col_p)
    both = col & col_p
    np.testing.assert_array_equal(layer[both], lay_p[both])
    np.testing.assert_allclose(t_col[both], t_p[both], rtol=1e-3, atol=1e-2)
    blk = tau > 1e9
    np.testing.assert_array_equal(blk, tau_p > 1e9)
    np.testing.assert_allclose(tau[~blk], tau_p[~blk], rtol=5e-2, atol=2e-3)


def test_ties_go_to_the_last_equal_level():
    """Queries exactly at the levels of a prefix with flat runs (vacuum
    shells) bracket to the last equal level, as the count ``#{G <= v} - 1``
    does. A ray from the centre along +z has x0 = 0 and b = 0, so it
    inverts ``v = tau_s`` against ``G = cumsum(sigma dr)``."""
    radii = np.array([6378.0, 6379.0, 6380.0, 6381.0, 6382.0, 6383.0], np.float32)
    sigma = np.array([0.5, 0.0, 0.0, 0.25, 0.0], np.float32)
    G = np.concatenate([[0.0], np.cumsum(sigma * np.diff(radii))]).astype(np.float32)
    tau_s = np.concatenate([G, [0.1, 0.6]]).astype(np.float32)
    n = tau_s.size
    p = np.zeros((n, 3), np.float32)
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    t_max = np.full(n, 1e4, np.float32)
    _, _, layer = sf.shell_flight_plain(*_t(p, d, t_max, radii, sigma, tau_s))
    want = np.clip(np.searchsorted(G, tau_s, side="right") - 1, 0, sigma.size - 1)
    np.testing.assert_array_equal(layer.numpy(), want)
    np.testing.assert_array_equal(layer.numpy(), [0, 3, 3, 3, 4, 4, 0, 3])


def _table_inputs():
    radii, sigma = _shells(232)
    mu_np, warp = spherical.sun_mu_grid_warped(128)
    r_grid = np.linspace(radii[0], radii[-1], 128).astype(np.float32)
    return radii, sigma[None], r_grid, mu_np.astype(np.float32), warp


def test_sun_mu_grid_warped_matches():
    got, warp = spherical.sun_mu_grid_warped(128)
    want, warp_ref = ref.sun_mu_grid_warped(128)
    np.testing.assert_array_equal(got, want)
    assert warp == warp_ref


def test_sun_tau_table_grid():
    radii, sigma, r_grid, mu, _ = _table_inputs()
    want = np.asarray(ref.sun_tau_table_grid(sigma, radii, r_grid, mu, r_ground=0.0))
    got = spherical.sun_tau_table_grid(*_t(sigma, radii, r_grid, mu), r_ground=0.0).numpy()
    assert got.shape == want.shape == (1, 128, 128)
    # the reference contracts the 232 shells in float32, the port in float64
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    # with the ground in: the same blocked cells
    want_b = np.asarray(ref.sun_tau_table_grid(sigma, radii, r_grid, mu))
    got_b = spherical.sun_tau_table_grid(*_t(sigma, radii, r_grid, mu)).numpy()
    np.testing.assert_array_equal(got_b == spherical.TAU_BLOCKED, want_b == ref.TAU_BLOCKED)


def test_sun_tau_fetch_fast():
    radii, sigma, r_grid, mu_grid, warp = _table_inputs()
    table = np.asarray(ref.sun_tau_table_grid(sigma, radii, r_grid, mu_grid, r_ground=0.0))[0]
    rng = np.random.default_rng(5)
    n = 4000
    r = rng.uniform(r_grid[0] - 0.5, r_grid[-1] + 0.5, n).astype(np.float32)
    mu = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    mu[:200] = rng.uniform(-0.3, 0.1, 200)  # the terminator band
    r[:128], mu[:128] = r_grid, mu_grid  # the nodes
    got = spherical.sun_tau_fetch_fast(*_t(table, r_grid), warp, *_t(r, mu)).numpy()
    want = np.asarray(ref.sun_tau_fetch_fast(table, r_grid, warp, r, mu))

    # the port's float32 cell location, then the bilinear in float64
    Nr, M = table.shape
    mu_c, s, a, b = warp
    rt, r0, r1 = _t(r, r_grid[:1], r_grid[-1:])
    fz = torch.clamp((rt - r0) * ((Nr - 1.0) / (r1 - r0)), 0.0, Nr - 1.0).numpy()
    x = (torch.from_numpy(mu) - mu_c) * (1.0 / s)
    ft = torch.clamp((torch.asinh(x) - a) * (1.0 / (b - a)) * (M - 1.0), 0.0, M - 1.0).numpy()
    ir = np.clip(fz.astype(np.int64), 0, Nr - 2)
    im = np.clip(ft.astype(np.int64), 0, M - 2)
    fr, fm = (fz - ir).astype(np.float64), (ft - im).astype(np.float64)
    t = table.astype(np.float64)
    t00, t10, t01, t11 = t[ir, im], t[ir + 1, im], t[ir, im + 1], t[ir + 1, im + 1]
    bilinear = (1 - fm) * ((1 - fr) * t00 + fr * t10) + fm * ((1 - fr) * t01 + fr * t11)
    np.testing.assert_allclose(got, bilinear, rtol=1e-6, atol=1e-12)

    # the reference rounds the two radius weights to bf16 (8 bits: 2^-9
    # relative each) and locates the cell with its own float32 asinh (up to
    # 2.5e-5 of a cell here, as the port's)
    rows = np.maximum.reduce([t00, t10, t01, t11])
    steps = np.abs(t10 - t00) + np.abs(t11 - t01) + np.abs(t01 - t00) + np.abs(t11 - t10)
    bound = 2.0**-8 * rows + 4e-5 * steps + 4 * np.finfo(np.float32).eps * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


def test_fetch_at_index_bitwise():
    rng = np.random.default_rng(2)
    tables = rng.uniform(0, 1, (4, 232)).astype(np.float32)
    idx = rng.integers(0, 232, 1000).astype(np.int32)
    idx[:2] = 0, 231
    want = ref_medium.fetch_at_index(jnp.asarray(idx), [jnp.asarray(t) for t in tables])
    got = medium.fetch_at_index(*_t(idx, tables))
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want]))


def _hemisphere(rng, n):
    """Unit directions of the upper hemisphere, with grazing ones mixed in."""
    mu = rng.uniform(0.0, 1.0, n)
    mu[: n // 8] = rng.uniform(0.0, 2e-3, n // 8)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - mu * mu)
    return np.stack([s * np.cos(phi), s * np.sin(phi), mu], axis=1).astype(np.float32)


def _assert_hapke_close(got, want, eager, wi, wo, rtol=2e-5):
    """2e-5 relative where both directions stand above 0.01 in cosine.
    Grazing ones make the roughness terms ill-conditioned (tan, cot and
    cos_phi from cancelling products): there the reference's own jitted
    and eager evaluations differ by up to 10x, so the port must agree
    within 2e-5 with one of the two."""
    close = lambda a: np.abs(got - a) <= rtol * np.abs(a)  # noqa: E731
    steep = (wi[..., 2] > 1e-2) & (wo[..., 2] > 1e-2)
    assert np.all(close(want)[steep])
    assert np.all((close(want) | close(eager))[~steep])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hapke_eval(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    wi, wo = _hemisphere(rng, n), _hemisphere(rng, n)
    wo[:100] = wi[:100]  # exact backscatter
    wo[100:150] = wi[100:150] * np.array([-1.0, -1.0, 1.0], np.float32)  # specular
    wi[150:170, 2] = -0.1  # below the horizon
    params = {
        "w": rng.uniform(0.05, 0.95),
        "b": rng.uniform(0.05, 0.9),
        "c": rng.uniform(0.0, 1.0),
        "theta": rng.uniform(0.0, np.deg2rad(45)),
        "B_0": rng.uniform(0.0, 1.0),
        "h": [0.0, 0.05, 0.3][seed],
    }
    params = {k: np.float32(v) for k, v in params.items()}
    want = np.asarray(
        jax.jit(ref_bsdf.hapke_eval)({k: jnp.asarray(v) for k, v in params.items()}, wi, wo)
    )
    eager = np.asarray(
        ref_bsdf.hapke_eval({k: jnp.asarray(v) for k, v in params.items()}, *map(jnp.asarray, (wi, wo)))
    )
    got = bsdf_ops.hapke_eval({k: torch.tensor(v) for k, v in params.items()}, *_t(wi, wo))
    got = got.numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    _assert_hapke_close(got, want, eager, wi, wo)
    # and through the dispatch used by the tracer
    f = bsdf_ops.bsdf_eval("hapke", {k: torch.tensor(v) for k, v in params.items()}, *_t(wi, wo))
    np.testing.assert_array_equal(f.numpy(), got)


def test_hapke_sample_weight_is_f_pi():
    rng = np.random.default_rng(4)
    wo = _hemisphere(rng, 500)
    u = rng.uniform(0, 1, (500, 2)).astype(np.float32)
    params = {"w": 0.5, "b": 0.2, "c": 0.5, "theta": np.deg2rad(30.0), "B_0": 0.0, "h": 0.0}
    params = {k: np.float32(v) for k, v in params.items()}
    def sample(wo, u):
        return ref_bsdf.bsdf_sample_from_uniforms("hapke", params, wo, u)

    w_ref, wt_ref = map(np.asarray, jax.jit(sample)(wo, u))
    _, wt_eager = map(np.asarray, sample(jnp.asarray(wo), jnp.asarray(u)))
    w_new, wt = bsdf_ops.bsdf_sample_from_uniforms(
        "hapke", {k: torch.tensor(v) for k, v in params.items()}, *_t(wo, u)
    )
    # cosine-hemisphere directions: a few ulp of their unit components
    np.testing.assert_allclose(w_new.numpy(), w_ref, rtol=0, atol=1e-6)
    _assert_hapke_close(wt.numpy(), wt_ref, wt_eager, w_ref, wo)


def test_wrappers_run_the_twins_on_cpu(case):
    radii, sigma, p, d, t_max, tau_s = case
    args = _t(p, d, t_max, radii, sigma, tau_s)
    before = dict(sf.launches)
    for got, want in zip(sf.shell_flight(*args), sf.shell_flight_plain(*args)):
        assert torch.equal(got, want)
    w = torch.from_numpy(W_SUN)
    for got, want in zip(sf.shell_event(*args, w), sf.shell_event_plain(*args, w)):
        assert torch.equal(got, want)
    assert torch.equal(
        sf.slant_tau(args[0], w, args[3], args[4]),
        spherical.slant_tau_exact(args[0], w, args[3], args[4]),
    )
    assert sf.launches == before  # no kernel launch for CPU tensors
    assert set(before) == {"shell_flight", "shell_event", "slant_tau", "shell_depths"}


def _args(L=8, n=16):
    radii = torch.linspace(6378.0, 6398.0, L + 1)
    return dict(
        p=torch.zeros(n, 3),
        d=torch.zeros(n, 3),
        t_max=torch.zeros(n),
        tau_s=torch.zeros(n),
        radii=radii,
        sigma=torch.zeros(L),
        w_sun=torch.zeros(3),
    )


def _bad(kind):
    a = _args()
    if kind == "dtype":
        a["t_max"] = a["t_max"].double()
    elif kind == "non-contiguous":
        a["p"] = torch.zeros(3, 16).T
    elif kind == "radii-shape":
        a["radii"] = torch.zeros(5)
    elif kind == "lanes-shape":
        a["tau_s"] = torch.zeros(15)
    elif kind == "w-shape":
        a["w_sun"] = torch.zeros(4)
    elif kind == "shared-memory":
        a = _args(L=sf.SMEM_BYTES // 8 + 1)
    return a


def _check(a):
    lanes = {k: a[k] for k in ("p", "d", "t_max", "tau_s")}
    return sf._check("shell_event", lanes, a["radii"], a["sigma"], a["w_sun"])


@pytest.mark.parametrize(
    "kind, exc",
    [
        ("dtype", TypeError),
        ("non-contiguous", ValueError),
        ("radii-shape", ValueError),
        ("lanes-shape", ValueError),
        ("w-shape", ValueError),
        ("shared-memory", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(kind, exc):
    assert _check(_args()) == (16, 8)  # the unmodified inputs pass
    with pytest.raises(exc):
        _check(_bad(kind))


@pytest.mark.parametrize("kind", ["dtype", "non-contiguous", "radii-shape", "w-shape"])
def test_slant_tau_wrapper_rejects_bad_inputs(kind):
    a = _args()
    assert sf._check("slant_tau", {"p": a["p"]}, a["radii"], a["sigma"], a["w_sun"]) == (16, 8)
    a = _bad(kind)
    if kind == "dtype":  # slant_tau takes no t_max: the points carry the bad dtype
        a["p"] = a["p"].double()
    with pytest.raises(TypeError if kind == "dtype" else ValueError):
        sf._check("slant_tau", {"p": a["p"]}, a["radii"], a["sigma"], a["w_sun"])


def test_wrappers_reject_other_devices():
    a = {k: v.to("meta") for k, v in _args().items()}
    with pytest.raises(ValueError):
        sf.shell_flight(a["p"], a["d"], a["t_max"], a["radii"], a["sigma"], a["tau_s"])
    with pytest.raises(ValueError):
        sf.shell_event(
            a["p"], a["d"], a["t_max"], a["radii"], a["sigma"], a["tau_s"], a["w_sun"]
        )
    with pytest.raises(ValueError):
        sf.slant_tau(a["p"], a["w_sun"], a["radii"], a["sigma"])
