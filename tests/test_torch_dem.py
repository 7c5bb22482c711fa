"""The port's terrain operations (``eradiate_tpu_torch.ops.dem``) against the
JAX package's, on the CPU.

Both packages get the same numpy grids and rays, made from a seed: the 33 x
33 gaussian hill the render tests use (heights 0-1 km) and a 9 x 9 plateau
of heights 40-60 km, on which a vertical ray from a post starts exactly on
the terrain (``1e-6`` km is below half an ulp there, so the first sample's
height above the terrain is 0). The stress set holds random rays, rays
from off the grid, from grid lines and posts, grazing and vertical rays,
rays starting on the terrain and tiny ``t_max``. The reference's functions
run under ``jax.jit``, as they run inside its renders.

- ``dem_height``, ``dem_normal``, ``mesh_from_dem``: bit for bit, float32
  and float64 (the reference under x64).
- ``dem_intersect``: ``hit`` equal on every lane, ``t_hit`` bit for bit on
  at least 99.9% of lanes and the rest within one march step (today every
  lane is bit for bit).
- The blocked march (blocks of 1, 7, 32 and 128 steps, with its cull of the
  lanes that cannot cross) equals a step-at-a-time loop over every lane bit
  for bit; the any-hit form's answer equals the nearest form's ``hit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import dem as ref_dem
from eradiate_tpu.scenes.surface import DEMSurface as RefSurface
from eradiate_tpu_torch.ops import dem
from eradiate_tpu_torch.ops.scene_state import dem_from_reference

torch.set_num_threads(1)

HILL = dict(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33)
N_MARCH = 128


def grid(name):
    """``(heights, x0, y0, dx, dy)`` of a test terrain."""
    if name == "hill":
        s = RefSurface.gaussian_hill(**HILL)
        return s.elevation, s.x0, s.y0, s.dx, s.dy
    h = np.random.default_rng(11).uniform(40.0, 60.0, (9, 9))
    return h, -2.0, -2.0, 0.5, 0.5


def both(name, dtype):
    """The terrain as the reference's and the port's ``DemArrays``."""
    h, x0, y0, dx, dy = grid(name)
    ref = ref_dem.DemArrays(*(jnp.asarray(v, dtype=dtype) for v in (h, x0, y0, dx, dy)))
    return ref, dem_from_reference(h, x0, y0, dx, dy, "cpu", dtype)


def stress_rays(name, dtype, n=4096):
    """``(p [B, 3], d [B, 3], t_max [B])`` of the stress set over a terrain."""
    h, x0, y0, dx, dy = grid(name)
    ny, nx = h.shape
    rng = np.random.default_rng(5)
    x1, y1 = x0 + (nx - 1) * dx, y0 + (ny - 1) * dy
    lo, hi = h.min(), h.max()

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    sets = []
    # random rays above and through the terrain's range
    p = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n),
                  rng.uniform(lo - 0.2, hi + 2.0, n)], -1)
    sets.append((p, unit(rng.normal(size=(n, 3))), rng.uniform(0.01, 30.0, n)))
    # from off the grid, toward it
    p = np.stack([rng.uniform(x0 - 5, x1 + 5, n), rng.choice([y0 - 3, y1 + 3], n),
                  rng.uniform(lo, hi + 3.0, n)], -1)
    d = unit(np.stack([rng.normal(size=n), -np.sign(p[:, 1]), -rng.uniform(0, 1, n)], -1))
    sets.append((p, d, rng.uniform(1.0, 300.0, n)))
    # on grid lines and posts, vertical and slanted
    i, j = rng.integers(0, nx, n), rng.integers(0, ny, n)
    px = x0 + i * dx
    py = np.where(rng.uniform(size=n) < 0.5, y0 + j * dy, rng.uniform(y0, y1, n))
    z_post = h[j, np.clip(i, 0, nx - 1)]
    d = np.where((rng.uniform(size=n) < 0.5)[:, None], [[0.0, 0.0, -1.0]],
                 unit(rng.normal(size=(n, 3))))
    sets.append((np.stack([px, py, z_post + rng.uniform(0.0, 1.0, n)], -1), d,
                 rng.uniform(0.1, 5.0, n)))
    # starting on the terrain: posts exactly, vertical rays up and down
    d = np.where((rng.uniform(size=n) < 0.5)[:, None], [[0.0, 0.0, -1.0]], [[0.0, 0.0, 1.0]])
    sets.append((np.stack([x0 + i * dx, y0 + j * dy, h[j, i]], -1), d, np.full(n, 2.0)))
    # grazing rays skimming the terrain, long (shadow-like) flights
    phi = rng.uniform(0, 2 * np.pi, n)
    mu = rng.uniform(-0.02, 0.05, n)
    d = np.stack([np.cos(phi) * np.sqrt(1 - mu**2), np.sin(phi) * np.sqrt(1 - mu**2), mu], -1)
    p = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n),
                  rng.uniform(lo, hi + 0.05, n)], -1)
    sets.append((p, d, rng.uniform(50.0, 400.0, n)))
    # tiny t_max
    p = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n),
                  rng.uniform(lo, hi, n)], -1)
    sets.append((p, unit(rng.normal(size=(n, 3))), 10.0 ** rng.uniform(-7, -3, n)))
    p, d, t = (np.concatenate(x).astype(dtype) for x in zip(*sets))
    return p, d, t


def bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def T(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(params=[np.float32, np.float64], ids=["float32", "float64"])
def dtype(request):
    """The grid's and rays' dtype; the reference runs under x64 for float64."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", request.param == np.float64)
    try:
        yield request.param
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("name", ["hill", "plateau"])
def test_height_and_normal_bitwise(name, dtype):
    ref, port = both(name, dtype)
    p, _, _ = stress_rays(name, dtype)
    x, y = p[:, 0], p[:, 1]
    want_h = jax.jit(ref_dem.dem_height)(ref, jnp.asarray(x), jnp.asarray(y))
    want_n = jax.jit(ref_dem.dem_normal)(ref, jnp.asarray(x), jnp.asarray(y))
    got_h = dem.dem_height(port, *T(x, y))
    got_n = dem.dem_normal(port, *T(x, y))
    assert got_h.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(bits(got_h.numpy()), bits(want_h))
    np.testing.assert_array_equal(bits(got_n.numpy()), bits(want_n))


def test_mesh_from_dem_bitwise(dtype):
    h, x0, y0, dx, dy = grid("hill")
    want = ref_dem.mesh_from_dem(h, x0, y0, dx, dy, dtype=dtype)
    got = dem.mesh_from_dem(h, x0, y0, dx, dy, dtype=dtype)
    assert got.v0.shape == (2 * 32 * 32, 3)
    for k in ("v0", "e1", "e2"):
        np.testing.assert_array_equal(bits(getattr(got, k).numpy()), bits(getattr(want, k)))


@pytest.mark.parametrize("name", ["hill", "plateau"])
def test_intersect_against_reference(name, dtype):
    ref, port = both(name, dtype)
    p, d, t_max = stress_rays(name, dtype)
    f = jax.jit(ref_dem.dem_intersect, static_argnames=("n_march", "n_bisect"))
    want_t, want_hit = (np.asarray(a) for a in f(ref, *(jnp.asarray(a) for a in (p, d, t_max))))
    got_t, got_hit = dem.dem_intersect(port, *T(p, d, t_max))
    got_t, got_hit = got_t.numpy(), got_hit.numpy()
    assert 0.1 < want_hit.mean() < 0.9
    np.testing.assert_array_equal(got_hit, want_hit)
    same = bits(got_t) == bits(want_t)
    assert same.mean() >= 0.999
    step = (t_max * 1.02 + 1e-4) / N_MARCH
    assert np.all(np.abs(got_t - want_t)[~same] <= step[~same])
    assert same.all()  # the port rounds every lane as XLA:CPU does today


def step_loop(port, p, d, t_max, n_march=N_MARCH, n_bisect=16):
    """The reference's march as a step-at-a-time loop over every lane (no
    cull), then its bisection, on the port's rounding of the point's
    height above the terrain."""
    dt = dem._step(t_max, n_march)
    B = p.shape[0]

    def sdf(t):
        return dem._sdf(port, p, d, t[:, None]).squeeze(1)

    s0 = sdf(torch.full((B,), 1e-6, dtype=p.dtype))
    t_lo = torch.zeros_like(dt)
    t_hi = torch.zeros_like(dt)
    found = torch.zeros(B, dtype=torch.bool)
    for k in range(n_march):
        t = dt * (k + 1)
        cross = ~found & (torch.sign(sdf(t)) != torch.sign(s0)) & (s0 != 0.0)
        t_hi = torch.where(cross, t, t_hi)
        t_lo = torch.where(cross, t - dt, t_lo)
        found = found | cross
    for _ in range(n_bisect):
        mid = 0.5 * (t_lo + t_hi)
        same = torch.sign(sdf(mid)) == torch.sign(s0)
        t_lo = torch.where(same, mid, t_lo)
        t_hi = torch.where(same, t_hi, mid)
    return torch.where(found, 0.5 * (t_lo + t_hi), t_max), found, s0


@pytest.mark.parametrize("name", ["hill", "plateau"])
def test_blocked_march_equals_step_loop(name):
    _, port = both(name, np.float32)
    p, d, t_max = T(*stress_rays(name, np.float32, n=1024))
    want_t, want_hit, s0 = step_loop(port, p, d, t_max)
    if name == "plateau":
        assert (s0 == 0).sum() > 100  # rays that start exactly on the terrain
    for block in (1, 7, 32, 128):
        got_t, got_hit = dem.dem_intersect(port, p, d, t_max, block=block)
        np.testing.assert_array_equal(got_hit.numpy(), want_hit.numpy())
        np.testing.assert_array_equal(bits(got_t.numpy()), bits(want_t.numpy()))
        occ = dem.dem_occluded(port, p, d, t_max, block=block)
        np.testing.assert_array_equal(occ.numpy(), want_hit.numpy())


def test_lanes_restrict_the_march():
    """Lanes left out of ``lanes`` miss; the others are unchanged."""
    _, port = both("hill", np.float32)
    p, d, t_max = T(*stress_rays("hill", np.float32, n=512))
    lanes = torch.from_numpy(np.random.default_rng(2).uniform(size=p.shape[0]) < 0.5)
    t_all, hit_all = dem.dem_intersect(port, p, d, t_max)
    t_some, hit_some = dem.dem_intersect(port, p, d, t_max, lanes=lanes)
    np.testing.assert_array_equal(hit_some.numpy(), (hit_all & lanes).numpy())
    np.testing.assert_array_equal(t_some.numpy(), torch.where(lanes, t_all, t_max).numpy())
    occ = dem.dem_occluded(port, p, d, t_max, lanes=lanes)
    np.testing.assert_array_equal(occ.numpy(), (hit_all & lanes).numpy())
