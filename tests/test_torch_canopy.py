"""The port's canopy pieces against the JAX package, on the CPU.

Inputs come from numpy seeds and cross between the packages as numpy arrays.
Leaf optics, the tau inversion, the box advance, the leaf bounds and the
Morton orderings are held to the reference functions (exact for integers and
orderings, 1e-6 relative otherwise). The plain versions of the four
leaf-sweep kernels are held to the reference's XLA sweeps under ``jax.jit``
(XLA:CPU contracts products and sums into FMAs there, which the plain
versions reproduce) and to its Pallas kernels in interpret mode: ``hit`` and
``occluded`` equal on every lane outside a counted set of edge lanes (at most
0.1 % of the lanes, each with a disk edge or a t gate within a few float32
ulps of the ray), ``t`` within 4 ulp, normals within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import bsdf_ops as ref_bsdf
from eradiate_tpu.ops import canopy as ref_canopy
from eradiate_tpu.ops import medium as ref_medium
from eradiate_tpu.ops import tracer_canopy as ref_tracer_canopy
from eradiate_tpu.ops.pallas import leaf_intersect as ref_pallas
from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.ops import bsdf_ops, canopy, medium, tracer_canopy

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# problems


def cloud(n=700, seed=0, radius=5e-3, leaf_radius=1e-4, center=(0.0, 0.0, 1e-2)):
    """A sphere of leaf disks in km (HET01's crown at a smaller leaf count),
    Morton-ordered."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3))
    pts *= (radius * rng.uniform(0, 1, (n, 1)) ** (1 / 3)) / np.linalg.norm(
        pts, axis=1, keepdims=True
    )
    centers = (pts + np.asarray(center)).astype(np.float32)
    order = canopy.morton_order(centers)
    normals = unit(rng.normal(size=(n, 3)))
    radii = np.full(n, leaf_radius, np.float32)
    return centers[order], normals[order], radii


def crown_rays(B, seed, centers, spread=6e-3):
    """Rays from around the crown in random directions: many hits."""
    rng = np.random.default_rng(seed)
    mid = centers.mean(axis=0)
    p = (mid + rng.uniform(-spread, spread, (B, 3))).astype(np.float32)
    d = unit(rng.normal(size=(B, 3)))
    t_max = rng.uniform(1e-3, 3e-2, B).astype(np.float32)
    return p, d, t_max


def block_problem(B=100, N=300, seed=0):
    """The problem of the reference's own Pallas kernel tests."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    p[:, 2] = 2.0
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d = unit(d)
    t_max = np.full(B, 10.0, dtype=np.float32)
    centers = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    normals = unit(rng.normal(size=(N, 3)))
    radii = rng.uniform(0.05, 0.2, N).astype(np.float32)
    return p, d, t_max, centers, normals, radii


def instanced_problem(n=200, n_inst=6, B=256, seed=7):
    """The problem of the reference's instanced-canopy tests."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(0.5, 3.0, n)
    order = canopy.morton_order(centers)
    normals = unit(rng.normal(size=(n, 3)))
    c, nrm, r = centers[order], normals[order], np.full(n, 0.15, np.float32)
    rng = np.random.default_rng(1)
    off = rng.uniform(-15, 15, (n_inst, 3)).astype(np.float32)
    off[:, 2] = 0.0
    rng = np.random.default_rng(seed)
    anchors = off[rng.integers(0, n_inst, B)]
    p = (anchors + rng.uniform(-2.5, 2.5, (B, 3))).astype(np.float32)
    p[:, 2] = 25.0
    d = 0.06 * rng.normal(size=(B, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d = unit(d)
    return p, d, np.full(B, 100.0, np.float32), c, nrm, r, off


# ---------------------------------------------------------------------------
# comparison with counted edge lanes


def edge_lanes(lanes, p, d, t_max, centers, normals, radii, offsets=None, ulps=4):
    """Of ``lanes``, those where some disk's edge, or a t gate of a disk the
    ray crosses, lies within ``ulps`` float32 ulps (of the coordinates'
    magnitude) of the ray, in float64."""
    p, d, t_max = (np.asarray(x, np.float64) for x in (p, d, t_max))
    c, n, r = (np.asarray(x, np.float64) for x in (centers, normals, radii))
    offs = np.zeros((1, 3)) if offsets is None else np.asarray(offsets, np.float64)
    out = []
    for b in lanes:
        edge = False
        for off in offs:
            pb = p[b] - off
            dn = n @ d[b]
            t = (np.einsum("nj,nj->n", c, n) - n @ pb) / np.where(np.abs(dn) > 1e-12, dn, 1e-12)
            q = pb + d[b] * t[:, None]
            scale = ulps * EPS32 * max(np.abs(pb).max() + np.abs(t_max[b]), np.abs(c).max())
            near_rim = np.abs(np.linalg.norm(q - c, axis=1) - r) <= 2 * scale
            inside = np.linalg.norm(q - c, axis=1) <= r + 2 * scale
            near_gate = inside & (
                (np.abs(t - t_max[b]) <= scale / np.maximum(np.abs(dn), 1e-12))
                | (np.abs(t - 1e-7) <= scale / np.maximum(np.abs(dn), 1e-12))
            )
            in_range = (t > -scale) & (t < t_max[b] + scale)
            edge |= bool(((near_rim & in_range) | near_gate).any())
        if edge:
            out.append(b)
    return out


def assert_ulp(a, b, ulps=4, msg=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    bad = np.abs(a.astype(np.float64) - b.astype(np.float64)) > tol
    assert not bad.any(), f"{msg}: {bad.sum()} of {bad.size} beyond {ulps} ulp"


def assert_nearest(out, ref, problem, offsets=None, ulps=4):
    """``out``/``ref``: (t, normal, hit). Returns the number of edge lanes."""
    t, n, hit = (np.asarray(x) for x in out)
    t_ref, n_ref, hit_ref = (np.asarray(x) for x in ref)
    p, d, t_max, c, nrm, r = problem
    differ = np.flatnonzero(hit != hit_ref)
    assert len(differ) <= 1e-3 * hit.size, f"{len(differ)} of {hit.size} lanes differ in hit"
    assert edge_lanes(differ, p, d, t_max, c, nrm, r, offsets) == list(differ)
    same = hit == hit_ref
    assert_ulp(t[same], t_ref[same], ulps, "t")
    both = hit & hit_ref
    np.testing.assert_allclose(n[both], n_ref[both], rtol=0, atol=1e-6)
    # misses keep t_max and the up normal
    miss = ~hit
    np.testing.assert_array_equal(t[miss], np.asarray(t_max)[miss])
    np.testing.assert_array_equal(n[miss], np.tile([0.0, 0.0, 1.0], (miss.sum(), 1)))
    return len(differ)


def assert_occluded(out, ref, problem, offsets=None):
    out, ref = np.asarray(out), np.asarray(ref)
    p, d, t_max, c, nrm, r = problem
    differ = np.flatnonzero(out != ref)
    assert len(differ) <= 1e-3 * out.size, f"{len(differ)} of {out.size} lanes differ"
    assert edge_lanes(differ, p, d, t_max, c, nrm, r, offsets) == list(differ)
    return len(differ)


def ref_leaves(c, n, r):
    return ref_canopy.LeafCloudArrays(
        centers=jnp.asarray(c), normals=jnp.asarray(n), radii=jnp.asarray(r)
    )


# ---------------------------------------------------------------------------
# leaf optics, medium, ordering


def test_fma_rounds_once():
    """``fma`` is the single rounding of the exact ``a * b + c``: where the
    float64 sum would land on a float32 tie, rounding it again goes wrong
    and round-to-odd does not; on random and cancelling inputs it equals
    exact rational arithmetic."""
    from fractions import Fraction

    a = np.float32(1 + 2.0**-12)
    c = np.float32(2.0**-70)
    exact = np.float32(1 + 2.0**-11 + 2.0**-23)  # just above the tie 1 + 2^-11 + 2^-24
    assert np.float32(np.float64(a) * np.float64(a) + np.float64(c)) != exact
    for sign in (1.0, -1.0):
        out = li.fma(*(torch.tensor([v], dtype=torch.float32) for v in (sign * a, a, sign * c)))
        assert out.item() == sign * exact

    rng = np.random.default_rng(0)
    n = 3000
    a, b = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=n) * 1e-7)).astype(np.float32)
    c[::3] = (rng.normal(size=len(c[::3])) * 1e3).astype(np.float32)
    out = li.fma(T(a), T(b), T(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf))]
        err = [abs(Fraction(float(x)) - exact) for x in cands]
        assert abs(Fraction(float(out[i])) - exact) == min(err), i


@pytest.mark.parametrize("rho, tau", [(0.4957, 0.4409), (0.3, 0.0), (0.0, 0.2), (0.0, 0.0)])
def test_bilambertian_matches(rho, tau):
    rng = np.random.default_rng(1)
    B = 512
    wi, wo = unit(rng.normal(size=(B, 3))), unit(rng.normal(size=(B, 3)))
    u_side = rng.uniform(0, 1, B).astype(np.float32)
    u = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    params = {"reflectance": np.float32(rho), "transmittance": np.float32(tau)}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    f_ref = ref_bsdf.bilambertian_eval(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(wi), jnp.asarray(wo)
    )
    np.testing.assert_allclose(
        bsdf_ops.bilambertian_eval(tparams, T(wi), T(wo)).numpy(), np.asarray(f_ref),
        rtol=1e-6, atol=0,
    )
    w_ref, wt_ref = jax.vmap(
        lambda w, us, uc: ref_bsdf.bilambertian_sample_from_uniforms(
            {k: jnp.asarray(v) for k, v in params.items()}, w, us, uc
        )
    )(jnp.asarray(wo), jnp.asarray(u_side), jnp.asarray(u))
    w_new, weight = bsdf_ops.bilambertian_sample_from_uniforms(tparams, T(wo), T(u_side), T(u))
    assert weight.shape == (B,)
    np.testing.assert_allclose(weight.numpy(), np.asarray(wt_ref), rtol=1e-6, atol=0)
    np.testing.assert_allclose(w_new.numpy(), np.asarray(w_ref), rtol=1e-6, atol=1e-6)


def test_z_at_tau_and_take_1d_match():
    rng = np.random.default_rng(2)
    L = 40
    z_levels = np.linspace(0.0, 120.0, L + 1).astype(np.float32)
    sigma = rng.uniform(0.0, 0.02, L)
    sigma[5:8] = 0.0  # vacuum layers: tau flat
    tau_levels = np.concatenate([[0.0], np.cumsum(sigma * np.diff(z_levels))]).astype(np.float32)
    tau = rng.uniform(0.0, tau_levels[-1], 2000).astype(np.float32)
    tau[:3] = [0.0, tau_levels[-1], tau_levels[10]]
    z_ref, idx_ref = ref_medium.z_at_tau(
        jnp.asarray(tau), jnp.asarray(z_levels), jnp.asarray(tau_levels)
    )
    z, idx = medium.z_at_tau(T(tau), T(z_levels), T(tau_levels))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-6, atol=0)
    table = rng.uniform(0, 1, L).astype(np.float32)
    np.testing.assert_array_equal(
        medium.take_1d(T(table), idx).numpy(),
        np.asarray(ref_medium.take_1d(jnp.asarray(table), idx_ref)),
    )


@pytest.mark.parametrize("n", [1, 17, 2000])
def test_morton_order_matches(n):
    pos = np.random.default_rng(n).uniform(-5e-3, 5e-3, (n, 3))
    np.testing.assert_array_equal(canopy.morton_order(pos), ref_canopy.morton_order(pos))


def test_morton_u32_matches():
    rng = np.random.default_rng(3)
    lo = np.array([-0.05, -0.05, 0.0], np.float32)
    hi = np.array([0.05, 0.05, 0.015], np.float32)
    pos = rng.uniform(-0.06, 0.06, (4096, 3)).astype(np.float32)
    pos[:4] = [lo, hi, [0, 0, 120.0], [0, 0, 0]]
    ref = ref_tracer_canopy._morton_u32(jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(hi))
    out = tracer_canopy._morton_u32(T(pos), T(lo), T(hi))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int64))
    # the orderings agree too (stable sorts of equal codes)
    np.testing.assert_array_equal(
        torch.argsort(out, stable=True).numpy(), np.asarray(jnp.argsort(ref))
    )


def test_leaf_bounds_match():
    p, d, t_max, c, nrm, r, off = instanced_problem()
    flat = canopy.LeafCloudArrays(T(c), T(nrm), T(r))
    inst = canopy.InstancedLeafArrays(flat, T(off))
    ref_flat = ref_leaves(c, nrm, r)
    ref_inst = ref_canopy.InstancedLeafArrays(canonical=ref_flat, offsets=jnp.asarray(off))
    for leaves, ref in ((flat, ref_flat), (inst, ref_inst)):
        for out, exp in zip(canopy.leaf_bounds(leaves), ref_canopy.leaf_bounds(ref)):
            np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


@pytest.mark.parametrize("kind", ["toa", "inside", "miss"])
def test_advance_to_aabb_matches(kind):
    rng = np.random.default_rng(4)
    B = 1000
    lo = np.array([-0.05, -0.05, 0.0], np.float32)
    hi = np.array([0.05, 0.05, 0.015], np.float32)
    if kind == "toa":
        tgt = rng.uniform(-0.05, 0.05, (B, 3)) * [1, 1, 0] + [0, 0, 0.015]
        w = unit(rng.normal(size=(B, 3)) * [1, 1, 0.5] + [0, 0, 1.5])
        t_up = (120.0 - tgt[:, 2]) / np.maximum(w[:, 2], 1e-6)
        p, d = (tgt + w * t_up[:, None]).astype(np.float32), -w
        t_max = rng.uniform(100.0, 400.0, B).astype(np.float32)
    elif kind == "inside":
        p = rng.uniform(lo, hi, (B, 3)).astype(np.float32)
        d = unit(rng.normal(size=(B, 3)))
        d[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0, -1, 0]]  # zero components
        t_max = rng.uniform(1e-3, 1.0, B).astype(np.float32)
    else:
        p = (rng.uniform(-1, 1, (B, 3)) + [3.0, 0, 0]).astype(np.float32)
        d = unit(rng.normal(size=(B, 3)) * 0.1 + [1.0, 0, 0])
        t_max = np.full(B, 50.0, np.float32)
    ref = jax.jit(ref_canopy._advance_to_aabb)(*map(jnp.asarray, (p, d, t_max, lo, hi)))
    out = canopy._advance_to_aabb(*map(T, (p, d, t_max, lo, hi)))
    # bit for bit: the port rounds p + t0 d as XLA:CPU does (x and y fused,
    # z a separate product and sum)
    for o, e in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(e))
    if kind == "miss":
        assert (out[2].numpy() == 0.0).all()


# ---------------------------------------------------------------------------
# K5 / K6: flat sweeps


FLAT_PROBLEMS = {
    "crown": lambda: crown_rays(3000, 11, cloud(700)[0]) + cloud(700),
    "crown-ragged": lambda: crown_rays(1237, 12, cloud(1300, seed=3)[0]) + cloud(1300, seed=3),
    "blocks": block_problem,
    "few-leaves": lambda: block_problem(B=37, N=53, seed=5),
}


@pytest.mark.parametrize("name", list(FLAT_PROBLEMS))
def test_flat_plain_matches_jitted_reference(name):
    problem = FLAT_PROBLEMS[name]()
    p, d, t_max, c, nrm, r = problem
    leaves = ref_leaves(c, nrm, r)
    ref = jax.jit(ref_canopy.ray_leaves_nearest)(*map(jnp.asarray, (p, d, t_max)), leaves)
    out = li.ray_leaves_nearest_plain(*map(T, problem))
    assert_nearest(out, ref, problem)
    assert 0.02 < np.asarray(ref[2]).mean() < 1.0  # hits and misses both occur
    occ_ref = jax.jit(ref_canopy.ray_leaves_occluded)(*map(jnp.asarray, (p, d, t_max)), leaves)
    occ = li.ray_leaves_occluded_plain(*map(T, problem))
    assert_occluded(occ, occ_ref, problem)
    np.testing.assert_array_equal(occ.numpy(), out[2].numpy())


@pytest.mark.parametrize(
    "B, N, block_b, block_n", [(100, 300, 32, 64), (16, 32, 8, 16), (37, 53, 16, 32)]
)
def test_flat_plain_matches_pallas_interpret(B, N, block_b, block_n):
    problem = block_problem(B, N)
    args = tuple(map(jnp.asarray, problem))
    ref = ref_pallas.ray_leaves_nearest_pallas(
        *args, block_b=block_b, block_n=block_n, interpret=True
    )
    out = li.ray_leaves_nearest_plain(*map(T, problem))
    assert_nearest(out, ref, problem)
    occ_ref = ref_pallas.ray_leaves_occluded_pallas(
        *args, block_b=block_b, block_n=block_n, interpret=True
    )
    assert_occluded(li.ray_leaves_occluded_plain(*map(T, problem)), occ_ref, problem)


def test_flat_all_miss_keeps_t_max():
    p, d, t_max, c, nrm, r = block_problem(B=16, N=32)
    d = np.zeros_like(d)
    d[:, 2] = 1.0  # upward: nothing above
    t, n, hit = li.ray_leaves_nearest_plain(*map(T, (p, d, t_max, c, nrm, r)))
    assert not hit.any()
    np.testing.assert_array_equal(t.numpy(), t_max)
    np.testing.assert_array_equal(n.numpy(), np.tile([0.0, 0.0, 1.0], (16, 1)).astype(np.float32))
    assert not li.ray_leaves_occluded_plain(*map(T, (p, d, t_max, c, nrm, r))).any()


@pytest.mark.parametrize("second", [1, 600])
def test_ties_average_inside_a_chunk_and_first_chunk_wins(second):
    """Two coincident disks with opposite normals tie exactly (numerator and
    denominator of t both change sign): inside one 512-leaf chunk the normals
    average, to zero here; in different chunks the first wins."""
    c, nrm, r = cloud(700, seed=8)
    c[second] = c[0]
    r[[0, second]] = 3e-4
    nrm[0] = unit(np.array([0.0, 0.6, 0.8]))
    nrm[second] = -nrm[0]
    B = 64
    rng = np.random.default_rng(9)
    p = (c[0] + [0, 0, 2e-3] + rng.uniform(-1e-4, 1e-4, (B, 3))).astype(np.float32)
    d = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (B, 1))
    t_max = np.full(B, 2.5e-3, np.float32)
    problem = (p, d, t_max, c, nrm, r)
    ref = jax.jit(ref_canopy.ray_leaves_nearest)(
        *map(jnp.asarray, (p, d, t_max)), ref_leaves(c, nrm, r)
    )
    out = li.ray_leaves_nearest_plain(*map(T, problem))
    assert_nearest(out, ref, problem)
    tied = out[2].numpy() & (np.abs(out[0].numpy() - 2e-3) < 1e-4)
    assert tied.sum() > B // 2
    expect = np.zeros(3, np.float32) if second < li.CHUNK else nrm[0]
    np.testing.assert_allclose(out[1].numpy()[tied], np.tile(expect, (tied.sum(), 1)), atol=1e-6)


# ---------------------------------------------------------------------------
# K7: instanced sweeps


@pytest.mark.parametrize("seed", [7, 9])
def test_instanced_plain_matches_jitted_reference(seed):
    p, d, t_max, c, nrm, r, off = instanced_problem(seed=seed)
    problem = (p, d, t_max, c, nrm, r)
    inst = ref_canopy.InstancedLeafArrays(canonical=ref_leaves(c, nrm, r), offsets=jnp.asarray(off))
    ref = jax.jit(ref_canopy._instanced_nearest_xla)(*map(jnp.asarray, (p, d, t_max)), inst)
    out = li.ray_leaves_nearest_instanced_plain(*map(T, problem), T(off))
    assert_nearest(out, ref, problem, off)
    assert np.asarray(ref[2]).sum() > 20

    # the occluded scan lives in leaf_occluded, behind the box advance
    occ_ref = jax.jit(ref_canopy.leaf_occluded)(*map(jnp.asarray, (p, d, t_max)), inst)
    leaves = canopy.InstancedLeafArrays(canopy.LeafCloudArrays(T(c), T(nrm), T(r)), T(off))
    occ = canopy.leaf_occluded(T(p), T(d), T(t_max), leaves)
    assert_occluded(occ, occ_ref, problem, off)
    assert 0 < occ.sum() < p.shape[0]
    near_ref = jax.jit(ref_canopy.leaf_nearest)(*map(jnp.asarray, (p, d, t_max)), inst)
    near = canopy.leaf_nearest(T(p), T(d), T(t_max), leaves)
    assert_nearest(near, near_ref, problem, off, ulps=8)  # t0 + t_loc: one more rounding


@pytest.mark.parametrize("seed", [7, 9])
def test_instanced_plain_matches_pallas_interpret(seed):
    """The Pallas kernels translate the leaves, the XLA form and the port
    the ray: t agrees to the 1e-5 the reference's own test asks."""
    p, d, t_max, c, nrm, r, off = instanced_problem(seed=seed)
    problem = (p, d, t_max, c, nrm, r)
    args = tuple(map(jnp.asarray, problem)) + (jnp.asarray(off),)
    t_ref, n_ref, h_ref = ref_pallas.ray_leaves_nearest_instanced_pallas(
        *args, block_b=256, block_n=256, interpret=True
    )
    t, n, hit = li.ray_leaves_nearest_instanced_plain(*map(T, problem), T(off))
    differ = np.flatnonzero(hit.numpy() != np.asarray(h_ref))
    assert len(differ) <= 1e-3 * p.shape[0]
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-5, atol=1e-6)
    both = hit.numpy()
    np.testing.assert_allclose(n.numpy()[both], np.asarray(n_ref)[both], atol=1e-6)
    occ_ref = ref_pallas.ray_leaves_occluded_instanced_pallas(
        *args, block_b=256, block_n=256, interpret=True
    )
    occ = li.ray_leaves_occluded_instanced_plain(*map(T, problem), T(off))
    assert_occluded(occ, occ_ref, problem, off)


def test_instanced_equals_flattened():
    p, d, t_max, c, nrm, r, off = instanced_problem(seed=5)
    flat_c = (c[None] + off[:, None]).reshape(-1, 3)
    flat = canopy.LeafCloudArrays(
        T(flat_c), T(np.tile(nrm, (len(off), 1))), T(np.tile(r, len(off)))
    )
    inst = canopy.InstancedLeafArrays(canopy.LeafCloudArrays(T(c), T(nrm), T(r)), T(off))
    t_i, n_i, h_i = canopy.leaf_nearest(T(p), T(d), T(t_max), inst)
    t_f, n_f, h_f = canopy.leaf_nearest(T(p), T(d), T(t_max), flat)
    np.testing.assert_array_equal(h_i.numpy(), h_f.numpy())
    np.testing.assert_allclose(t_i.numpy(), t_f.numpy(), rtol=1e-5, atol=1e-6)
    hit = h_i.numpy()
    np.testing.assert_allclose(n_i.numpy()[hit], n_f.numpy()[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        canopy.leaf_occluded(T(p), T(d), T(t_max), inst).numpy(),
        canopy.leaf_occluded(T(p), T(d), T(t_max), flat).numpy(),
    )


# ---------------------------------------------------------------------------
# wrappers


@pytest.mark.parametrize(
    "name", ["ray_leaves_nearest", "ray_leaves_occluded", "ray_leaves_nearest_instanced",
             "ray_leaves_occluded_instanced"]
)
def test_wrapper_runs_plain_version_on_cpu_tensors(name):
    p, d, t_max, c, nrm, r, off = instanced_problem(B=64)
    args = list(map(T, (p, d, t_max, c, nrm, r)))
    if name.endswith("instanced"):
        args.append(T(off))
    before = dict(li.launches)
    out = getattr(li, name)(*args)
    ref = getattr(li, name + "_plain")(*args)
    for o, e in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(o.numpy(), e.numpy())
    assert li.launches == before  # no kernel was launched, so none is counted


def test_wrapper_refuses_other_devices():
    p, d, t_max, c, nrm, r, off = instanced_problem(B=8)
    args = [T(x).to("meta") for x in (p, d, t_max, c, nrm, r)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        li.ray_leaves_nearest(*args)
