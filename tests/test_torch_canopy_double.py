"""The port's leaf canopy in the double modes against the JAX package under
x64, on the CPU.

The port renders a leaf canopy with float64 path state in ``mono_double``
and ``mono_polarized_double`` (and their aliases), as the JAX package does
with ``jax_enable_x64`` on, which these tests switch on around each
reference call and off again in a ``finally``. The reference's canopy must
not be rendered in a single mode under x64: its accumulators default to
float64 there and its loop carries change type (a ``TypeError``).

- ``fma`` of float64 tensors is the correctly rounded ``a b + c`` on random
  and hard operands (ties, cancellation, overflow edges, signed zeros),
  held to exact rational arithmetic; float32 operands keep their single
  rounding; mixed dtypes raise.
- The float64 plain versions of the leaf sweeps (K5, K6 and the K7 pair)
  against the reference's XLA sweeps jitted under x64 (``ray_leaves_nearest``,
  ``ray_leaves_occluded``, ``_instanced_nearest_xla``, the instance scan of
  ``leaf_occluded``): equal on every lane of the random, rim, grazing and
  tie problems (so within any float64 ulp gate), the tie table's three-
  and four-way ties included, whose normals the reference sums in index
  order.
- The float64 kernels' twins: the cull on float64 items with float32 boxes
  is conservative (every accepted disk lies in a reached leaf, with the cap
  ``t_max`` and with its own ``t``), and the order-free tie rule gives the
  dense sweep's result bit for bit in any visit order.
- ``compile_canopy_scene`` in ``mono_double`` gives the reference's arrays
  under x64 bit for bit, float64 each.
- Same-seed renders of the small HET01 of ``test_torch_canopy_experiment.py``
  (200 leaves at three positions under a Rayleigh atmosphere), instanced
  and flat, in ``mono_double`` and ``mono_polarized_double``: the lane gate
  of ``test_torch_spherical_double.py`` (at most two of the 640 lanes
  beyond 1e-10 relative, every other lane and the pixels' sums over them
  within 1e-10) and every pixel within |z| <= 5. None is beyond: the leaf
  sample's float32 cosine-hemisphere direction rounds as XLA's
  (``fastmath.cosine_hemisphere_xla``); rounded as torch's, some lanes
  leave the gate.
- A double mode renders a canopy with triangles (an ``abstract_tree``'s
  trunks) in float64 (``test_torch_tri_double.py`` holds it against the
  reference).
"""

from fractions import Fraction
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.ops import canopy as ref_canopy
from eradiate_tpu.ops import tracer_canopy as ref_tc
from eradiate_tpu.ops import tracer_canopy_polarized as ref_tcp
from eradiate_tpu.ops.scene_state import IlluminationArrays as RefIllumination
from eradiate_tpu.ops.scene_state import MediumArrays as RefMedium
from eradiate_tpu.ops.tracer import lane_partition as ref_lane_partition
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops import canopy
from eradiate_tpu_torch.ops.scene_state import canopy_from_reference, from_reference
from eradiate_tpu_torch.ops.tracer import lane_partition, row_key
from eradiate_tpu_torch.ops.tracer_canopy import lane_rays, trace_paths_canopy_regen
from eradiate_tpu_torch.ops.tracer_canopy_polarized import trace_paths_canopy_polarized_regen
from eradiate_tpu_torch.test_tools.disks import (
    axis_rays,
    grazing_rays,
    instanced_tie_disks,
    random_disks,
    rim_rays,
    zero_normal_disks,
)
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.scenes import biosphere as ref_bio
from eradiate_tpu_torch import CanopyAtmosphereExperiment
from eradiate_tpu_torch.scenes import biosphere as bio
from test_torch_canopy_experiment import N_VZA, kwargs
from test_torch_experiment import _leaves

torch.set_num_threads(1)

RTOL = 1e-10
SPP = 128
F64 = np.float64


@pytest.fixture
def x64():
    """The reference under x64 for the test; both packages' modes reset."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")


def T(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def J(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the float64 fused multiply-add


def _rn(x):
    """The float64 nearest to a Fraction, +-inf beyond the range."""
    try:
        return float(x)
    except OverflowError:
        return math.inf if x > 0 else -math.inf


def _fma_cases():
    rng = np.random.default_rng(0)
    n = 4000
    a = rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)
    b = rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, n)
    c = -(a * b) * (1 + rng.normal(size=n) * 1e-15)  # cancellation
    c[::3] = rng.normal(size=len(c[::3])) * 10.0 ** rng.integers(-9, 9, len(c[::3]))
    big = np.finfo(np.float64).max
    hard = []
    for s in (1.0, -1.0):
        # a b = 1 + 2^-23 + 2^-30 + 2^-53: a float64 tie, broken only by c
        for cc in (0.0, -0.0, 2.0**-200, -(2.0**-200), 2.0**-80, -(2.0**-80)):
            hard.append((s * (1 + 2.0**-30), 1 + 2.0**-23, s * cc))
        hard.append((s * (1 + 2.0**-27), 1 + 2.0**-26, 0.0))
        hard.append((s * (1 + 2.0**-52), 1 - 2.0**-53, -s))  # -2^-105 exactly
    hard += [
        (big, 1.5, -big), (big, 2.0, -big), (big, 1.0, big), (2.0**1000, 2.0**23, -(2.0**1023)),
        (1e308, 10.0, -1e308), (1e200, 1e200, 1.0), (2.0**600, 2.0**420, -(2.0**1019)),
        (1e-200, 1e-200, 1.0), (1e-200, 1e-200, -0.0), (-1e-200, 1e-200, 0.0), (3.0, 1e-310, 1e-300),
        (0.0, 5.0, -0.0), (-0.0, 5.0, -0.0), (-1.0, 0.0, -0.0), (1.0, 1.0, -1.0), (-0.0, -0.0, -0.0),
        (0.1, 10.0, -1.0), (1.0 / 3.0, 3.0, -1.0),
    ]
    h = np.array(hard).T
    return np.concatenate([a, h[0]]), np.concatenate([b, h[1]]), np.concatenate([c, h[2]])


def test_fma_float64_is_exactly_rounded():
    """Every case: the float64 nearest to the exact ``a b + c`` (an exact
    zero with IEEE's sign: ``a b + c`` of the exact product where it is
    zero, +0 after cancellation)."""
    a, b, c = _fma_cases()
    out = li.fma(*T(a, b, c))
    assert out.dtype == torch.float64
    out = out.numpy()
    for i in range(a.size):
        exact = Fraction(a[i]) * Fraction(b[i]) + Fraction(c[i])
        if exact != 0:
            want = _rn(exact)
        else:
            want = a[i] * b[i] + c[i] if (a[i] == 0 or b[i] == 0) else 0.0
        assert out[i] == want and np.signbit(out[i]) == np.signbit(want), (i, a[i], b[i], c[i])
    # infinite and NaN operands as IEEE's fma
    big = np.finfo(F64).max
    edge = li.fma(*T(np.array([np.inf, np.inf, big, 1.0]), np.array([2.0, 0.0, big, np.nan]),
                     np.array([1.0, 1.0, -np.inf, 1.0])))
    assert edge[0] == np.inf and edge[1].isnan() and edge[2] == -np.inf and edge[3].isnan()


def test_fma_float32_unchanged_and_mixed_dtypes_raise():
    """float32 operands: the single rounding of the exact sum, as before;
    a float64 operand beside float32 ones raises."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=2000).astype(np.float32) for _ in range(2))
    c = (-(a.astype(F64) * b) * (1 + rng.normal(size=2000) * 1e-7)).astype(np.float32)
    out = li.fma(*T(a, b, c))
    assert out.dtype == torch.float32
    for i in range(0, 2000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf))]
        best = min(cands, key=lambda x: abs(Fraction(float(x)) - exact))
        assert out[i].item() == best
    with pytest.raises(TypeError, match="float32 or all float64"):
        li.fma(*T(a.astype(F64), b, c))


# ---------------------------------------------------------------------------
# the float64 plain versions against the reference's XLA sweeps under x64


def _problem(name):
    """``(p, d, t_max, c, n, r)`` float64, and the offsets of an instanced
    problem (else None)."""
    rng = np.random.default_rng(hash(name) % 2**32)
    if name == "ties":
        (c, n, r), offs, rays = instanced_tie_disks(rng, 700, dtype=F64)
        return (*rays, c, n, r), offs
    c, n, r = random_disks(rng, 700)
    if name == "zero normals":
        n = zero_normal_disks(rng, n, share=1.0)
    make = {"rims": rim_rays, "far": lambda *a, **k: rim_rays(*a, distance=100.0, **k),
            "grazing": grazing_rays, "zero normals": axis_rays}[name]
    return (*make(rng, 900, c, n, r, dtype=F64), c, n, r), None


def _instanced(name):
    rng = np.random.default_rng(7)
    c, n, r = random_disks(rng, 600)
    offs = np.stack([rng.uniform(-6, 6, 4), rng.uniform(-6, 6, 4), np.zeros(4)], axis=1)
    if name == "ties":
        return _problem("ties")
    p, d, t_max = rim_rays(rng, 900, c, n, r, offsets=offs, dtype=F64)
    return (p, d, t_max, c, n, r), offs


def _same(out, ref):
    """Bit for bit, dtypes included (a -0.0 is not a +0.0)."""
    for o, e in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple)
                    else (ref,)):
        o, e = np.asarray(o), np.asarray(e)
        assert o.dtype == e.dtype and o.shape == e.shape
        if o.dtype == F64:
            o, e = o.view(np.int64), e.view(np.int64)
        assert (o == e).all(), f"{int((o != e).sum())} of {o.size} differ"


@pytest.mark.parametrize("name", ["rims", "far", "grazing", "zero normals", "ties"])
def test_flat_plain_f64_matches_jitted_reference(x64, name):
    """K5/K6's float64 twins against the jitted x64 sweeps: every lane."""
    problem, _ = _problem(name)
    p, d, t_max, c, n, r = problem
    leaves = ref_canopy.LeafCloudArrays(*J(c, n, r))
    ref = jax.jit(ref_canopy.ray_leaves_nearest)(*J(p, d, t_max), leaves)
    out = li.ray_leaves_nearest_plain(*T(*problem))
    _same(out, ref)
    hit = out[2].numpy()
    assert 0.1 < hit.mean() and (hit.mean() < 1.0 or name == "ties")  # the tie rays all hit
    occ_ref = jax.jit(ref_canopy.ray_leaves_occluded)(*J(p, d, t_max), leaves)
    _same(li.ray_leaves_occluded_plain(*T(*problem)), occ_ref)
    if name == "ties":
        # the quad tie (n, n, n, -n): the reference's index-order sum, which
        # an exact sum would miss
        v = n[6]
        quad = np.asarray(ref[1])[np.arange(p.shape[0]) % 7 == 4]
        at_quad = (quad == (((v + v) + v) - v) / 4).all(axis=1)
        assert at_quad.any() and not (quad[at_quad] == v / 2).all(axis=1).any()


@pytest.mark.parametrize("name", ["rims", "ties"])
def test_instanced_plain_f64_matches_jitted_reference(x64, name):
    """The K7 pair's float64 twins against ``_instanced_nearest_xla`` and
    the instance scan of ``leaf_occluded`` (and ``leaf_nearest`` behind the
    box advance) jitted under x64: every lane."""
    problem, offs = _instanced(name)
    p, d, t_max, c, n, r = problem
    inst = ref_canopy.InstancedLeafArrays(canonical=ref_canopy.LeafCloudArrays(*J(c, n, r)),
                                          offsets=jnp.asarray(offs))
    ref = jax.jit(ref_canopy._instanced_nearest_xla)(*J(p, d, t_max), inst)
    out = li.ray_leaves_nearest_instanced_plain(*T(*problem, offs))
    _same(out, ref)
    assert out[2].numpy().sum() > 100
    leaves = canopy.InstancedLeafArrays(canopy.LeafCloudArrays(*T(c, n, r)), *T(offs))
    _same(canopy.leaf_occluded(*T(p, d, t_max), leaves),
          jax.jit(ref_canopy.leaf_occluded)(*J(p, d, t_max), inst))
    _same(canopy.leaf_nearest(*T(p, d, t_max), leaves),
          jax.jit(ref_canopy.leaf_nearest)(*J(p, d, t_max), inst))


# ---------------------------------------------------------------------------
# the float64 kernels' twins: cull and tie rule


@pytest.mark.parametrize("name", ["rims", "far", "grazing", "zero normals"])
def test_cull_is_conservative_f64(name):
    """Float64 disks in a hierarchy of float32 boxes, tested with the ray
    rounded to float32 and the cap rounded up: every disk the dense float64
    sweep accepts lies in a leaf reached with the cap ``t_max`` and in one
    reached with the cap at its own ``t``."""
    problem, _ = _problem(name)
    p, d, t_max, c, n, r = T(*problem)
    bvh = li.leaf_bvh(c, n, r)
    assert bvh.disks.dtype == torch.float64 and bvh.nodes.dtype == torch.float32
    row_leaf = torch.from_numpy(bvh_mod.leaf_of_row(bvh, c.shape[0]))
    index = torch.tensor(bvh_mod.row_index(bvh.disks))
    leaf = torch.empty_like(row_leaf)
    leaf[index] = row_leaf  # the leaf of each original disk
    t_all = li._chunk_hits(p, d, c, n, r, t_max)
    accepted = torch.isfinite(t_all)
    assert accepted.any(dim=1).sum() >= p.shape[0] // 8
    reached = li.bvh_leaves_reached_plain(p, d, t_max, bvh)
    assert not (accepted & ~reached[:, leaf]).any()
    lanes, disk = torch.nonzero(accepted, as_tuple=True)
    own = li.bvh_leaves_reached_plain(p[lanes], d[lanes], t_all[lanes, disk], bvh)
    assert own[torch.arange(lanes.shape[0]), leaf[disk]].all()
    assert reached.float().mean() < 0.2  # the cull culls


def test_tie_rule_f64_does_not_depend_on_the_visit_order():
    """The float64 twins of the flat and instanced kernels on the float64
    tie table (two-, three- and four-way ties inside a chunk, ties across
    chunks and instances) equal the dense sweeps bit for bit in leaf order
    and in a shuffled order."""
    problem, offs = _problem("ties")
    p, d, t_max, c, n, r = T(*problem)
    bvh = li.leaf_bvh(c, n, r)
    dense = li.ray_leaves_nearest_plain(p, d, t_max, c, n, r)
    order = np.random.default_rng(5).permutation(c.shape[0])
    for o in (None, order):
        _same(li.ray_leaves_nearest_bvh_plain(p, d, t_max, bvh, o), dense)
    o = T(offs)[0]
    ibvh = li.leaf_instanced_bvh(c, n, r, o)
    assert ibvh.instances.dtype == torch.float64
    dense = li.ray_leaves_nearest_instanced_plain(p, d, t_max, c, n, r, o)
    order = np.random.default_rng(6).permutation(len(offs) * c.shape[0])
    for o_ in (None, order):
        _same(li.ray_leaves_nearest_instanced_bvh_plain(p, d, t_max, ibvh, o_), dense)


def test_f64_wrappers_on_the_cpu_and_refusals():
    """float64 CPU tensors run the plain versions and count no launch, the
    leaf sweeps' and the triangle sweeps'; mixed dtypes raise."""
    problem, offs = _instanced("rims")
    args = T(*problem)
    before = (dict(li.launches), dict(li.launches_f64), dict(ti.launches), dict(ti.launches_f64))
    _same(li.ray_leaves_nearest(*args), li.ray_leaves_nearest_plain(*args))
    _same(li.ray_leaves_occluded_instanced(*args, *T(offs)),
          li.ray_leaves_occluded_instanced_plain(*args, *T(offs)))
    named = {"p": args[0], "d": args[1], "t_max": args[2], "centers": args[3],
             "normals": args[4].float(), "radii": args[5]}
    with pytest.raises(TypeError):
        li._check("ray_leaves_nearest", named, args[0].shape[0], args[3].shape[0], None)
    with pytest.raises(TypeError):
        li.leaf_instanced_bvh(*args[3:], T(offs)[0].float())
    # a float64 triangle: the ray at the first lane's target hits it
    v0 = torch.tensor([[-1.0, -1.0, 0.0]], dtype=torch.float64)
    e1 = torch.tensor([[4.0, 0.0, 0.0]], dtype=torch.float64)
    e2 = torch.tensor([[0.0, 4.0, 0.0]], dtype=torch.float64)
    p = torch.tensor([[0.25, 0.5, 1.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float64)
    t_max = torch.tensor([2.0], dtype=torch.float64)
    t, n, hit = ti.ray_tris_nearest(p, d, t_max, v0, e1, e2)
    assert t.dtype == n.dtype == torch.float64 and hit.all() and t.item() == 1.0
    assert n.tolist() == [[0.0, 0.0, 1.0]]
    _same(ti.ray_tris_occluded_instanced(p, d, t_max, v0, e1, e2, torch.zeros((2, 3),
                                         dtype=torch.float64)),
          np.array([True]))
    assert (li.launches, li.launches_f64, ti.launches, ti.launches_f64) == before
    with pytest.raises(TypeError, match="float32 or all float64"):
        ti.ray_tris_nearest(p, d, t_max, v0.float(), e1, e2)
    named = {"p": p, "d": d, "t_max": t_max.float(), "v0": v0, "e1": e1, "e2": e2}
    with pytest.raises(TypeError):
        ti._check("ray_tris_nearest", named, 1, 1, None)


# ---------------------------------------------------------------------------
# the experiment in the double modes


def _compiled(mode_id, split, ref):
    """The small HET01 under its atmosphere, instanced or ``split`` into two
    elements (flattened), its first measure's ``compile_canopy_scene`` in
    ``mode_id`` (the reference's under x64); a polarized mode takes the
    polarized integrator, as ``bench.py``'s c5."""
    pkg, cls = (eradiate_tpu, RefCanopyAtmosphere) if ref else (eradiate_tpu_torch,
                                                                 CanopyAtmosphereExperiment)
    pkg.set_mode(mode_id)
    kw = kwargs(ref_bio if ref else bio, True, split)
    if pkg.mode().is_polarized:
        kw["integrator"] = {"type": "volpath", "stokes": True}
    exp = cls(**kw)
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


@pytest.mark.parametrize("split", [False, True], ids=["instanced", "flat"])
def test_compile_canopy_scene_bitwise_under_x64(x64, split):
    out = _leaves(_compiled("mono_double", split, False)[:5])
    ref = _leaves(_compiled("mono_double", split, True)[:5])
    assert out.keys() == ref.keys()
    floats = 0
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
            floats += v.dtype == F64
        else:
            assert out[k] == v, k
    assert floats >= 12
    assert any(k.endswith("centers") and v.dtype == F64 for k, v in out.items())


def _row0(x):
    x = jnp.asarray(x)
    return x[0] if x.ndim else x


def _ref_lanes(compiled, spp, seed):
    """Per-lane sums of the reference's regenerative canopy trace (its
    ``_render_row_canopy``'s, jitted; row 0, chunk 0), with the triangles of
    the compiled canopy where it has any: ``(sums [B] or [B, 4], m2
    [B])``."""
    scene, sensor, config, leaf_params, leaves, tris, tri_params = compiled
    n_pix = sensor.directions.shape[0]
    trace = (ref_tcp.trace_paths_canopy_polarized_regen if config.polarized
             else ref_tc.trace_paths_canopy_regen)

    def lanes(med, surface, il, leaf_params, leaves, tris, tri_params, directions, target, ext,
              key):
        medium_row = RefMedium(
            z_levels=med.z_levels, tau_levels=med.tau_levels[0], albedo=med.albedo[0],
            phase_weights=med.phase_weights[0],
            phase_params=jax.tree_util.tree_map(lambda x: x[0], med.phase_params))
        surface_row = jax.tree_util.tree_map(lambda x: x[0], surface)
        illum_row = RefIllumination(direction=il.direction, irradiance=il.irradiance[0],
                                    cos_cutoff=il.cos_cutoff, sky_radiance=_row0(il.sky_radiance),
                                    position=il.position)
        leaf_row = {k: v[0] for k, v in leaf_params.items()}
        _, pix, _, lane_first, quota = ref_lane_partition(n_pix, spp)
        w_v = directions[pix]
        B = pix.shape[0]
        tgt = jnp.broadcast_to(target, (B, 3))
        t_up = (medium_row.z_levels[-1] - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6)
        tri_row = None if tri_params is None else {k: v[0] for k, v in tri_params.items()}
        return trace(config, medium_row, surface_row, leaf_row, leaves, illum_row,
                     tgt + w_v * t_up[:, None], -w_v, key, lane_first, quota,
                     ext=jnp.broadcast_to(ext, (B, 2)), tris=tris, tri_row=tri_row)

    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 0), 0)
    return [np.asarray(x) for x in jax.jit(lanes)(
        scene.medium, scene.surface, scene.illumination, leaf_params, leaves, tris, tri_params,
        jnp.asarray(sensor.directions), jnp.asarray(sensor.target),
        jnp.asarray(sensor.target_extent), key)]


def _port_lanes(compiled, spp, seed):
    """The port's per-lane sums as :func:`_ref_lanes`, on the CPU."""
    scene, sensor, config, leaf_params, leaves, tris, tri_params = compiled
    dt = np.asarray(scene.medium.tau_levels).dtype
    scene, sensor, config = from_reference(scene, sensor, config, "cpu")
    leaves, leaf_params, tris, tri_params = canopy_from_reference(
        leaves, leaf_params, "cpu", tris, tri_params, dt)
    from eradiate_tpu_torch.ops.tracer import row_arrays

    medium_row, surface_row, illum_row = row_arrays(scene, 0)
    leaf_row = {k: v[0] for k, v in leaf_params.items()}
    n_pix = sensor.directions.shape[0]
    _, pix, _, lane_first, quota = lane_partition(n_pix, spp, 2**14, "cpu")
    init_pos, init_d, ext = lane_rays(medium_row, sensor.directions, sensor.target,
                                      sensor.ray_offset, sensor.target_extent, pix)
    trace = (trace_paths_canopy_polarized_regen if config.polarized
             else trace_paths_canopy_regen)
    tri_row = None if tri_params is None else {k: v[0] for k, v in tri_params.items()}
    out = trace(config, medium_row, surface_row, leaf_row, leaves, illum_row, init_pos, init_d,
                row_key(seed, 0, 0, "cpu"), lane_first, quota, ext=ext, tris=tris,
                tri_row=tri_row)
    return [o.numpy() for o in out[:2]]


def canopy_lane_gate(out, ref, spp, max_spread=2, max_flips=1):
    """The float64 lane gate of ``test_torch_spherical_double.py`` on
    per-lane sums (``_port_lanes``, ``_ref_lanes``): at most ``max_spread``
    lanes beyond 1e-10 relative in I and ``max_flips`` beyond 1e-3; every
    other lane, and each pixel's sum over them, within 1e-10; every pixel
    within |z| <= 5 (Q, U and V with I's variances). Returns the lanes
    beyond 1e-10."""
    (sums, m2), (ref_sums, ref_m2) = out, ref
    assert sums.dtype == ref_sums.dtype == F64 and sums.shape == ref_sums.shape
    I, ref_I = (sums[:, 0], ref_sums[:, 0]) if sums.ndim == 2 else (sums, ref_sums)
    n_pix = N_VZA
    rel = np.abs(I - ref_I) / np.maximum(np.abs(ref_I), 1e-300)
    spread, flip = rel > RTOL, rel > 1e-3
    assert flip.sum() <= max_flips, rel[flip]
    assert spread.sum() <= max_spread, np.sort(rel[spread])
    kept, ref_kept = (np.where(spread, 0.0, x).reshape(n_pix, -1).sum(1) for x in (I, ref_I))
    np.testing.assert_allclose(kept, ref_kept, rtol=RTOL, atol=0)
    close = ~spread
    np.testing.assert_allclose(m2[close], ref_m2[close], rtol=RTOL, atol=0)

    def pixels(x):
        return x.reshape(n_pix, -1, *x.shape[1:]).sum(1) / spp

    st, ref_st, sq, ref_sq = pixels(sums), pixels(ref_sums), pixels(m2), pixels(ref_m2)
    if st.ndim == 1:
        st, ref_st = st[:, None], ref_st[:, None]
    var = (sq - st[:, 0] ** 2 + ref_sq - ref_st[:, 0] ** 2) / spp
    assert np.isfinite(st).all()
    assert (np.abs(st - ref_st) / np.sqrt(var)[:, None] <= 5.0).all()
    return int(spread.sum())


@pytest.mark.parametrize("split", [False, True], ids=["instanced", "flat"])
@pytest.mark.parametrize("mode_id", ["mono_double", "mono_polarized_double"])
def test_het01_lane_gate_against_reference_under_x64(x64, mode_id, split):
    """The small HET01 at one seed through both packages' regenerative
    canopy loops, lane by lane. The polarized mode needs the polarized
    integrator, as ``bench.py``'s c5 gives it."""
    ref = _compiled(mode_id, split, True)
    out = _compiled(mode_id, split, False)
    assert out[2].polarized == (mode_id == "mono_polarized_double")
    assert np.asarray(out[4].canonical.centers if not split else out[4].centers).dtype == F64
    canopy_lane_gate(_port_lanes(out, SPP, 7), _ref_lanes(ref, SPP, 7), SPP)


@pytest.mark.parametrize("mode_id", ["mono_double", "mono_polarized"])
def test_double_mode_with_triangles_raises_by_name(mode_id):
    """A tree's trunks are triangles: since the triangle sweeps (K8, K9) have
    float64 builds, a double mode (``mono_polarized`` an alias of
    ``mono_polarized_double``) renders the tree canopy in float64, as it
    does the same canopy of leaves alone; nothing is refused by name. (The
    name is the test's from when the triangles were refused.)"""
    from test_torch_canopy_experiment import _with_tree

    eradiate_tpu_torch.set_mode(mode_id)
    try:
        leaves_only = eradiate_tpu_torch.CanopyExperiment(**kwargs(bio, atmosphere=False))
        for exp in (_with_tree(), leaves_only):
            ds = eradiate_tpu_torch.run(exp, spp=8, seed_state=eradiate_tpu_torch.SeedState(3),
                                        device="cpu")
            raw = exp.measures[0].results["raw"]
            assert raw["radiance"].dtype == F64 and np.isfinite(np.asarray(ds["brf"])).all()
    finally:
        eradiate_tpu_torch.set_mode("mono")
