"""The flat leaf kernels' bounding volume hierarchy, on the CPU.

``eradiate_tpu_torch/kernels/leaf_intersect.py`` builds the hierarchy the flat
leaf-disk CUDA kernels traverse (``leaf_bvh``, on the builder of
``kernels/bvh.py`` shared with the flat triangle sweeps) and keeps plain twins
of what the kernels do with it: the box test of the cull
(``bvh_leaves_reached_plain``) and the traversal's order-free tie rule
(``ray_leaves_nearest_bvh_plain``). The kernels run only on the card, where
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` hold them against
the plain versions bit for bit. Here:

- the structure is valid: every disk in exactly one leaf, leaf boxes around
  their disks' own boxes (and around points of their rims), parent boxes the
  exact unions of their children's, the depth within the stack, two builds
  bitwise equal, the records bitwise equal to the inputs by original index
  (``r * r`` and ``c.n`` rounded as the exact test rounds them);
- the cull is conservative: every disk the dense sweep accepts lies in a leaf
  the twin reaches with the cap ``t_max`` and with the cap at its own ``t``,
  for rays aimed at rims from near and from 100x farther, rays with
  direction components exactly +-0 along the planes of box faces, rays at
  grazing incidence, and a ragged lane count;
- the tie rule does not depend on the visit order: disks visited in seeded
  shuffled orders give the dense sweep's result bit for bit, on exact ties
  inside one 512-disk chunk and across two, and the result equals the
  jitted reference's (``hit`` equal, ``t`` within 4 ulp, normals 1e-6);
- normal components of exactly -0.0 come out +0.0, as the reference's sum
  into zero gives them;
- ``leaf_accel`` builds nothing on the CPU, and the flat wrappers reject
  malformed operands (another cull operand among them) before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import canopy as ref
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.ops import canopy
from eradiate_tpu_torch.test_tools.disks import (
    axis_rays,
    grazing_rays,
    random_disks,
    rim_rays,
    tie_disks,
    zero_normal_disks,
)

torch.set_num_threads(1)

B = 3000


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


def disks(N=700, seed=3):
    return random_disks(np.random.default_rng(seed), N)


def tables():
    """{name: (c, n, r) numpy}: random disks, the tie table, disks with +-0
    normal components, a single disk and tables of three and five (one and
    two leaves)."""
    c, n, r = disks()
    out = {"random": (c, n, r), "ties": tie_disks(np.random.default_rng(3), 1)[0],
           "zero normals": (c, zero_normal_disks(np.random.default_rng(4), n), r)}
    for k in (1, 3, 5):
        out[f"n{k}"] = disks(k, seed=k)
    return out


def leaf_of_disk(bvh):
    """The leaf (index into ``bvh_leaves``) that holds each original disk,
    and how many leaves hold it."""
    first, count, _, _ = li.bvh_leaves(bvh)
    index = bvh.disks[:, 3].contiguous().view(torch.int32).numpy()
    leaf = np.full(index.size, -1)
    seen = np.zeros(index.size, np.int64)
    for j, (a, k) in enumerate(zip(first, count)):
        leaf[index[a : a + k]] = j
        seen[index[a : a + k]] += 1
    return leaf, seen


@pytest.mark.parametrize("name", ["random", "ties", "zero normals", "n1", "n3", "n5"])
def test_structure_is_valid(name):
    c, n, r = (np.asarray(a, np.float32) for a in tables()[name])
    bvh = li.leaf_bvh(*_t(c, n, r))
    N = c.shape[0]
    assert 1 <= bvh.depth <= li.STACK
    assert bvh.nodes.shape[1] == 16 and bvh.disks.shape == (N, 12)
    assert bvh.nodes.dtype == bvh.disks.dtype == torch.float32

    # the records, re-laid out, are the inputs bit for bit; r * r and c.n
    # as the exact test rounds them
    rec = bvh.disks.numpy()
    index = rec[:, 3].view(np.int32)
    assert sorted(index) == list(range(N))
    for cols, x in ((slice(0, 3), c), (slice(4, 7), n), (7, r)):
        np.testing.assert_array_equal(rec[:, cols].view(np.int32), x[index].view(np.int32))
    ct, nt, rt = _t(c[index], n[index], r[index])
    cn = (ct[:, 0] * nt[:, 0] + ct[:, 1] * nt[:, 1]) + ct[:, 2] * nt[:, 2]
    np.testing.assert_array_equal(rec[:, 8].view(np.int32), (rt * rt).numpy().view(np.int32))
    np.testing.assert_array_equal(rec[:, 9].view(np.int32), cn.numpy().view(np.int32))
    np.testing.assert_array_equal(rec[:, 10:], 0.0)

    # every disk in exactly one leaf of at most LEAF, its own box and points
    # of its rim inside the leaf's box
    first, count, lo, hi = li.bvh_leaves(bvh)
    leaf, seen = leaf_of_disk(bvh)
    assert (seen == 1).all() and count.max() <= li.LEAF
    c64, n64, r64 = (x.astype(np.float64) for x in (c, n, r))
    unit = n64 / np.linalg.norm(n64, axis=1, keepdims=True)
    half = r64[:, None] * np.sqrt(np.clip(1.0 - unit**2, 0.0, 1.0))
    assert (lo[leaf] <= c64 - half).all() and (c64 + half <= hi[leaf]).all()
    a = np.cross(unit, [0.6, 0.0, 0.8] + 0.1 * unit)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.cross(unit, a)
    for phi in np.linspace(0.0, 2.0 * np.pi, 64, endpoint=False):
        rim = c64 + r64[:, None] * (np.cos(phi) * a + np.sin(phi) * b)
        slack = 1e-12 * (np.abs(c64) + r64[:, None])
        assert (lo[leaf] <= rim + slack).all() and (rim - slack <= hi[leaf]).all()
    # the tight boxes are tighter than the cubes c +- r where a normal leans
    # toward an axis
    if name == "random":
        assert (half < 0.9 * r64[:, None]).any(axis=1).mean() > 0.3

    # a child's box stored in its parent is the exact union of its own
    # children's; every inner node is reached once from the root
    nodes = bvh.nodes.numpy()
    box_lo = np.stack([nodes[:, [0, 4]], nodes[:, [2, 6]], nodes[:, [8, 10]]], -1)
    box_hi = np.stack([nodes[:, [1, 5]], nodes[:, [3, 7]], nodes[:, [9, 11]]], -1)
    codes = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
    np.testing.assert_array_equal(nodes[:, 14:], 0.0)
    inner = codes[codes >= 0]
    assert sorted(inner) == list(range(1, nodes.shape[0]))
    for m, k in zip(*np.nonzero(codes >= 0)):
        child = codes[m, k]
        np.testing.assert_array_equal(box_lo[m, k], box_lo[child].min(axis=0))
        np.testing.assert_array_equal(box_hi[m, k], box_hi[child].max(axis=0))


def test_builds_are_bitwise_equal():
    args = _t(*disks(2000, seed=5))
    a, b = li.leaf_bvh(*args), li.leaf_bvh(*args)
    assert a.depth == b.depth
    for x, y in ((a.nodes, b.nodes), (a.disks, b.disks)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_build_rejects_what_the_kernels_cannot_take(monkeypatch):
    c, n, r = _t(*disks())
    with pytest.raises(ValueError):
        li.leaf_bvh(c[:0], n[:0], r[:0])
    with pytest.raises(TypeError):
        li.leaf_bvh(c.double(), n, r)
    monkeypatch.setattr(bvh_mod, "STACK", 3)  # 700 disks in leaves of 4 need 8 levels
    with pytest.raises(ValueError, match="deep"):
        li.leaf_bvh(c, n, r)


def rays(kind, c, n, r, seed):
    rng = np.random.default_rng(seed)
    if kind == "rims near":
        return rim_rays(rng, B, c, n, r)
    if kind == "rims far":
        return rim_rays(rng, B, c, n, r, distance=100.0)
    if kind == "zero components near":
        return axis_rays(rng, B, c, n, r)
    if kind == "zero components far":
        return axis_rays(rng, B, c, n, r, distance=100.0)
    if kind == "grazing":
        return grazing_rays(rng, B, c, n, r)
    if kind == "zero normals, rims":
        return rim_rays(rng, B, c, n, r)
    if kind == "zero normals, zero components":
        return axis_rays(rng, B, c, n, r)
    return tuple(a[: B - 77] for a in rim_rays(rng, B, c, n, r, distance=10.0))  # ragged


@pytest.mark.parametrize(
    "kind", ["rims near", "rims far", "zero components near", "zero components far",
             "grazing", "zero normals, rims", "zero normals, zero components", "ragged"]
)
def test_cull_is_conservative(kind):
    """Every disk the dense sweep accepts within ``t_max`` lies in a leaf
    reached with the cap ``t_max``, and in one reached with the cap at its
    own ``t`` (the nearest hit's traversal caps at the best ``t`` so far);
    every disk at the nearest hit's ``t`` (the winner and its ties) in a
    leaf reached with that cap. With normal components of +-0 a disk's box
    is flat on the normal's axis. The margin is measured too."""
    c, n, r = disks()
    if kind.startswith("zero normals"):
        n = zero_normal_disks(np.random.default_rng(4), n, share=1.0)
    table = _t(c, n, r)
    bvh = li.leaf_bvh(*table)
    p, d, t_max = _t(*rays(kind, c, n, r, seed=11))
    if "zero components" in kind:
        assert (d == 0).any(dim=1).all() and (torch.signbit(d) & (d == 0)).any()
    leaf, _ = leaf_of_disk(bvh)
    leaf = torch.from_numpy(leaf)
    t_all = li._chunk_hits(p, d, *table, t_max)
    accepted = torch.isfinite(t_all)
    assert accepted.any(dim=1).sum() >= p.shape[0] // 8
    reached = li.bvh_leaves_reached_plain(p, d, t_max, bvh)
    assert not (accepted & ~reached[:, leaf]).any()
    lanes, disk = torch.nonzero(accepted, as_tuple=True)
    _, _, lo, hi = li.bvh_leaves(bvh)
    box = leaf[disk].numpy()
    lo, hi = _t(lo[box], hi[box])
    for s in range(0, lanes.shape[0], 512):  # each pair's own box: the diagonal
        sl = slice(s, s + 512)
        own = bvh_mod._box_reach(p[lanes[sl]], d[lanes[sl]], t_all[lanes[sl], disk[sl]],
                                 lo[sl], hi[sl])
        assert torch.diagonal(own).all()
    # the kernels' box growth covers the rounding a hundred times over: the
    # line's point at the computed t lies within 1e-2 BOX_SLACK (of the
    # coordinates' magnitude) of the disk's own exact box
    c64, n64, r64 = (x.double() for x in table)
    unit = n64 / torch.linalg.norm(n64, dim=1, keepdim=True)
    half = r64[:, None] * torch.sqrt(torch.clamp(1.0 - unit**2, 0.0, 1.0))
    q = p[lanes].double() + d[lanes].double() * t_all[lanes, disk].double()[:, None]
    lo64, hi64 = (c64 - half)[disk], (c64 + half)[disk]
    outside = torch.maximum(lo64 - q, q - hi64).amax(dim=1)
    scale = (torch.maximum((lo64 - p[lanes]).abs(), (hi64 - p[lanes]).abs()).sum(dim=1)
             + p[lanes].double().abs().sum(dim=1))
    assert (outside <= 1e-2 * bvh_mod.BOX_SLACK * scale).all()
    t_hit, _, hit = li.ray_leaves_nearest_plain(p, d, t_max, *table)
    at_best = accepted & (t_all == t_hit[:, None])
    assert (at_best.any(dim=1) == hit).all()
    reached_best = li.bvh_leaves_reached_plain(p, d, t_hit, bvh)
    assert not (at_best & ~reached_best[:, leaf]).any()
    # the cull culls: a ray reaches a small share of the leaves
    assert reached.float().mean() < 0.2


def tie_problem(name):
    if name == "ties":
        return tie_disks(np.random.default_rng(3), B)
    c, n, r = disks()
    return (c, n, r), rim_rays(np.random.default_rng(4), B, c, n, r)


@pytest.mark.parametrize("name", ["ties", "random"])
def test_tie_rule_does_not_depend_on_the_visit_order(name):
    """The disks visited in their leaf order, reversed, leaf by leaf in
    shuffled orders of the leaves, and in shuffled orders of the disks: the
    dense sweep's result bit for bit."""
    (c, n, r), (p, d, t_max) = tie_problem(name)
    table = _t(c, n, r)
    args = _t(p, d, t_max)
    bvh = li.leaf_bvh(*table)
    want = li.ray_leaves_nearest_plain(*args, *table)
    first, count, _, _ = li.bvh_leaves(bvh)
    rows = np.arange(bvh.disks.shape[0])
    orders = [None, rows[::-1]]
    for seed in (1, 2):
        leaves = np.random.default_rng(seed).permutation(first.size)
        orders.append(np.concatenate([np.arange(first[j], first[j] + count[j]) for j in leaves]))
        orders.append(np.random.default_rng(seed).permutation(rows))
    for order in orders:
        got = li.ray_leaves_nearest_bvh_plain(*args, bvh, order)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               w.view(torch.int32) if w.is_floating_point() else w)
    if name == "ties":
        # lanes whose nearest distance two disks share, inside one chunk and
        # across two; the opposite normals inside chunk 0 average to zero,
        # across the lower chunk's normal wins
        t_all = li._chunk_hits(*args[:2], *table, args[2])
        tied = t_all == want[0][:, None]
        assert (tied.sum(dim=1) > 1).sum() >= B // 3
        across = tied[:, :512].any(dim=1) & tied[:, 512:].any(dim=1)
        assert across.sum() >= B // 8
        inside = tied[:, 0] & tied[:, 1]
        assert inside.sum() >= B // 20
        assert (want[1][inside] == 0).all()
        assert not torch.signbit(want[1][inside]).any()
        opposite = tied[:, 2] & tied[:, -1]
        assert opposite.sum() >= B // 20
        assert torch.equal(want[1][opposite], torch.from_numpy(n[2]).expand(int(opposite.sum()), 3))
        jitted = jax.jit(ref.ray_leaves_nearest)
        leaves = ref.LeafCloudArrays(*(jnp.asarray(x) for x in (c, n, r)))
        t_ref, n_ref, hit_ref = (np.asarray(x) for x in jitted(p, d, t_max, leaves))
        np.testing.assert_array_equal(want[2].numpy(), hit_ref)
        ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
                  for x in (want[0].numpy(), t_ref))
        assert np.abs(ia - ib).max() <= 4
        np.testing.assert_allclose(want[1].numpy(), n_ref, rtol=0, atol=1e-6)


def test_negative_zero_normals_come_out_positive():
    """Disks with normal components of exactly +-0: the dense sweep, the
    hierarchy's twin and the instanced sweep return +0.0 where the winner's
    component is -0.0, bit for bit as the jitted reference does."""
    rng = np.random.default_rng(6)
    c, n, r = disks()
    n = zero_normal_disks(rng, n, share=1.0)
    assert (np.signbit(n) & (n == 0)).any(axis=1).mean() > 0.3
    (p, d, t_max) = rim_rays(rng, B, c, n, r)
    table = _t(c, n, r)
    args = _t(p, d, t_max)
    jitted = jax.jit(ref.ray_leaves_nearest)
    leaves = ref.LeafCloudArrays(*(jnp.asarray(np.asarray(x, np.float32)) for x in (c, n, r)))
    _, n_ref, hit_ref = (np.asarray(x) for x in jitted(p, d, t_max, leaves))
    assert hit_ref.mean() > 0.3
    t_all = li._chunk_hits(args[0], args[1], *table, args[2])
    winners = n[t_all.argmin(dim=1).numpy()]  # no two disks tie here
    assert (np.signbit(winners) & (winners == 0))[hit_ref].any()
    assert not (np.signbit(n_ref) & (n_ref == 0)).any()  # the reference's +0.0
    bvh = li.leaf_bvh(*table)
    for _, normal, hit in (li.ray_leaves_nearest_plain(*args, *table),
                           li.ray_leaves_nearest_bvh_plain(*args, bvh),
                           li.ray_leaves_nearest_instanced_plain(*args, *table,
                                                                 torch.zeros(1, 3))):
        np.testing.assert_array_equal(hit.numpy(), hit_ref)
        assert not torch.signbit(normal[normal == 0]).any()
        np.testing.assert_array_equal(normal.numpy().view(np.int32)[hit_ref],
                                      n_ref.view(np.int32)[hit_ref])


def test_leaf_accel_builds_nothing_on_the_cpu(monkeypatch):
    """The CPU path sweeps densely: ``leaf_accel`` returns no cull operand,
    flat or instanced, and never calls a build (which runs once per render
    on CUDA)."""
    def refuse(*args):
        raise AssertionError("a cull operand was built on the CPU")

    monkeypatch.setattr(canopy, "leaf_bvh", refuse)
    monkeypatch.setattr(canopy, "leaf_instanced_bvh", refuse)
    c, n, r = _t(*disks())
    flat = canopy.LeafCloudArrays(c, n, r)
    for leaves in (flat, canopy.InstancedLeafArrays(flat, torch.tensor([[0.0, 0, 0], [3.0, 0, 0]]))):
        cull, lo, hi = canopy.leaf_accel(leaves)
        assert cull is None
        want = canopy.leaf_bounds(leaves)
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])


def _flat_operands(n_rays=16, n_disks=70):
    """Operands of a flat launch, with a hierarchy's arrays as ``nodes`` and
    ``disks``."""
    return {
        "p": torch.zeros(n_rays, 3), "d": torch.zeros(n_rays, 3), "t_max": torch.zeros(n_rays),
        "centers": torch.zeros(n_disks, 3), "normals": torch.zeros(n_disks, 3),
        "radii": torch.zeros(n_disks), "nodes": torch.zeros(n_disks // 2, 16),
        "disks": torch.zeros(n_disks, 12),
    }


@pytest.mark.parametrize(
    "kind, exc",
    [("dtype", TypeError), ("non-contiguous", ValueError), ("rays-shape", ValueError),
     ("table-shape", ValueError), ("device", ValueError), ("nodes-shape", ValueError),
     ("disks-shape", ValueError), ("nodes-dtype", TypeError), ("too-deep", ValueError)],
)
def test_flat_wrapper_rejects_bad_inputs(kind, exc):
    """The flat kernels' checks of the rays, the table and the hierarchy:
    shapes, dtype, device and contiguity, and a tree deeper than the
    kernels' stack."""
    depth = 5

    def check(named):
        return li._check("ray_leaves_nearest", named, named["p"].shape[0],
                         named["centers"].shape[0], None, depth=depth)

    check(_flat_operands())  # the unmodified inputs pass
    named = _flat_operands()
    if kind == "dtype":
        named["normals"] = named["normals"].double()
    elif kind == "non-contiguous":
        named["d"] = torch.zeros(3, 16).T
    elif kind == "rays-shape":
        named["t_max"] = torch.zeros(15)
    elif kind == "table-shape":
        named["radii"] = torch.zeros(69)
    elif kind == "device":
        named["centers"] = named["centers"].to("meta")
    elif kind == "nodes-shape":
        named["nodes"] = torch.zeros(35, 12)
    elif kind == "disks-shape":
        named["disks"] = torch.zeros(69, 12)
    elif kind == "nodes-dtype":
        named["nodes"] = named["nodes"].double()
    else:
        depth = li.STACK + 1
    with pytest.raises(exc):
        check(named)


def test_flat_wrappers_take_only_the_hierarchy():
    """A flat launch with another cull operand (a group-sphere tensor, or
    the instanced kernels' two-level hierarchy) raises before it reaches
    the card."""
    c, n, r = _t(*disks())
    p, d, t_max = _t(*rim_rays(np.random.default_rng(2), 8, *disks()))
    spheres = torch.zeros(1 + -(-c.shape[0] // 128), 4)
    two_level = li.leaf_instanced_bvh(c, n, r, torch.zeros(2, 3))
    for cull in (spheres, two_level):
        with pytest.raises(TypeError):
            li._launch_flat("ray_leaves_nearest", True, p, d, t_max, c, n, r, cull)
