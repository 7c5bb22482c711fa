"""The flat triangle kernels' bounding volume hierarchy, on the CPU.

``eradiate_tpu_torch/kernels/tri_intersect.py`` builds the hierarchy the flat
CUDA kernels traverse (``tri_bvh``, on the builder of ``kernels/bvh.py`` that
the flat leaf sweeps share) and keeps plain twins of what the kernels do with
it: the box test of the cull (``bvh_leaves_reached_plain``, float32, the
kernels' margins and NaN rule) and the traversal's order-free tie rule
(``ray_tris_nearest_bvh_plain``). The kernels run only on the card, where
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` hold them against
the plain versions bit for bit. Here:

- the structure is valid: every triangle in exactly one leaf, leaf boxes
  around their triangles' vertices, parent boxes the exact unions of their
  children's, the depth within the stack, two builds bitwise equal, the
  re-laid-out triangles bitwise equal to the inputs by original index, and
  the bytes of a seeded skeleton's hierarchy pinned by their digest;
- the cull is conservative: every triangle the dense sweep accepts lies in a
  leaf the twin reaches, for rays aimed at shared edges and vertices from
  near and from 100x farther, rays with direction components exactly +-0,
  rays through vertices on the planes of box faces, and a ragged lane count;
- the tie rule does not depend on the visit order: leaves visited in seeded
  shuffled orders give the dense sweep's result bit for bit, on exact ties
  inside one 512-triangle chunk and across two, and the result equals the
  jitted reference's (``hit`` equal, ``t`` within 4 ulp, normals 1e-6).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import mesh as ref
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops import mesh
from eradiate_tpu_torch.test_tools.meshes import axis_rays, edge_rays, tie_soup, wood_skeleton

torch.set_num_threads(1)

B = 3000


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def skeleton(branches=20):
    """A wood skeleton in km: 36 + 24 x ``branches`` triangles."""
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=branches)
    return mesh.mesh_from_vertices((v * 1e-3).astype(np.float32), f)


def soups():
    """{name: (v0, e1, e2) float32 numpy}: the skeleton, the tie soup, a
    single triangle and soups of three and five (one and two leaves)."""
    s = skeleton()
    out = {"skeleton": (s.v0, s.e1, s.e2), "ties": tie_soup(np.random.default_rng(3), 1)[0]}
    for n in (1, 3, 5):
        rng = np.random.default_rng(n)
        out[f"n{n}"] = tuple(rng.normal(0, 1e-2, (n, 3)).astype(np.float32) for _ in range(3))
    return out


def leaf_of_triangle(bvh):
    """The leaf (index into ``bvh_leaves``) that holds each original
    triangle, and how many leaves hold it."""
    first, count, _, _ = ti.bvh_leaves(bvh)
    index = bvh.tris[:, 3].contiguous().view(torch.int32).numpy()
    leaf = np.full(index.size, -1)
    seen = np.zeros(index.size, np.int64)
    for j, (a, c) in enumerate(zip(first, count)):
        leaf[index[a : a + c]] = j
        seen[index[a : a + c]] += 1
    return leaf, seen


@pytest.mark.parametrize("name", ["skeleton", "ties", "n1", "n3", "n5"])
def test_structure_is_valid(name):
    v0, e1, e2 = soups()[name]
    bvh = ti.tri_bvh(*_t(v0, e1, e2))
    N = v0.shape[0]
    assert 1 <= bvh.depth <= ti.STACK
    assert bvh.nodes.shape[1] == 16 and bvh.tris.shape == (N, 12)
    assert bvh.nodes.dtype == bvh.tris.dtype == torch.float32

    # the triangles, re-laid out, are the inputs bit for bit
    tris = bvh.tris.numpy()
    index = tris[:, 3].view(np.int32)
    assert sorted(index) == list(range(N))
    for cols, x in ((slice(0, 3), v0), (slice(4, 7), e1), (slice(8, 11), e2)):
        np.testing.assert_array_equal(tris[:, cols].view(np.int32), x[index].view(np.int32))
    np.testing.assert_array_equal(tris[:, [7, 11]], 0.0)

    # every triangle in exactly one leaf of at most LEAF, inside its box
    first, count, lo, hi = ti.bvh_leaves(bvh)
    leaf, seen = leaf_of_triangle(bvh)
    assert (seen == 1).all() and count.max() <= ti.LEAF
    assert np.array_equal(np.sort(np.concatenate([np.arange(a, a + c) for a, c in
                                                  zip(first, count)])), np.arange(N))
    a = v0.astype(np.float64)
    for vert in (a, a + e1, a + e2):
        assert (lo[leaf] <= vert).all() and (vert <= hi[leaf]).all()

    # a child's box stored in its parent is the exact union of its own
    # children's; every inner node is reached once from the root
    nodes = bvh.nodes.numpy()
    box_lo = np.stack([nodes[:, [0, 4]], nodes[:, [2, 6]], nodes[:, [8, 10]]], -1)
    box_hi = np.stack([nodes[:, [1, 5]], nodes[:, [3, 7]], nodes[:, [9, 11]]], -1)
    codes = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
    np.testing.assert_array_equal(nodes[:, 14:], 0.0)
    inner = codes[codes >= 0]
    assert sorted(inner) == list(range(1, nodes.shape[0]))
    for m, c in zip(*np.nonzero(codes >= 0)):
        child = codes[m, c]
        np.testing.assert_array_equal(box_lo[m, c], box_lo[child].min(axis=0))
        np.testing.assert_array_equal(box_hi[m, c], box_hi[child].max(axis=0))


def test_builds_are_bitwise_equal():
    s = skeleton(60)
    args = _t(s.v0, s.e1, s.e2)
    a, b = ti.tri_bvh(*args), ti.tri_bvh(*args)
    assert a.depth == b.depth
    for x, y in ((a.nodes, b.nodes), (a.tris, b.tris)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_build_bytes_are_pinned():
    """The builder that the flat leaf sweeps share gives the bytes it gave
    before it was shared: the digest of the seeded 60-branch skeleton's
    hierarchy (nodes, then triangles) as ``tri_bvh`` built it when it held
    the builder itself."""
    s = skeleton(60)
    b = ti.tri_bvh(*_t(s.v0, s.e1, s.e2))
    h = hashlib.sha256(b.nodes.numpy().tobytes())
    h.update(b.tris.numpy().tobytes())
    assert b.depth == 12 and b.nodes.shape == (434, 16)
    assert h.hexdigest() == "39e852be5e1b6c39266c6cbb9c8e47d2db2d8508bd50b3e86903612b2788ac95"


def test_build_rejects_what_the_kernels_cannot_take(monkeypatch):
    s = skeleton()
    with pytest.raises(ValueError):
        ti.tri_bvh(*_t(s.v0[:0], s.e1[:0], s.e2[:0]))
    with pytest.raises(TypeError):
        ti.tri_bvh(*_t(s.v0.astype(np.float64), s.e1, s.e2))
    monkeypatch.setattr(bvh_mod, "STACK", 3)  # 516 triangles in leaves of 4 need 8 levels
    with pytest.raises(ValueError, match="deep"):
        ti.tri_bvh(*_t(s.v0, s.e1, s.e2))


#: Lanes of ``edge_rays(default_rng(32), 100_037, <256-branch skeleton>,
#: None, 1e-3)`` that meet a branch's side at a grazing angle from 150-250 m:
#: the exact test puts the hit up to ~1% of the distance before the line
#: enters the triangle's box.
GRAZING_LANES = [4430, 14974, 64299]


def rays(kind, soup, seed):
    rng = np.random.default_rng(seed)
    if kind == "grazing slivers":
        return tuple(a[GRAZING_LANES] for a in edge_rays(np.random.default_rng(32), 100_037,
                                                          soup, None, 1e-3))
    if kind == "edges near":
        return edge_rays(rng, B, soup, None, 1e-5)
    if kind == "edges far":
        return edge_rays(rng, B, soup, None, 1e-3)
    if kind == "zero components near":
        return axis_rays(rng, B, soup, 1e-5)
    if kind == "zero components far":
        return axis_rays(rng, B, soup, 1e-3)
    return tuple(a[: B - 77] for a in edge_rays(rng, B, soup, None, 1e-4))  # ragged


@pytest.mark.parametrize(
    "kind", ["edges near", "edges far", "zero components near", "zero components far", "ragged",
             "grazing slivers"]
)
def test_cull_is_conservative(kind):
    """Every triangle the dense sweep accepts within ``t_max`` lies in a leaf
    reached with the cap ``t_max``, and in one reached with the cap at its
    own ``t`` (the nearest hit's traversal caps at the best ``t`` so far);
    every triangle at the nearest hit's ``t`` (the winner and its ties) in a
    leaf reached with that cap."""
    soup = skeleton(256 if kind == "grazing slivers" else 20)
    tris = _t(soup.v0, soup.e1, soup.e2)
    bvh = ti.tri_bvh(*tris)
    p, d, t_max = _t(*rays(kind, soup, seed=11))
    if kind.startswith("zero"):
        assert (d == 0).any(dim=1).all() and (torch.signbit(d) & (d == 0)).any()
    leaf, _ = leaf_of_triangle(bvh)
    leaf = torch.from_numpy(leaf)
    t_all = ti._chunk_hits(p, d, *tris, t_max)
    accepted = torch.isfinite(t_all)
    assert accepted.any(dim=1).sum() >= p.shape[0] // 8
    reached = ti.bvh_leaves_reached_plain(p, d, t_max, bvh)
    assert not (accepted & ~reached[:, leaf]).any()
    lanes, tri = torch.nonzero(accepted, as_tuple=True)
    first, count, lo, hi = ti.bvh_leaves(bvh)
    box = leaf[tri].numpy()
    lo, hi = _t(lo[box], hi[box])
    for s in range(0, lanes.shape[0], 512):  # each pair's own box: the diagonal
        sl = slice(s, s + 512)
        own = bvh_mod._box_reach(p[lanes[sl]], d[lanes[sl]], t_all[lanes[sl], tri[sl]], lo[sl], hi[sl])
        assert torch.diagonal(own).all()
    t_hit, _, hit = ti.ray_tris_nearest_plain(p, d, t_max, *tris)
    at_best = accepted & (t_all == t_hit[:, None])
    assert (at_best.any(dim=1) == hit).all()
    reached_best = ti.bvh_leaves_reached_plain(p, d, t_hit, bvh)
    assert not (at_best & ~reached_best[:, leaf]).any()
    # the cull culls: a ray reaches a small share of the leaves (the
    # grazing lanes cross the crown's centre, where every branch starts)
    assert reached.float().mean() < (0.75 if kind == "grazing slivers" else 0.5)


def test_zero_direction_component_on_a_box_face(monkeypatch):
    """The NaN rule: with no margin, a ray parallel to a face and lying in
    its plane gives 0 * inf = NaN on that axis, which bounds nothing; a ray
    one ulp outside the slab never reaches the box."""
    monkeypatch.setattr(bvh_mod, "BOX_SLACK", 0.0)
    lo = torch.tensor([[0.0, 0.0, 0.0]])
    hi = torch.tensor([[1.0, 1.0, 1.0]])
    below = float(np.nextafter(np.float32(0.0), np.float32(-1.0)))
    above = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    p = torch.tensor([[-1.0, 0.0, 0.5], [-1.0, 1.0, 0.5], [-1.0, below, 0.5],
                      [-1.0, above, 0.5], [-1.0, 0.5, 0.5], [2.0, 0.0, 0.5]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, -0.0, 0.0], [1.0, 0.0, 0.0],
                      [1.0, -0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, -0.0, 0.0]])
    cap = torch.full((6,), 3.0)
    got = bvh_mod._box_reach(p, d, cap, lo, hi)[:, 0]
    assert got.tolist() == [True, True, False, False, True, True]


def tie_problem(name):
    if name == "ties":
        (v0, e1, e2), (p, d, t_max) = tie_soup(np.random.default_rng(3), B)
        return (v0, e1, e2), (p, d, t_max)
    soup = skeleton()
    return (soup.v0, soup.e1, soup.e2), edge_rays(np.random.default_rng(4), B, soup, None, 1e-5)


@pytest.mark.parametrize("name", ["ties", "skeleton"])
def test_tie_rule_does_not_depend_on_the_visit_order(name):
    """The triangles visited in their leaf order, reversed, leaf by leaf in
    shuffled orders of the leaves, and in shuffled orders of the triangles:
    the dense sweep's result bit for bit."""
    (v0, e1, e2), (p, d, t_max) = tie_problem(name)
    tris = _t(v0, e1, e2)
    args = _t(p, d, t_max)
    bvh = ti.tri_bvh(*tris)
    want = ti.ray_tris_nearest_plain(*args, *tris)
    first, count, _, _ = ti.bvh_leaves(bvh)
    rows = np.arange(bvh.tris.shape[0])
    orders = [None, rows[::-1]]
    for seed in (1, 2):
        leaves = np.random.default_rng(seed).permutation(first.size)
        orders.append(np.concatenate([np.arange(first[j], first[j] + count[j]) for j in leaves]))
        orders.append(np.random.default_rng(seed).permutation(rows))
    for order in orders:
        got = ti.ray_tris_nearest_bvh_plain(*args, bvh, order)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if name == "ties":
        # lanes whose nearest distance several triangles share, inside one
        # chunk and across two; the coplanar halves of opposite winding
        # average to a zero normal inside chunk 0 and give the lower chunk's
        # normal (0, 0, -1) across
        t_all = ti._chunk_hits(*args[:2], *tris, args[2])
        tied = t_all == want[0][:, None]
        assert (tied.sum(dim=1) > 1).sum() >= B // 3
        across = tied[:, :512].any(dim=1) & tied[:, 512:].any(dim=1)
        assert across.sum() >= B // 10
        down = torch.from_numpy(np.arange(B) % 5 == 4)
        normal = want[1][down]
        assert (normal == 0).all(dim=1).sum() >= B // 20
        assert (normal == torch.tensor([0.0, 0.0, -1.0])).all(dim=1).sum() >= B // 20
        jitted = jax.jit(ref.ray_tris_nearest)
        ref_tris = ref.TriangleMeshArrays(*(jnp.asarray(x) for x in (v0, e1, e2)))
        t_ref, n_ref, hit_ref = (np.asarray(x) for x in jitted(p, d, t_max, ref_tris))
        np.testing.assert_array_equal(want[2].numpy(), hit_ref)
        ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
                  for x in (want[0].numpy(), t_ref))
        assert np.abs(ia - ib).max() <= 4
        np.testing.assert_allclose(want[1].numpy(), n_ref, rtol=0, atol=1e-6)


def test_tri_accel_builds_nothing_on_the_cpu(monkeypatch):
    """The CPU path sweeps densely: ``tri_accel`` returns no cull operand and
    never calls the build (which runs once per render on CUDA)."""
    def refuse(*args):
        raise AssertionError("tri_bvh called on the CPU")

    monkeypatch.setattr(mesh, "tri_bvh", refuse)
    s = skeleton()
    tris = mesh.TriangleMeshArrays(*_t(s.v0, s.e1, s.e2))
    cull, lo, hi = mesh.tri_accel(tris)
    assert cull is None
    verts = np.concatenate([s.v0, s.v0 + s.e1, s.v0 + s.e2])
    np.testing.assert_array_equal(lo.numpy(), verts.min(axis=0))
    np.testing.assert_array_equal(hi.numpy(), verts.max(axis=0))
