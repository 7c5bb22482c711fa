"""The instanced triangle kernels' two-level bounding volume hierarchy, on the CPU.

``eradiate_tpu_torch/kernels/tri_intersect.py`` builds the hierarchy the
instanced triangle CUDA kernels traverse (``tri_instanced_bvh``: the
instances' boxes of ``kernels/bvh.instance_level`` above the canonical soup's
``tri_bvh``) and keeps a plain twin of the traversal's order-free tie rule
(``ray_tris_nearest_instanced_bvh_plain``). The kernels run only on the card,
where ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py`` hold them
against the dense plain versions bit for bit. Here:

- the structure is valid: every instance once in the top level, with its
  offset's bits by original row; each instance box around the canonical root
  box plus the offset (in float64); the canonical level equal to
  ``tri_bvh``'s; the depths within the stacks; two builds bitwise equal;
- the cull is conservative at both levels: every (lane, instance, triangle)
  the exact test accepts on ``fl(p - offset)`` lies in a top leaf the world
  ray reaches and in a canonical leaf the translated ray reaches, with the
  cap ``t_max`` and with the cap at its own ``t``, on rays aimed at a wood
  skeleton's shared edges and vertices from 0.5-3 m and from 50-300 m,
  direction components exactly +-0 near and far (origins on the planes of
  box faces), +-0 normals, a ragged lane count, the tie soup, and instances
  100x the soup's size from the world origin (rays from near the origin and
  from near the instances);
- the tie rule does not depend on the visit order: (instance, triangle)
  pairs visited in seeded shuffled orders give the dense instanced sweep's
  result bit for bit, which agrees with the jitted reference (``hit`` equal,
  ``t`` within 4 ulp, normals 1e-6); the tie soup shows ties inside a chunk,
  across chunks and across instances, three instances at each offset, the
  lowest instance winning from the higher chunk and from the lower one
  after the nearer-first walk has met a higher instance;
- normal components of exactly -0.0 come out +0.0 through the two-level
  twin;
- ``tri_accel`` builds nothing on the CPU, and the instanced wrappers reject
  malformed operands (another cull operand among them) before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import mesh as ref
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops import mesh
from eradiate_tpu_torch.test_tools.meshes import (
    axis_rays,
    edge_rays,
    instanced_tie_soup,
    wood_skeleton,
    zero_normal_tris,
)

torch.set_num_threads(1)

B = 2000
#: Three instances of a skeleton about 30 m wide, apart (km).
OFFSETS = np.array([[0.0, 0, 0], [0.05, 0, 0], [0, 0.07, 0]])
#: Instances 100x the skeleton's size from the world origin.
FAR = np.array([[2.0, 0, 0], [0, -2.0, 0], [1.4, 1.4, 0.3]])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


def skeleton(branches=20):
    """A wood skeleton in km: 36 + 24 x ``branches`` triangles (516: a full
    512-triangle chunk and a ragged second one)."""
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=branches)
    return mesh.mesh_from_vertices((v * 1e-3).astype(np.float32), f)


def bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def offsets_for(I, seed=1):
    """``I`` tree positions in a 100 m x 100 m square (km), HET01's
    layout."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.05, 0.05, (I, 2)), np.zeros((I, 1))], axis=1)


def ref_instanced(tris, offsets):
    return ref.InstancedTriArrays(ref.TriangleMeshArrays(*(jnp.asarray(np.asarray(x, np.float32))
                                                           for x in tris)),
                                  jnp.asarray(np.asarray(offsets, np.float32)))


@pytest.mark.parametrize("I", [1, 3, 5, 15, 17])
def test_structure_is_valid(I):
    s = skeleton()
    soup = _t(s.v0, s.e1, s.e2)
    offsets = np.asarray(offsets_for(I), np.float32)
    ibvh = ti.tri_instanced_bvh(*soup, torch.from_numpy(offsets))
    assert 1 <= ibvh.top_depth <= ti.TOP_STACK and 1 <= ibvh.canonical.depth <= ti.STACK
    assert ibvh.top.shape[1] == 16 and ibvh.instances.shape == (I, 4)
    assert ibvh.top.dtype == ibvh.instances.dtype == torch.float32

    # the canonical level is the flat hierarchy of the soup, bit for bit
    flat = ti.tri_bvh(*soup)
    assert ibvh.canonical.depth == flat.depth
    for x, y in ((ibvh.canonical.nodes, flat.nodes), (ibvh.canonical.tris, flat.tris)):
        assert torch.equal(bits(x), bits(y))

    # every instance once, its offset's bits by original row
    inst = ibvh.instances.numpy()
    row = inst[:, 3].view(np.int32)
    assert sorted(row) == list(range(I))
    np.testing.assert_array_equal(inst[:, :3].view(np.int32), offsets[row].view(np.int32))

    # each instance in one top leaf, whose box holds the canonical root box
    # plus the offset, in float64
    first, count, lo, hi = ti.bvh_leaves(ibvh.top)
    leaf = np.full(I, -1)
    for j, (a, k) in enumerate(zip(first, count)):
        assert (leaf[a : a + k] == -1).all()
        leaf[a : a + k] = j
    assert (leaf >= 0).all() and count.max() <= ti.LEAF
    _, _, clo, chi = ti.bvh_leaves(flat)
    root_lo, root_hi = clo.min(axis=0).astype(np.float64), chi.max(axis=0).astype(np.float64)
    o = offsets[row].astype(np.float64)
    assert (lo[leaf] <= root_lo + o).all() and (root_hi + o <= hi[leaf]).all()

    # the top's parent boxes are the exact unions of their children's
    nodes = ibvh.top.numpy()
    box_lo = np.stack([nodes[:, [0, 4]], nodes[:, [2, 6]], nodes[:, [8, 10]]], -1)
    box_hi = np.stack([nodes[:, [1, 5]], nodes[:, [3, 7]], nodes[:, [9, 11]]], -1)
    codes = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
    assert sorted(codes[codes >= 0]) == list(range(1, nodes.shape[0]))
    for m, k in zip(*np.nonzero(codes >= 0)):
        np.testing.assert_array_equal(box_lo[m, k], box_lo[codes[m, k]].min(axis=0))
        np.testing.assert_array_equal(box_hi[m, k], box_hi[codes[m, k]].max(axis=0))

    # two builds are bitwise equal
    again = ti.tri_instanced_bvh(*soup, torch.from_numpy(offsets))
    assert again.top_depth == ibvh.top_depth and again.canonical.depth == ibvh.canonical.depth
    for x, y in ((again.top, ibvh.top), (again.instances, ibvh.instances),
                 (again.canonical.nodes, ibvh.canonical.nodes),
                 (again.canonical.tris, ibvh.canonical.tris)):
        assert torch.equal(bits(x), bits(y))


def test_build_rejects_what_the_kernels_cannot_take(monkeypatch):
    s = skeleton()
    soup = _t(s.v0, s.e1, s.e2)
    with pytest.raises(ValueError):
        ti.tri_instanced_bvh(*soup, torch.zeros(0, 3))
    with pytest.raises(ValueError):
        ti.tri_instanced_bvh(*soup, torch.zeros(3, 2))
    with pytest.raises(TypeError):
        ti.tri_instanced_bvh(*soup, torch.zeros(3, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        ti.tri_instanced_bvh(*(x[:0] for x in soup), torch.zeros(3, 3))
    with pytest.raises(TypeError):
        ti.tri_instanced_bvh(*(x.double() for x in soup), torch.zeros(3, 3))
    monkeypatch.setattr(bvh_mod, "TOP_STACK", 2)  # 17 instances in leaves of 4 need 3 levels
    with pytest.raises(ValueError, match="deep"):
        ti.tri_instanced_bvh(*soup, torch.from_numpy(np.float32(offsets_for(17))))


def problem(kind, seed=11):
    """``(v0, e1, e2), offsets, (p, d, t_max)`` numpy for a kind of the cull
    stress."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return instanced_tie_soup(rng, B)
    s = skeleton()
    tris = (s.v0, s.e1, s.e2)
    if kind == "zero normals":
        tris = zero_normal_tris(np.random.default_rng(4), *tris, share=1.0)
        s = mesh.TriangleMeshArrays(*tris)
    offsets = FAR if kind.startswith("far offsets") else OFFSETS
    if kind == "edges far":
        rays = edge_rays(rng, B, s, offsets, 1e-3)
    elif kind.startswith("zero components"):
        rays = axis_rays(rng, B, s, 1e-3 if kind.endswith("far") else 1e-5, offsets)
    elif kind == "far offsets, origins near the origin":
        rays = edge_rays(rng, B, s, offsets, origins=rng.uniform(-0.01, 0.01, (B, 3)))
    elif kind == "ragged":
        rays = tuple(a[: B - 77] for a in edge_rays(rng, B, s, offsets, 1e-4))
    else:  # edges near, zero normals, far offsets with origins near the instances
        rays = edge_rays(rng, B, s, offsets, 1e-5)
    return tris, offsets, rays


def _diagonal_reach(p, d, cap, lo, hi):
    """``_box_reach`` of each lane against its own box: bool [L]."""
    out = []
    for s in range(0, p.shape[0], 512):
        sl = slice(s, s + 512)
        out.append(torch.diagonal(bvh_mod._box_reach(p[sl], d[sl], cap[sl], lo[sl], hi[sl])))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool)


@pytest.mark.parametrize(
    "kind", ["edges near", "edges far", "zero components near", "zero components far",
             "zero normals", "ragged", "ties", "far offsets, origins near the origin",
             "far offsets, origins near the instances"]
)
def test_cull_is_conservative(kind):
    """Every pair the exact test accepts on the translated ray within
    ``t_max`` lies in a top leaf the world ray reaches and in a canonical
    leaf the translated ray reaches, with the cap ``t_max`` and with the cap
    at its own ``t`` (the nearest hit's traversal caps both levels at the
    best ``t`` so far)."""
    tris, offsets, rays = problem(kind)
    soup = _t(*tris)
    ibvh = ti.tri_instanced_bvh(*soup, *_t(offsets))
    canon = ibvh.canonical
    p, d, t_max = _t(*rays)
    if "zero components" in kind:
        assert (d == 0).any(dim=1).all() and (torch.signbit(d) & (d == 0)).any()
    if kind == "zero normals":
        n = ti.tri_normals(soup[1], soup[2])
        assert (torch.signbit(n) & (n == 0)).any(dim=1).float().mean() > 0.3
    index = canon.tris[:, 3].contiguous().view(torch.int32).numpy()
    tri_leaf = torch.from_numpy(bvh_mod.leaf_of_row(canon, index.size)[np.argsort(index)])
    rows = ibvh.instances[:, 3].contiguous().view(torch.int32).numpy()
    inst_leaf = bvh_mod.leaf_of_row(ibvh.top, rows.size)[np.argsort(rows)]
    top_lo, top_hi = _t(*ti.bvh_leaves(ibvh.top)[2:])
    lo, hi = _t(*ti.bvh_leaves(canon)[2:])
    top_reached = bvh_mod._box_reach(p, d, t_max, top_lo, top_hi)
    hits, reached_pairs = torch.zeros(p.shape[0], dtype=torch.bool), []
    for j, o in enumerate(_t(offsets)[0]):
        pj = p - o
        t_all = ti._chunk_hits(pj, d, *soup, t_max)
        accepted = torch.isfinite(t_all)
        hits |= accepted.any(dim=1)
        reached = (top_reached[:, inst_leaf[j]][:, None]
                   & ti.bvh_leaves_reached_plain(pj, d, t_max, canon)[:, tri_leaf])
        reached_pairs.append(reached.float().mean())
        assert not (accepted & ~reached).any()
        lanes, tri = torch.nonzero(accepted, as_tuple=True)
        own_t = t_all[lanes, tri]
        k = inst_leaf[j]
        top_own = bvh_mod._box_reach(p[lanes], d[lanes], own_t, top_lo[k : k + 1],
                                     top_hi[k : k + 1])[:, 0]
        assert top_own.all()
        box = tri_leaf[tri]
        assert _diagonal_reach(pj[lanes], d[lanes], own_t, lo[box], hi[box]).all()
    assert hits.sum() >= p.shape[0] // 8
    if kind != "ties":  # the cull culls: a ray reaches few of the pairs
        assert max(reached_pairs) < 0.2


def tie_problem(name, lanes=1000):
    if name == "ties":
        return instanced_tie_soup(np.random.default_rng(3), lanes)
    s = skeleton()
    offsets = np.array([[0.0, 0, 0], [0.004, 0, 0], [0, 0.006, 0]])  # overlapping copies
    return (s.v0, s.e1, s.e2), offsets, edge_rays(np.random.default_rng(4), lanes, s, offsets)


@pytest.mark.parametrize("name", ["ties", "skeleton"])
def test_tie_rule_does_not_depend_on_the_visit_order(name):
    """The (instance, triangle) pairs visited in the leaf order of both
    levels, reversed, instance by instance and leaf by leaf in shuffled
    orders, and in a shuffled order of the pairs: the dense instanced
    sweep's result bit for bit; and that result against the jitted
    reference."""
    tris, offsets, (p, d, t_max) = tie_problem(name)
    soup = _t(*tris)
    args = _t(p, d, t_max)
    o = _t(offsets)[0]
    ibvh = ti.tri_instanced_bvh(*soup, o)
    want = ti.ray_tris_nearest_instanced_plain(*args, *soup, o)
    I, N = o.shape[0], soup[0].shape[0]
    first, count, _, _ = ti.bvh_leaves(ibvh.canonical)
    rng = np.random.default_rng(1)
    nested = np.concatenate([
        j * N + np.concatenate([np.arange(first[q], first[q] + count[q])
                                for q in rng.permutation(first.size)])
        for j in rng.permutation(I)
    ])
    for order in (None, np.arange(I * N)[::-1], nested, rng.permutation(I * N)):
        got = ti.ray_tris_nearest_instanced_bvh_plain(*args, ibvh, order)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))
    assert want[2].float().mean() > 0.3
    t_ref, n_ref, hit_ref = (np.asarray(x) for x in jax.jit(ref._instanced_tris_nearest_xla)(
        *(jnp.asarray(x) for x in (p, d, t_max)), ref_instanced(tris, offsets)))
    np.testing.assert_array_equal(want[2].numpy(), hit_ref)
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (want[0].numpy(), t_ref))
    assert np.abs(ia - ib).max() <= 4
    np.testing.assert_allclose(want[1].numpy(), n_ref, rtol=0, atol=1e-6)


def _entry(p, d, lo, hi):
    """Where each lane's line enters each box ``lo``, ``hi`` [L, 3]: the
    largest near-plane distance, float64, [B, L] (a zero direction
    component bounds nothing)."""
    p, d = p.double()[:, None], d.double()[:, None]
    with np.errstate(divide="ignore"):
        inv = 1.0 / d
    a, b = (torch.from_numpy(x).double()[None] - p for x in (lo, hi))
    near = torch.where(inv < 0, b, a) * inv
    return torch.nan_to_num(near, nan=-np.inf).amax(dim=-1)


def test_tie_soup_shows_every_kind_of_tie():
    """The instanced tie soup's lanes, counted by kind, with the normal each
    kind must give: inside instance 0, coplanar halves of opposite winding
    average to 0 inside chunk 0 and give the lower chunk's normal across;
    across instances, row 0 wins with ``b``'s normal +z from the higher
    chunk (straight down) and with ``a``'s normal -z from the lower chunk
    (straight up). The walk, nearer first, meets the higher instance's top
    leaf first: for the lanes going down, the instances at ``shift`` (rows
    3-5) enter before those at 0; going up, those at ``-shift`` (rows 6-8);
    a rule keyed on the chunk alone would give the other normal."""
    tris, offsets, rays = instanced_tie_soup(np.random.default_rng(3), B)
    soup = _t(*tris)
    p, d, t_max = _t(*rays)
    o = _t(offsets)[0]
    t_hit, normal, hit = ti.ray_tris_nearest_instanced_plain(p, d, t_max, *soup, o)
    tied = [ti._chunk_hits(p - o[j], d, *soup, t_max) == t_hit[:, None] for j in range(9)]
    N = soup[0].shape[0]
    kind = torch.from_numpy(np.arange(B) % 7)

    inside = tied[0][:, 8] & tied[0][:, 9]
    assert inside.sum() >= B // 30
    assert (normal[inside] == 0).all() and not torch.signbit(normal[inside]).any()
    across = tied[0][:, 10] & tied[0][:, N - 3]
    assert across.sum() >= B // 30
    assert (normal[across] == torch.tensor([0.0, 0.0, -1.0])).all()
    assert ((tied[0][:, :512].any(dim=1) & tied[0][:, 512:].any(dim=1)).sum()) >= B // 10

    a, b = 11 + np.arange(4), N - 5 - np.arange(4)
    ibvh = ti.tri_instanced_bvh(*soup, o)
    first, count, lo, hi = ti.bvh_leaves(ibvh.top)
    rows = ibvh.instances[:, 3].contiguous().view(torch.int32).numpy()
    leaf_of = {int(r): j for j, (f, c) in enumerate(zip(first, count)) for r in rows[f:f + c]}
    entry = _entry(p, d, lo, hi)
    for lanes_kind, winner, loser, n_want in ((5, (0, b), (3, a), 1.0), (6, (0, a), (6, b), -1.0)):
        lanes = (kind == lanes_kind).numpy()
        assert lanes.sum() >= B // 8 and hit[lanes].all()
        # every instance at the two offsets ties, row 0 wins
        for j in (*range(winner[0], winner[0] + 3), *range(loser[0], loser[0] + 3)):
            rows_j = winner[1] if j < 3 else loser[1]
            assert tied[j][lanes][:, rows_j].any(dim=1).all()
        assert torch.equal(bits(normal[lanes]),
                           bits(torch.tensor([0.0, 0.0, n_want]).expand(int(lanes.sum()), 3)))
        # the higher instance's top leaf is entered first, and it is not
        # instance 0's
        high, low = leaf_of[loser[0]], leaf_of[0]
        assert high != low and (entry[lanes, high] < entry[lanes, low]).all()


def test_negative_zero_normals_come_out_positive():
    """A skeleton whose triangles lie in planes of a coordinate (normal
    components of exactly +-0), at three offsets: the dense instanced sweep
    and the two-level twin return +0.0 where the winner's component is
    -0.0, as the jitted reference does."""
    rng = np.random.default_rng(6)
    s = skeleton()
    tris = zero_normal_tris(rng, s.v0, s.e1, s.e2, share=1.0)
    soup = _t(*tris)
    n_tri = ti.tri_normals(soup[1], soup[2])
    assert (torch.signbit(n_tri) & (n_tri == 0)).any(dim=1).float().mean() > 0.3
    p, d, t_max = edge_rays(rng, B, mesh.TriangleMeshArrays(*tris), OFFSETS)
    args = _t(p, d, t_max)
    o = _t(OFFSETS)[0]
    _, n_ref, hit_ref = (np.asarray(x) for x in jax.jit(ref._instanced_tris_nearest_xla)(
        *(jnp.asarray(x) for x in (p, d, t_max)), ref_instanced(tris, OFFSETS)))
    assert hit_ref.mean() > 0.3
    assert not (np.signbit(n_ref) & (n_ref == 0)).any()
    ibvh = ti.tri_instanced_bvh(*soup, o)
    for _, normal, hit in (ti.ray_tris_nearest_instanced_plain(*args, *soup, o),
                           ti.ray_tris_nearest_instanced_bvh_plain(*args, ibvh)):
        np.testing.assert_array_equal(hit.numpy(), hit_ref)
        assert not torch.signbit(normal[normal == 0]).any()
        assert (normal[hit] == 0).any()
        np.testing.assert_allclose(normal.numpy(), n_ref, rtol=0, atol=1e-6)


def test_tri_accel_builds_nothing_on_the_cpu(monkeypatch):
    """An instanced soup on the CPU sweeps densely: ``tri_accel`` returns no
    cull operand and never calls a build; its box is the vertices' plus the
    offsets'."""
    def refuse(*args):
        raise AssertionError("a hierarchy was built on the CPU")

    monkeypatch.setattr(mesh, "tri_bvh", refuse)
    monkeypatch.setattr(mesh, "tri_instanced_bvh", refuse)
    s = skeleton()
    o = np.float32(offsets_for(5))
    tris = mesh.InstancedTriArrays(mesh.TriangleMeshArrays(*_t(s.v0, s.e1, s.e2)), _t(o)[0])
    cull, lo, hi = mesh.tri_accel(tris)
    assert cull is None
    verts = np.concatenate([s.v0, s.v0 + s.e1, s.v0 + s.e2])
    np.testing.assert_array_equal(lo.numpy(), verts.min(axis=0) + o.min(axis=0))
    np.testing.assert_array_equal(hi.numpy(), verts.max(axis=0) + o.max(axis=0))


def _instanced_operands(n_rays=16, n_tris=70, n_inst=3, device="cpu"):
    """Operands of an instanced launch, with a two-level hierarchy's arrays."""
    z = lambda *shape: torch.zeros(*shape, device=device)  # noqa: E731
    return {
        "p": z(n_rays, 3), "d": z(n_rays, 3), "t_max": z(n_rays), "v0": z(n_tris, 3),
        "e1": z(n_tris, 3), "e2": z(n_tris, 3), "offsets": z(n_inst, 3),
        "nodes": z(n_tris // 2, 16), "tris": z(n_tris, 12), "top": z(2, 16),
        "instances": z(n_inst, 4),
    }


@pytest.mark.parametrize(
    "kind, exc",
    [("dtype", TypeError), ("non-contiguous", ValueError), ("offsets-shape", ValueError),
     ("top-shape", ValueError), ("instances-shape", ValueError), ("top-dtype", TypeError),
     ("device", ValueError), ("tris-shape", ValueError), ("too-deep", ValueError),
     ("top-too-deep", ValueError), ("tie-key", ValueError)],
)
def test_instanced_wrapper_rejects_bad_inputs(kind, exc):
    """The instanced kernels' checks of the rays, the soup, the offsets and
    the two-level hierarchy: shapes, dtype, device and contiguity, each
    level's depth against its stack, and an int32 tie key that would
    overflow (instances x 512-triangle chunks >= 2^31)."""
    depth, top_depth = 5, 2

    def check(named):
        return ti._check("ray_tris_nearest_instanced", named, named["p"].shape[0],
                         named["v0"].shape[0], named["offsets"], depth=depth,
                         top_depth=top_depth)

    check(_instanced_operands())  # the unmodified inputs pass
    named = _instanced_operands()
    if kind == "dtype":
        named["offsets"] = named["offsets"].double()
    elif kind == "non-contiguous":
        named["instances"] = torch.zeros(4, 3).T
    elif kind == "offsets-shape":
        named["offsets"] = torch.zeros(3, 4)
    elif kind == "top-shape":
        named["top"] = torch.zeros(2, 12)
    elif kind == "instances-shape":
        named["instances"] = torch.zeros(2, 4)
    elif kind == "top-dtype":
        named["top"] = named["top"].double()
    elif kind == "device":
        named["top"] = named["top"].to("meta")
    elif kind == "tris-shape":
        named["tris"] = torch.zeros(69, 12)
    elif kind == "too-deep":
        depth = ti.STACK + 1
    elif kind == "top-too-deep":
        top_depth = ti.TOP_STACK + 1
    else:  # 4097 instances of 2^28 - 1 triangles (meta tensors: shapes only)
        named = _instanced_operands(n_tris=2**28 - 1, n_inst=4097, device="meta")
    with pytest.raises(exc):
        check(named)


def test_instanced_wrappers_take_only_the_two_level_hierarchy():
    """An instanced launch with another cull operand (a group-sphere tensor,
    or the flat kernels' hierarchy) raises before it reaches the card, as a
    misaligned hierarchy does."""
    s = skeleton()
    soup = _t(s.v0, s.e1, s.e2)
    o = _t(OFFSETS)[0]
    p, d, t_max = _t(*edge_rays(np.random.default_rng(2), 8, s, OFFSETS))
    spheres = torch.zeros(1 + -(-soup[0].shape[0] // 64), 4)
    for name, nearest in (("ray_tris_nearest_instanced", True),
                          ("ray_tris_occluded_instanced", False)):
        for cull in (spheres, ti.tri_bvh(*soup)):
            with pytest.raises(TypeError):
                ti._launch_instanced(name, nearest, p, d, t_max, *soup, o, cull)
        ibvh = ti.tri_instanced_bvh(*soup, o)
        shifted = torch.zeros(ibvh.top.numel() + 1)[1:].view(ibvh.top.shape)
        shifted.copy_(ibvh.top)
        misaligned = ti.InstancedTriBVH(ibvh.canonical, shifted, ibvh.instances, ibvh.top_depth)
        with pytest.raises(ValueError, match="aligned"):
            ti._launch_instanced(name, nearest, p, d, t_max, *soup, o, misaligned)
