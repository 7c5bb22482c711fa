"""The instanced leaf kernels' two-level bounding volume hierarchy, on the CPU.

``eradiate_tpu_torch/kernels/leaf_intersect.py`` builds the hierarchy the
instanced leaf-disk CUDA kernels traverse (``leaf_instanced_bvh``: the
instances' boxes of ``kernels/bvh.instance_level`` above the canonical
cloud's ``leaf_bvh``) and keeps a plain twin of the traversal's order-free
tie rule (``ray_leaves_nearest_instanced_bvh_plain``). The kernels run only
on the card, where ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``
hold them against the dense plain versions bit for bit. Here:

- the structure is valid: every instance once in the top level, with its
  offset's bits by original row; each instance box around the canonical root
  box plus the offset (in float64); the canonical level equal to
  ``leaf_bvh``'s; the depths within the stacks; two builds bitwise equal;
- the cull is conservative at both levels: every (lane, instance, disk) the
  exact test accepts on ``fl(p - offset)`` lies in a top leaf the world ray
  reaches and in a canonical leaf the translated ray reaches, with the cap
  ``t_max`` and with the cap at its own ``t``, on rims near and far, direction
  components exactly +-0 near and far, grazing rays, +-0 normals, a ragged
  lane count, the tie table, and instances 100x the cloud's size from the
  world origin (rays from near the origin and from near the instances);
- the tie rule does not depend on the visit order: (instance, disk) pairs
  visited in seeded shuffled orders give the dense instanced sweep's result
  bit for bit, which agrees with the jitted reference (``hit`` equal, ``t``
  within 4 ulp, normals 1e-6); the tie table shows ties inside a chunk,
  across chunks, across instances with opposite normals (the lower instance
  wins, also from a higher chunk) and four coincident disks with normals n,
  n, n, -n (n / 2 exactly: a float32 sum in index order misses it);
- normal components of exactly -0.0 come out +0.0 through the two-level twin;
- the instanced wrappers reject malformed operands (another cull operand
  among them) before any launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import canopy as ref
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.test_tools.disks import (
    axis_rays,
    grazing_rays,
    instanced_tie_disks,
    random_disks,
    rim_rays,
    zero_normal_disks,
)

torch.set_num_threads(1)

B = 2000
#: Three instances of a cloud of side 2, apart.
OFFSETS = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]])
#: Instances 100x the cloud's size from the world origin.
FAR = np.array([[200.0, 0, 0], [0, -200.0, 0], [140.0, 140.0, 30.0]])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


def disks(N=700, seed=3):
    return random_disks(np.random.default_rng(seed), N)


def bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def offsets_for(I, seed=1):
    """``I`` crown positions in a 100 x 100 square (a cloud of side 2),
    HET01's layout at this scale."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-50, 50, (I, 2)), np.zeros((I, 1))], axis=1)


@pytest.mark.parametrize("I", [1, 3, 5, 15, 17])
def test_structure_is_valid(I):
    c, n, r = disks()
    table = _t(c, n, r)
    offsets = np.asarray(offsets_for(I), np.float32)
    ibvh = li.leaf_instanced_bvh(*table, torch.from_numpy(offsets))
    assert 1 <= ibvh.top_depth <= li.TOP_STACK and 1 <= ibvh.canonical.depth <= li.STACK
    assert ibvh.top.shape[1] == 16 and ibvh.instances.shape == (I, 4)
    assert ibvh.top.dtype == ibvh.instances.dtype == torch.float32

    # the canonical level is the flat hierarchy of the cloud, bit for bit
    flat = li.leaf_bvh(*table)
    assert ibvh.canonical.depth == flat.depth
    for x, y in ((ibvh.canonical.nodes, flat.nodes), (ibvh.canonical.disks, flat.disks)):
        assert torch.equal(bits(x), bits(y))

    # every instance once, its offset's bits by original row
    inst = ibvh.instances.numpy()
    row = inst[:, 3].view(np.int32)
    assert sorted(row) == list(range(I))
    np.testing.assert_array_equal(inst[:, :3].view(np.int32), offsets[row].view(np.int32))

    # each instance in one top leaf, whose box holds the canonical root box
    # plus the offset, in float64
    first, count, lo, hi = li.bvh_leaves(ibvh.top)
    leaf = np.full(I, -1)
    for j, (a, k) in enumerate(zip(first, count)):
        assert (leaf[a : a + k] == -1).all()
        leaf[a : a + k] = j
    assert (leaf >= 0).all() and count.max() <= li.LEAF
    _, _, clo, chi = li.bvh_leaves(flat)
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
    again = li.leaf_instanced_bvh(*table, torch.from_numpy(offsets))
    assert again.top_depth == ibvh.top_depth and again.canonical.depth == ibvh.canonical.depth
    for x, y in ((again.top, ibvh.top), (again.instances, ibvh.instances),
                 (again.canonical.nodes, ibvh.canonical.nodes),
                 (again.canonical.disks, ibvh.canonical.disks)):
        assert torch.equal(bits(x), bits(y))


def test_build_rejects_what_the_kernels_cannot_take(monkeypatch):
    table = _t(*disks())
    with pytest.raises(ValueError):
        li.leaf_instanced_bvh(*table, torch.zeros(0, 3))
    with pytest.raises(ValueError):
        li.leaf_instanced_bvh(*table, torch.zeros(3, 2))
    with pytest.raises(TypeError):
        li.leaf_instanced_bvh(*table, torch.zeros(3, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        li.leaf_instanced_bvh(*(x[:0] for x in table), torch.zeros(3, 3))
    monkeypatch.setattr(bvh_mod, "TOP_STACK", 2)  # 17 instances in leaves of 4 need 3 levels
    with pytest.raises(ValueError, match="deep"):
        li.leaf_instanced_bvh(*table, torch.from_numpy(np.float32(offsets_for(17))))


def problem(kind, seed=11):
    """``(c, n, r), offsets, (p, d, t_max)`` numpy for a kind of the cull
    stress."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return instanced_tie_disks(rng, B)
    c, n, r = disks()
    if kind.startswith("zero normals"):
        n = zero_normal_disks(np.random.default_rng(4), n, share=1.0)
    offsets = FAR if kind.startswith("far offsets") else OFFSETS
    if kind == "rims far":
        rays = rim_rays(rng, B, c, n, r, offsets, distance=100.0)
    elif kind.startswith("zero components"):
        rays = axis_rays(rng, B, c, n, r, 100.0 if kind.endswith("far") else 1.0, offsets)
    elif kind == "grazing":
        rays = grazing_rays(rng, B, c, n, r, offsets=offsets)
    elif kind == "far offsets, origins near the origin":
        rays = rim_rays(rng, B, c, n, r, offsets, origins=rng.uniform(-1, 1, (B, 3)))
    elif kind == "ragged":
        rays = tuple(a[: B - 77] for a in rim_rays(rng, B, c, n, r, offsets, distance=10.0))
    else:  # rims near, zero normals, far offsets with origins near the instances
        rays = rim_rays(rng, B, c, n, r, offsets)
    return (c, n, r), offsets, rays


def _diagonal_reach(p, d, cap, lo, hi):
    """``_box_reach`` of each lane against its own box: bool [L]."""
    out = []
    for s in range(0, p.shape[0], 512):
        sl = slice(s, s + 512)
        out.append(torch.diagonal(bvh_mod._box_reach(p[sl], d[sl], cap[sl], lo[sl], hi[sl])))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool)


@pytest.mark.parametrize(
    "kind", ["rims near", "rims far", "zero components near", "zero components far",
             "grazing", "zero normals, rims", "ragged", "ties",
             "far offsets, origins near the origin", "far offsets, origins near the instances"]
)
def test_cull_is_conservative(kind):
    """Every pair the exact test accepts on the translated ray within
    ``t_max`` lies in a top leaf the world ray reaches and in a canonical
    leaf the translated ray reaches, with the cap ``t_max`` and with the cap
    at its own ``t`` (the nearest hit's traversal caps both levels at the
    best ``t`` so far). The world ray's point at the computed ``t`` lies
    within a hundredth of the box growth of the disk's exact box moved by
    the offset."""
    (c, n, r), offsets, rays = problem(kind)
    table = _t(c, n, r)
    ibvh = li.leaf_instanced_bvh(*table, *_t(offsets))
    canon = ibvh.canonical
    p, d, t_max = _t(*rays)
    if "zero components" in kind:
        assert (d == 0).any(dim=1).all() and (torch.signbit(d) & (d == 0)).any()
    index = canon.disks[:, 3].contiguous().view(torch.int32).numpy()
    disk_leaf = torch.from_numpy(bvh_mod.leaf_of_row(canon, index.size)[np.argsort(index)])
    rows = ibvh.instances[:, 3].contiguous().view(torch.int32).numpy()
    inst_leaf = bvh_mod.leaf_of_row(ibvh.top, rows.size)[np.argsort(rows)]
    top_lo, top_hi = _t(*li.bvh_leaves(ibvh.top)[2:])
    lo, hi = _t(*li.bvh_leaves(canon)[2:])
    top_reached = bvh_mod._box_reach(p, d, t_max, top_lo, top_hi)
    c64, n64, r64 = (x.double() for x in table)
    unit = n64 / torch.linalg.norm(n64, dim=1, keepdim=True)
    half = r64[:, None] * torch.sqrt(torch.clamp(1.0 - unit**2, 0.0, 1.0))
    hits, reached_pairs = torch.zeros(p.shape[0], dtype=torch.bool), []
    for j, o in enumerate(_t(offsets)[0]):
        pj = p - o
        t_all = li._chunk_hits(pj, d, *table, t_max)
        accepted = torch.isfinite(t_all)
        hits |= accepted.any(dim=1)
        reached = (top_reached[:, inst_leaf[j]][:, None]
                   & li.bvh_leaves_reached_plain(pj, d, t_max, canon)[:, disk_leaf])
        reached_pairs.append(reached.float().mean())
        assert not (accepted & ~reached).any()
        lanes, disk = torch.nonzero(accepted, as_tuple=True)
        own_t = t_all[lanes, disk]
        k = inst_leaf[j]
        top_own = bvh_mod._box_reach(p[lanes], d[lanes], own_t, top_lo[k : k + 1],
                                     top_hi[k : k + 1])[:, 0]
        assert top_own.all()
        box = disk_leaf[disk]
        assert _diagonal_reach(pj[lanes], d[lanes], own_t, lo[box], hi[box]).all()
        # the margin, in the world frame
        o64 = o.double()
        q = p[lanes].double() + d[lanes].double() * own_t.double()[:, None]
        lo64, hi64 = (c64 - half)[disk] + o64, (c64 + half)[disk] + o64
        outside = torch.maximum(lo64 - q, q - hi64).amax(dim=1)
        scale = (torch.maximum((lo64 - p[lanes]).abs(), (hi64 - p[lanes]).abs()).sum(dim=1)
                 + p[lanes].double().abs().sum(dim=1) + o64.abs().sum())
        assert (outside <= 1e-2 * bvh_mod.BOX_SLACK * scale).all()
    assert hits.sum() >= p.shape[0] // 8
    if kind != "ties":  # the cull culls: a ray reaches few of the pairs
        assert max(reached_pairs) < 0.2


def tie_problem(name, lanes=1000):
    if name == "ties":
        return instanced_tie_disks(np.random.default_rng(3), lanes)
    c, n, r = disks()
    offsets = np.array([[0.0, 0, 0], [0.5, 0, 0], [0, 0.7, 0]])  # overlapping copies
    return (c, n, r), offsets, rim_rays(np.random.default_rng(4), lanes, c, n, r, offsets)


@pytest.mark.parametrize("name", ["ties", "random"])
def test_tie_rule_does_not_depend_on_the_visit_order(name):
    """The (instance, disk) pairs visited in the leaf order of both levels,
    reversed, instance by instance and leaf by leaf in shuffled orders, and
    in a shuffled order of the pairs: the dense instanced sweep's result bit
    for bit; and that result against the jitted reference."""
    (c, n, r), offsets, (p, d, t_max) = tie_problem(name)
    table = _t(c, n, r)
    args = _t(p, d, t_max)
    o = _t(offsets)[0]
    ibvh = li.leaf_instanced_bvh(*table, o)
    want = li.ray_leaves_nearest_instanced_plain(*args, *table, o)
    I, N = o.shape[0], c.shape[0]
    first, count, _, _ = li.bvh_leaves(ibvh.canonical)
    rng = np.random.default_rng(1)
    nested = np.concatenate([
        j * N + np.concatenate([np.arange(first[q], first[q] + count[q])
                                for q in rng.permutation(first.size)])
        for j in rng.permutation(I)
    ])
    for order in (None, np.arange(I * N)[::-1], nested, rng.permutation(I * N)):
        got = li.ray_leaves_nearest_instanced_bvh_plain(*args, ibvh, order)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))
    assert want[2].float().mean() > 0.3
    inst = ref.InstancedLeafArrays(
        canonical=ref.LeafCloudArrays(*(jnp.asarray(np.asarray(x, np.float32)) for x in (c, n, r))),
        offsets=jnp.asarray(np.asarray(offsets, np.float32)),
    )
    t_ref, n_ref, hit_ref = (np.asarray(x) for x in jax.jit(ref._instanced_nearest_xla)(
        *(jnp.asarray(x) for x in (p, d, t_max)), inst))
    np.testing.assert_array_equal(want[2].numpy(), hit_ref)
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (want[0].numpy(), t_ref))
    assert np.abs(ia - ib).max() <= 4
    np.testing.assert_allclose(want[1].numpy(), n_ref, rtol=0, atol=1e-6)


def test_tie_table_shows_every_kind_of_tie():
    """The tie table's lanes, counted by kind, with the normal each kind
    must give: opposite normals inside chunk 0 average to +0; across two
    chunks the lower chunk's wins; across instances the lower instance's
    wins, from a higher chunk (instance 0's copy b against instance 1's a)
    and from a lower one (instance 0's a against instance 2's b); four
    coincident disks with normals n, n, n, -n give n / 2 exactly, where a
    float32 sum in index order gives another value."""
    (c, n, r), offsets, rays = instanced_tie_disks(np.random.default_rng(3), B)
    table = _t(c, n, r)
    p, d, t_max = _t(*rays)
    o = _t(offsets)[0]
    t_hit, normal, hit = li.ray_leaves_nearest_instanced_plain(p, d, t_max, *table, o)
    tied = [li._chunk_hits(p - o[j], d, *table, t_max) == t_hit[:, None] for j in range(3)]
    N = c.shape[0]

    inside = tied[0][:, 0] & tied[0][:, 1]
    assert inside.sum() >= B // 30
    assert (normal[inside] == 0).all() and not torch.signbit(normal[inside]).any()
    across = tied[0][:, 2] & tied[0][:, N - 1]
    assert across.sum() >= B // 30
    assert torch.equal(bits(normal[across]), bits(table[1][2].expand(int(across.sum()), 3)))

    quad = tied[0][:, 6:10].all(dim=1)
    assert quad.sum() >= B // 30
    half = n[6] * np.float32(0.5)
    assert torch.equal(bits(normal[quad]), bits(torch.from_numpy(half).expand(int(quad.sum()), 3)))
    in_order = (((n[6] + n[7]) + n[8]) + n[9]) / np.float32(4)
    assert (in_order != half).any()  # the float32 sum in index order misses it

    a, b = np.arange(10, 14), N - 3 - np.arange(4)
    assert (n[a, 0] == 0).all()
    for first_inst, first_rows, second_inst, second_rows in ((0, b, 1, a), (0, a, 2, b)):
        lanes = 0
        for ra, rb in zip(first_rows, second_rows):
            both = tied[first_inst][:, ra] & tied[second_inst][:, rb]
            lanes += int(both.sum())
            # the lower instance's disk wins, with the opposite normal of the
            # other's
            want = table[1][ra].expand(int(both.sum()), 3)
            assert torch.equal(bits(normal[both]), bits(want + 0.0))
            assert torch.equal(table[1][rb][1:], -table[1][ra][1:])
        assert lanes >= B // 30
    # a rule keyed on the chunk alone would give instance 1's a on the
    # first kind: a different normal
    assert (n[b] != n[a]).any(axis=1).all()


def test_negative_zero_normals_come_out_positive():
    """Disks with normal components of exactly +-0 at three offsets: the
    dense instanced sweep and the two-level twin return +0.0 where the
    winner's component is -0.0, bit for bit as the jitted reference does."""
    rng = np.random.default_rng(6)
    c, n, r = disks()
    n = zero_normal_disks(rng, n, share=1.0)
    p, d, t_max = rim_rays(rng, B, c, n, r, OFFSETS)
    table = _t(c, n, r)
    args = _t(p, d, t_max)
    o = _t(OFFSETS)[0]
    inst = ref.InstancedLeafArrays(
        canonical=ref.LeafCloudArrays(*(jnp.asarray(np.asarray(x, np.float32)) for x in (c, n, r))),
        offsets=jnp.asarray(np.asarray(OFFSETS, np.float32)),
    )
    _, n_ref, hit_ref = (np.asarray(x) for x in jax.jit(ref._instanced_nearest_xla)(
        *(jnp.asarray(x) for x in (p, d, t_max)), inst))
    assert hit_ref.mean() > 0.3
    assert not (np.signbit(n_ref) & (n_ref == 0)).any()
    n32 = np.asarray(n, np.float32)
    assert (np.signbit(n32) & (n32 == 0)).any(axis=1).mean() > 0.3
    ibvh = li.leaf_instanced_bvh(*table, o)
    for _, normal, hit in (li.ray_leaves_nearest_instanced_plain(*args, *table, o),
                           li.ray_leaves_nearest_instanced_bvh_plain(*args, ibvh)):
        np.testing.assert_array_equal(hit.numpy(), hit_ref)
        assert not torch.signbit(normal[normal == 0]).any()
        np.testing.assert_array_equal(normal.numpy().view(np.int32)[hit_ref],
                                      n_ref.view(np.int32)[hit_ref])


def _instanced_operands(n_rays=16, n_disks=70, n_inst=3, device="cpu"):
    """Operands of an instanced launch, with a two-level hierarchy's arrays."""
    z = lambda *shape: torch.zeros(*shape, device=device)  # noqa: E731
    return {
        "p": z(n_rays, 3), "d": z(n_rays, 3), "t_max": z(n_rays), "centers": z(n_disks, 3),
        "normals": z(n_disks, 3), "radii": z(n_disks), "offsets": z(n_inst, 3),
        "nodes": z(n_disks // 2, 16), "disks": z(n_disks, 12), "top": z(2, 16),
        "instances": z(n_inst, 4),
    }


@pytest.mark.parametrize(
    "kind, exc",
    [("dtype", TypeError), ("non-contiguous", ValueError), ("offsets-shape", ValueError),
     ("top-shape", ValueError), ("instances-shape", ValueError), ("top-dtype", TypeError),
     ("device", ValueError), ("disks-shape", ValueError), ("too-deep", ValueError),
     ("top-too-deep", ValueError), ("tie-key", ValueError)],
)
def test_instanced_wrapper_rejects_bad_inputs(kind, exc):
    """The instanced kernels' checks of the rays, the table, the offsets and
    the two-level hierarchy: shapes, dtype, device and contiguity, each
    level's depth against its stack, and an int32 tie key that would
    overflow (instances x 512-disk chunks >= 2^31)."""
    depth, top_depth = 5, 2

    def check(named):
        return li._check("ray_leaves_nearest_instanced", named, named["p"].shape[0],
                         named["centers"].shape[0], named["offsets"], depth=depth,
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
    elif kind == "disks-shape":
        named["disks"] = torch.zeros(69, 12)
    elif kind == "too-deep":
        depth = li.STACK + 1
    elif kind == "top-too-deep":
        top_depth = li.TOP_STACK + 1
    else:  # 4097 instances of 2^28 - 1 disks (meta tensors: shapes only)
        named = _instanced_operands(n_disks=2**28 - 1, n_inst=4097, device="meta")
    with pytest.raises(exc):
        check(named)


def test_instanced_wrappers_take_only_the_two_level_hierarchy():
    """An instanced launch with another cull operand (a group-sphere tensor,
    or the flat kernels' hierarchy) raises before it reaches the card."""
    c, n, r = _t(*disks())
    o = _t(OFFSETS)[0]
    p, d, t_max = _t(*rim_rays(np.random.default_rng(2), 8, *disks(), OFFSETS))
    spheres = torch.zeros(1 + -(-c.shape[0] // 128), 4)
    for cull in (spheres, li.leaf_bvh(c, n, r)):
        for name, nearest in (("ray_leaves_nearest_instanced", True),
                              ("ray_leaves_occluded_instanced", False)):
            with pytest.raises(TypeError):
                li._launch_instanced(name, nearest, p, d, t_max, c, n, r, o, cull)
