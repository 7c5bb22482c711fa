"""The triangle-mesh geometry of the port against the JAX package, on the CPU.

The plain versions of the ray/triangle sweep kernels
(``eradiate_tpu_torch/kernels/tri_intersect.py``) and the dispatchers of
``eradiate_tpu_torch/ops/mesh.py`` run on the same numpy inputs as the
reference's functions under ``jax.jit`` (XLA:CPU contracts products and sums
into fused multiply-adds there, which the plain versions reproduce). Stated
tolerances:

- against jitted ``mesh.ray_tris_nearest``, ``ray_tris_occluded``,
  ``_instanced_tris_nearest_xla``, ``tri_nearest`` and ``tri_occluded``:
  ``hit`` and ``occluded`` equal on every lane, ``t`` within 4 ulp, normals
  within 1e-6. The meshes are closed cylinders (a wood skeleton) and the rays
  are aimed at their shared edges, at vertices, at interior points and just
  beside edges, from 0.5-3 m and from 50-300 m, so that the last bit of the
  barycentric test decides; lanes with exact ties of ``t`` are counted;
- against the Pallas kernels in interpret mode, on the inputs and with the
  tolerances of ``tests/unit/test_tri_intersect_pallas.py`` (``hit`` and
  ``occluded`` equal, ``t`` 1e-5 relative, normals 1e-5) and of
  ``tests/unit/test_instanced_canopy.py`` (the TPU kernel translates the
  triangles, the XLA form and the port the ray: under 2% of the lanes flip,
  ``t`` within 1e-4 relative where both hit);
- ``mesh_from_vertices``, ``cylinder_mesh``, ``cone_mesh`` and
  ``tri_accel``'s box: bitwise. ``tri_accel`` builds no cull operand on the
  CPU; the kernels' hierarchies are tested in ``tests/test_torch_tri_bvh.py``
  (flat) and ``tests/test_torch_tri_instanced_bvh.py`` (two levels).

The CUDA kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import mesh as ref
from eradiate_tpu.ops.pallas import tri_intersect as ref_pallas
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops import mesh
from eradiate_tpu_torch.test_tools.meshes import edge_rays, wood_skeleton

torch.set_num_threads(1)

B = 3000
OFFSETS = np.array([[0.0, 0.0, 0.0], [0.02, 0.0, 0.0], [-0.013, 0.031, 0.0]], np.float32)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, order="C")) for a in arrays]


def skeleton():
    """A 20-branch wood skeleton in km: 516 triangles, one full 512-chunk
    and a ragged second one."""
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=20)
    return mesh.mesh_from_vertices((v * 1e-3).astype(np.float32), f)


def problem(far, instanced, seed=1):
    """``(p, d, t_max)`` aimed at the skeleton's edges and vertices."""
    soup = skeleton()
    rng = np.random.default_rng(seed + 10 * far + 100 * instanced)
    return edge_rays(rng, B, soup, OFFSETS if instanced else None, 1e-3 if far else 1e-5)


def ref_tris(soup=None, instanced=False):
    soup = skeleton() if soup is None else soup
    tris = ref.TriangleMeshArrays(*(jnp.asarray(x) for x in (soup.v0, soup.e1, soup.e2)))
    return ref.InstancedTriArrays(tris, jnp.asarray(OFFSETS)) if instanced else tris


def port_tris(soup=None, instanced=False):
    soup = skeleton() if soup is None else soup
    tris = mesh.TriangleMeshArrays(*_t(soup.v0, soup.e1, soup.e2))
    return mesh.InstancedTriArrays(tris, _t(OFFSETS)[0]) if instanced else tris


def held(got, want, min_hits=B // 4, max_hits=B - 1):
    """The gate against the jitted reference; hits and, unless ``max_hits``
    says otherwise, misses both occur."""
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    np.testing.assert_array_equal(got[-1], want[-1])
    assert min_hits <= int(want[-1].sum()) <= max_hits
    if len(got) == 3:
        assert _ulps(got[0], want[0]).max() <= 4
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
        # misses keep the cap and the normal (0, 0, 1)
        miss = ~want[2]
        np.testing.assert_array_equal(got[1][miss], np.tile([0.0, 0.0, 1.0], (miss.sum(), 1)))


@pytest.fixture(scope="module")
def jitted():
    """The reference functions under jit, compiled once per argument shape."""
    return {
        "nearest": jax.jit(ref.ray_tris_nearest),
        "occluded": jax.jit(ref.ray_tris_occluded),
        "instanced": jax.jit(ref._instanced_tris_nearest_xla),
        "tri_nearest": jax.jit(ref.tri_nearest),
        "tri_occluded": jax.jit(ref.tri_occluded),
    }


def test_procedural_meshes_bitwise():
    for fn, args in (("cylinder_mesh", (0.4, 3.0)), ("cone_mesh", (0.3, 2.0))):
        for kw in ({}, {"center": (1.0, -2.0, 0.5), "n_seg": 7}):
            got, want = getattr(mesh, fn)(*args, **kw), getattr(ref, fn)(*args, **kw)
            for g, w in zip(got, want):
                assert g.dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, w)
    v, f = mesh.cylinder_mesh(0.25, 6.6, center=(0.0, 0.0, -0.6))
    assert f.shape == (36, 3)  # a trunk: 12 segments, capped
    v32 = v.astype(np.float32)
    got, want = mesh.mesh_from_vertices(v32, f), ref.mesh_from_vertices(jnp.asarray(v32), f)
    for k in ("v0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))


@pytest.mark.parametrize("far", [False, True])
def test_plain_sweeps_match_jitted_reference(jitted, far):
    p, d, t_max = problem(far, instanced=False)
    soup = port_tris()
    args = _t(p, d, t_max) + [soup.v0, soup.e1, soup.e2]
    held(ti.ray_tris_nearest_plain(*args), jitted["nearest"](p, d, t_max, ref_tris()))
    held(ti.ray_tris_occluded_plain(*args), jitted["occluded"](p, d, t_max, ref_tris()))


@pytest.mark.parametrize("far", [False, True])
def test_instanced_plain_sweep_matches_jitted_reference(jitted, far):
    p, d, t_max = problem(far, instanced=True)
    soup = port_tris()
    args = _t(p, d, t_max) + [soup.v0, soup.e1, soup.e2] + _t(OFFSETS)
    want = jitted["instanced"](p, d, t_max, ref_tris(instanced=True))
    held(ti.ray_tris_nearest_instanced_plain(*args), want)
    # the any-hit scan agrees with the nearest hit's flag
    occ = ti.ray_tris_occluded_instanced_plain(*args)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("far", [False, True])
def test_dispatchers_match_jitted_reference(jitted, far, instanced):
    """``tri_nearest`` and ``tri_occluded``: the box advance, the sweep, and
    ``t0 + t_loc``; half of the rays start a kilometre away, so the advance
    moves them."""
    p, d, t_max = problem(far, instanced)
    back = np.random.default_rng(5).uniform(0.0, 1.0, B).astype(np.float32) * (np.arange(B) % 2)
    p = (p - d * back[:, None]).astype(np.float32)
    t_max = (t_max + back).astype(np.float32)
    rt, pt = ref_tris(instanced=instanced), port_tris(instanced=instanced)
    accel, ref_accel = mesh.tri_accel(pt), ref.tri_accel(jnp.asarray(p), rt)
    assert accel[0] is None and ref_accel[0] is None  # no cull operand on the CPU
    for g, w in zip(accel[1:], ref_accel[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    held(mesh.tri_nearest(*_t(p, d, t_max), pt, accel),
         jitted["tri_nearest"](p, d, t_max, rt), min_hits=B // 8)
    held(mesh.tri_occluded(*_t(p, d, t_max), pt),
         jitted["tri_occluded"](p, d, t_max, rt), min_hits=B // 8)


def test_ties_average_inside_a_chunk_and_first_wins_across(jitted):
    """Exact ties of ``t``: a triangle and its copy scaled by two about
    ``v0`` (every product scales by a power of two, so ``t`` is the same bit
    for bit), once inside one 512-triangle chunk and once across the chunk
    boundary, and a copy with the opposite winding. Rays at interior points
    of the first triangles."""
    rng = np.random.default_rng(3)
    n = 600
    v0 = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 2e-3, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 2e-3, (n, 3)).astype(np.float32)
    v0[1], e1[1], e2[1] = v0[0], 2 * e1[0], 2 * e2[0]  # tie inside chunk 0
    v0[599], e1[599], e2[599] = v0[2], 2 * e1[2], 2 * e2[2]  # tie across the boundary
    v0[3], e1[3], e2[3] = v0[4], e2[4], e1[4]  # opposite winding
    soup = mesh.TriangleMeshArrays(v0, e1, e2)
    k = np.arange(B) % 6
    a, b = rng.uniform(0.05, 0.4, B), rng.uniform(0.05, 0.4, B)
    target = v0[k] + a[:, None] * e1[k] + b[:, None] * e2[k]
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    p = (target + 0.05 * back).astype(np.float32)
    d = target - p
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(B, 1.0, np.float32)
    want = jitted["nearest"](p, d, t_max, ref_tris(soup))
    got = ti.ray_tris_nearest_plain(*_t(p, d, t_max, v0, e1, e2))
    held(got, want, max_hits=B)
    # count the lanes whose nearest distance is shared by two triangles
    t_all = torch.cat([
        ti._chunk_hits(*_t(p, d), *_t(v0[s], e1[s], e2[s]), _t(t_max)[0])
        for s in (slice(0, 512), slice(512, n))
    ], dim=1)
    ties = (t_all == got[0][:, None]).sum(dim=1).numpy()
    assert (ties[np.asarray(want[2])] >= 1).all()
    assert (ties > 1).sum() >= B // 6  # the scaled copies tie


def test_padding_never_hits(jitted):
    """The reference pads the last chunk with zero-edge triangles at
    z = -1e9; the plain version has no padding. Rays straight down, beside
    the soup, with an unbounded cap: no hit in either."""
    soup = skeleton()
    p = np.tile(np.array([[0.5, 0.5, 1.0]], np.float32), (B, 1))
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (B, 1))
    t_max = np.full(B, 3e9, np.float32)
    want = jitted["nearest"](p, d, t_max, ref_tris(soup))
    got = ti.ray_tris_nearest_plain(*_t(p, d, t_max, soup.v0, soup.e1, soup.e2))
    assert not np.asarray(want[2]).any() and not got[2].any()
    np.testing.assert_array_equal(got[0].numpy(), t_max)


def pallas_problem(n_rays=700, n_tris=900, seed=2):
    """``tests/unit/test_tri_intersect_pallas.py`` ``make_problem``."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-0.02, 0.02, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.001, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.001, (n_tris, 3)).astype(np.float32)
    p = rng.uniform(-0.03, 0.03, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d, np.full(n_rays, 0.1, dtype=np.float32), v0, e1, e2


def test_plain_sweeps_match_pallas_interpret():
    args = pallas_problem()
    kw = dict(block_b=256, block_n=256, interpret=True)
    t_pl, n_pl, hit_pl = map(np.asarray, ref_pallas.ray_tris_nearest_pallas(*args, **kw))
    t, n, hit = (o.numpy() for o in ti.ray_tris_nearest_plain(*_t(*args)))
    np.testing.assert_array_equal(hit, hit_pl)
    assert hit.sum() > 20
    np.testing.assert_allclose(t[hit], t_pl[hit], rtol=1e-5)
    np.testing.assert_allclose(n[hit], n_pl[hit], atol=1e-5)
    occ_pl = np.asarray(ref_pallas.ray_tris_occluded_pallas(*args, **kw))
    np.testing.assert_array_equal(ti.ray_tris_occluded_plain(*_t(*args)).numpy(), occ_pl)


def test_instanced_plain_sweeps_match_pallas_interpret():
    """``TestInstancedTris``: five trunks, rays from 20 km above."""
    v, f = mesh.cylinder_mesh(0.4, 3.0, n_seg=10)
    soup = mesh.mesh_from_vertices(v.astype(np.float32), f)
    rng = np.random.default_rng(11)
    off = np.concatenate([rng.uniform(-30, 30, (5, 2)), np.zeros((5, 1))], 1).astype(np.float32)
    n_rays = 200
    p = off[rng.integers(0, 5, n_rays)] + rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(np.float32)
    p[:, 2] = 20.0
    d = 0.04 * rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = (p.astype(np.float32), d.astype(np.float32), np.full(n_rays, 50.0, np.float32),
            soup.v0, soup.e1, soup.e2, off)
    kw = dict(block_b=256, block_n=256, interpret=True)
    t_pl, _, hit_pl = map(np.asarray, ref_pallas.ray_tris_nearest_instanced_pallas(*args, **kw))
    t, _, hit = (o.numpy() for o in ti.ray_tris_nearest_instanced_plain(*_t(*args)))
    assert (hit != hit_pl).mean() < 0.02
    both = hit & hit_pl
    assert both.sum() > 15
    np.testing.assert_allclose(t[both], t_pl[both], rtol=1e-4, atol=1e-5)
    occ_pl = np.asarray(ref_pallas.ray_tris_occluded_instanced_pallas(*args, **kw))
    occ = ti.ray_tris_occluded_instanced_plain(*_t(*args)).numpy()
    assert (occ != occ_pl).mean() < 0.02


def test_sweep_spheres_operand():
    """The cull operands: the two-level hierarchy for the instanced kernels,
    the hierarchy for the flat ones (``tests/test_torch_tri_instanced_bvh.py``
    and ``tests/test_torch_tri_bvh.py`` check their contents): contiguous,
    16-byte aligned float4 rows, the canonical level the flat one's."""
    soup = skeleton()
    tris = _t(soup.v0, soup.e1, soup.e2)
    ibvh = ti.tri_instanced_bvh(*tris, _t(OFFSETS)[0])
    assert ibvh.top.shape[1] == 16 and ibvh.instances.shape == (3, 4)
    assert 1 <= ibvh.top_depth <= ti.TOP_STACK
    bvh = ti.tri_bvh(*tris)
    assert bvh.tris.shape == (516, 12) and bvh.nodes.shape[1] == 16
    for t in (bvh.nodes, bvh.tris, ibvh.top, ibvh.instances, ibvh.canonical.nodes,
              ibvh.canonical.tris):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    for x, y in ((ibvh.canonical.nodes, bvh.nodes), (ibvh.canonical.tris, bvh.tris)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_wrappers_run_the_plain_versions_on_cpu():
    p, d, t_max = (a[:300] for a in problem(False, instanced=True))
    soup = port_tris()
    flat = _t(p, d, t_max) + [soup.v0, soup.e1, soup.e2]
    inst = flat + _t(OFFSETS)
    before = dict(ti.launches)
    for name, args in (("ray_tris_nearest", flat), ("ray_tris_occluded", flat),
                       ("ray_tris_nearest_instanced", inst),
                       ("ray_tris_occluded_instanced", inst)):
        got, want = getattr(ti, name)(*args), getattr(ti, name + "_plain")(*args)
        for g, w in zip(*((x if isinstance(x, tuple) else (x,)) for x in (got, want))):
            assert torch.equal(g, w)
    assert ti.launches == before  # no kernel launch for CPU tensors
    assert set(before) == {"ray_tris_nearest", "ray_tris_occluded",
                           "ray_tris_nearest_instanced", "ray_tris_occluded_instanced"}


def _named(n_rays=16, n_tris=70, instances=None):
    """Operands of an instanced launch (``instances``: with the two-level
    hierarchy's ``top`` and ``instances``) or of a flat one, with the
    (canonical) hierarchy's arrays as ``nodes`` and ``tris``."""
    named = {
        "p": torch.zeros(n_rays, 3), "d": torch.zeros(n_rays, 3), "t_max": torch.zeros(n_rays),
        "v0": torch.zeros(n_tris, 3), "e1": torch.zeros(n_tris, 3), "e2": torch.zeros(n_tris, 3),
        "nodes": torch.zeros(max(n_tris // 2, 1), 16), "tris": torch.zeros(n_tris, 12),
    }
    if instances:
        named["offsets"] = torch.zeros(instances, 3)
        named["top"] = torch.zeros(2, 16)
        named["instances"] = torch.zeros(instances, 4)
    return named


@pytest.mark.parametrize(
    "kind, exc",
    [("dtype", TypeError), ("non-contiguous", ValueError), ("rays-shape", ValueError),
     ("tris-shape", ValueError), ("spheres-shape", ValueError), ("offsets-shape", ValueError),
     ("no-triangle", ValueError), ("device", ValueError),
     ("bvh-nodes-shape", ValueError), ("bvh-tris-shape", ValueError),
     ("bvh-dtype", TypeError), ("bvh-device", ValueError), ("bvh-non-contiguous", ValueError),
     ("bvh-too-deep", ValueError)],
)
def test_wrapper_rejects_bad_inputs(kind, exc):
    """The instanced kernels' checks, and (``bvh-``) the flat kernels' checks
    of the hierarchy: its arrays' shape, dtype, device and contiguity, and a
    tree deeper than the kernels' stack. ``spheres-shape``: a group-sphere
    table's [M, 4] where the instanced kernels' top level goes."""
    flat = kind.startswith("bvh-")
    depth = 5

    def check(named):
        name = "ray_tris_nearest" if flat else "ray_tris_nearest_instanced"
        return ti._check(name, named, named["p"].shape[0], named["v0"].shape[0],
                         named.get("offsets"), depth=depth, top_depth=None if flat else 2)

    check(_named(instances=None if flat else 3))  # the unmodified inputs pass
    named = _named(instances=None if flat else 3)
    if kind == "dtype":
        named["e1"] = named["e1"].double()
    elif kind == "non-contiguous":
        named["d"] = torch.zeros(3, 16).T
    elif kind == "rays-shape":
        named["t_max"] = torch.zeros(15)
    elif kind == "tris-shape":
        named["e2"] = torch.zeros(69, 3)
    elif kind == "spheres-shape":
        named["top"] = torch.zeros(1 + -(-70 // 64), 4)
    elif kind == "offsets-shape":
        named["offsets"] = torch.zeros(3, 2)
    elif kind == "no-triangle":
        named = _named(n_tris=0, instances=3)
    elif kind == "device":
        named["v0"] = named["v0"].to("meta")
    elif kind == "bvh-nodes-shape":
        named["nodes"] = torch.zeros(35, 12)
    elif kind == "bvh-tris-shape":
        named["tris"] = torch.zeros(69, 12)
    elif kind == "bvh-dtype":
        named["nodes"] = named["nodes"].double()
    elif kind == "bvh-device":
        named["tris"] = named["tris"].to("meta")
    elif kind == "bvh-non-contiguous":
        named["tris"] = torch.zeros(12, 70).T
    else:
        depth = ti.STACK + 1
    with pytest.raises(exc):
        check(named)


def test_flat_wrappers_take_only_the_hierarchy():
    """A flat launch with another cull operand (a group-sphere table, or the
    instanced kernels' two-level hierarchy) raises before it reaches the
    card."""
    soup = skeleton()
    tris = _t(soup.v0, soup.e1, soup.e2)
    spheres = torch.zeros(1 + -(-516 // 64), 4)
    for cull in (spheres, ti.tri_instanced_bvh(*tris, _t(OFFSETS)[0])):
        for name, nearest in (("ray_tris_nearest", True), ("ray_tris_occluded", False)):
            with pytest.raises(TypeError):
                ti._launch_flat(name, nearest, *_t(*problem(False, False)), *tris, cull)


def test_wrappers_reject_other_devices():
    a = {k: v.to("meta") for k, v in _named(instances=2).items()}
    flat = [a[k] for k in ("p", "d", "t_max", "v0", "e1", "e2")]
    for name, args in (("ray_tris_nearest", flat), ("ray_tris_occluded", flat),
                       ("ray_tris_nearest_instanced", flat + [a["offsets"]]),
                       ("ray_tris_occluded_instanced", flat + [a["offsets"]])):
        with pytest.raises(ValueError):
            getattr(ti, name)(*args)
