"""The port's triangle sweeps and tree canopies in the double modes against
the JAX package under x64, on the CPU.

The port renders canopies with triangles (an ``abstract_tree``'s trunks, a
``mesh_tree``'s wood) with float64 path state in ``mono_double`` and
``mono_polarized_double``, as the JAX package does with ``jax_enable_x64``
on, which these tests switch on around each reference call and off again in
a ``finally`` (the ``x64`` fixture of ``test_torch_canopy_double.py``; the
reference's canopy must not render in a single mode under x64).

- The float64 plain versions of the triangle sweeps (K8 and the K9 pair)
  against the reference's XLA sweeps jitted under x64 (``ray_tris_nearest``,
  ``ray_tris_occluded``, ``_instanced_tris_nearest_xla`` and the instance
  scan of ``tri_occluded``): equal on every lane, normals included, for
  rays at the shared edges and vertices of a closed cylinder from 0.5-3 m
  and 50-300 m, rays exactly at its vertices (its cap's apex joins twelve
  triangles, a side vertex up to six: three- to seven-way ties, whose
  float64 normals the reference sums in index order), rays at a 12-branch
  wood skeleton, direction components of exactly +-0, a cylinder 2 km from
  the world origin, and the tie soups (ties inside a chunk, across two and
  across instances).
- The float64 sweeps' line cull (``_line_near``) gives the dense test's
  distances on every pair of the same problems.
- The float64 kernels' twins: the order-free tie rule (the tied normals
  summed again in index order where three or more tie) gives the dense
  sweep's result bit for bit in leaf order and in shuffled orders, flat
  and instanced; the cull of float64 triangles in float32 boxes is
  conservative with the ray rounded to float32 and the cap rounded up,
  also with margins a sixteenth of ``BOX_SLACK`` and ``CAP_SLACK``.
- ``compile_canopy_scene`` in ``mono_double`` gives the reference's arrays
  under x64 bit for bit, triangles and offsets float64, for the small
  ``c5_trees`` and ``c5_wood`` of ``test_torch_tree_experiment.py``.
- Same-seed renders of the small ``c5_trees`` and ``c5_wood`` in
  ``mono_double``, and of ``c5_trees`` in ``mono_polarized_double``, lane by
  lane against the reference's regenerative loop under x64: the lane gate
  of ``test_torch_canopy_double.py`` (at most two lanes beyond 1e-10
  relative, the rest and the pixels' sums within 1e-10) and every pixel
  within |z| <= 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.ops import mesh as ref
from eradiate_tpu_torch.kernels import bvh as bvh_mod
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops import mesh
from eradiate_tpu_torch.test_tools.meshes import (
    axis_rays,
    edge_rays,
    instanced_tie_soup,
    tie_soup,
    vertex_rays,
    wood_skeleton,
    write_obj,
)
from test_torch_canopy_double import (  # noqa: F401  (x64: the fixture)
    _port_lanes,
    _ref_lanes,
    _same,
    canopy_lane_gate,
    x64,
)
from test_torch_experiment import _leaves
from test_torch_tree_experiment import CanopyAtmosphereExperiment, RefCanopyAtmosphere, kwargs

torch.set_num_threads(1)

F64 = np.float64
B_FLAT = 4096
OFFSETS = np.array([[0.0, 0.0, 0.0], [0.02, 0.0, 0.0], [0.0, 0.03, 0.0]])
FAR = np.array([[2.0, 0.0, 0.0], [0.0, -2.0, 0.0], [1.4, 1.4, 0.3]])


def T(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def J(*arrays):
    return [jnp.asarray(a) for a in arrays]


def cylinder(center=(0.0, 0.0, 0.0)):
    """A tree trunk of ``c5_trees``, closed: 0.25 m radius, 6 m high, km.
    Returns the float64 soup and its vertices."""
    v, f = mesh.cylinder_mesh(0.25e-3, 6e-3, center=center)
    return mesh.mesh_from_vertices(v.astype(F64), f), v


def skeleton(branches=12):
    """The wood skeleton of ``c5_wood``'s CPU form (36 + 24 x ``branches``
    triangles), km, float64."""
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=branches)
    return mesh.mesh_from_vertices((v * 1e-3).astype(F64), f), v * 1e-3


def problem(name):
    """``(p, d, t_max, v0, e1, e2)`` float64 numpy, and the offsets of an
    instanced problem (else None)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ties":
        soup, rays = tie_soup(rng, 3000, dtype=F64)
        return (*rays, *soup), None
    if name == "instanced ties":
        soup, offsets, rays = instanced_tie_soup(rng, 1000, dtype=F64)
        return (*rays, *soup), offsets
    offsets, B = None, B_FLAT
    if name.startswith("instanced"):
        offsets = FAR if name.endswith("far offsets") else OFFSETS
        B = B_FLAT // 2
    soup, verts = skeleton() if "skeleton" in name else cylinder()
    if name.endswith("far origin"):
        soup, verts = cylinder(center=(2.0, -1.5, 0.3))
    if "vertices" in name:
        targets = verts if offsets is None else np.concatenate([verts + o for o in offsets])
        rays = vertex_rays(rng, B, targets, 1e-3 if "far" in name else 1e-5, dtype=F64)
    elif "zero components" in name:
        rays = axis_rays(rng, B, soup, 1e-3 if "far" in name else 1e-5, offsets, dtype=F64)
    elif name.endswith("far offsets"):
        rays = edge_rays(rng, B, soup, offsets, origins=rng.uniform(-0.01, 0.01, (B, 3)),
                         dtype=F64)
    else:
        near = "far" not in name or name.endswith("far origin")
        rays = edge_rays(rng, B, soup, offsets, 1e-5 if near else 1e-3, dtype=F64)
    return (*rays, soup.v0, soup.e1, soup.e2), offsets


FLAT = ["cylinder edges", "cylinder edges far", "cylinder vertices", "cylinder vertices far",
        "skeleton edges", "skeleton zero components", "cylinder far origin", "ties"]
INSTANCED = ["instanced cylinder edges", "instanced cylinder vertices",
             "instanced skeleton zero components far", "instanced far offsets",
             "instanced ties"]


def _most_tied(problem_args, t_hit):
    """The most triangles tied at the nearest hit on a lane."""
    p, d, t_max, v0, e1, e2 = T(*problem_args)
    t_all = ti._chunk_hits(p, d, v0, e1, e2, t_max)
    return int(((t_all == t_hit[:, None]) & torch.isfinite(t_hit)[:, None]).sum(1).max())


# ---------------------------------------------------------------------------
# the float64 plain versions against the reference's XLA sweeps under x64


@pytest.mark.parametrize("name", FLAT)
def test_flat_plain_f64_matches_jitted_reference(x64, name):
    """K8's float64 twins against the jitted x64 sweeps: every lane, the
    nearest hit's ``t``, normal and flag and the any-hit flag."""
    args, _ = problem(name)
    p, d, t_max, v0, e1, e2 = args
    tris = ref.TriangleMeshArrays(*J(v0, e1, e2))
    want = jax.jit(ref.ray_tris_nearest)(*J(p, d, t_max), tris)
    got = ti.ray_tris_nearest_plain(*T(*args))
    assert got[0].dtype == got[1].dtype == torch.float64
    _same(got, want)
    hit = got[2].numpy()
    assert 0.2 < hit.mean() and (hit.mean() < 1.0 or name == "ties")
    _same(ti.ray_tris_occluded_plain(*T(*args)),
          jax.jit(ref.ray_tris_occluded)(*J(p, d, t_max), tris))
    if "vertices" in name:
        # a cap's apex and the side vertices: three or more tied normals,
        # which only the reference's index-order sum gives bit for bit
        assert _most_tied(args, got[0]) >= 4


def _occluded_scan(p, d, t_max, inst):
    """The instance scan of the reference's ``tri_occluded`` (its XLA path
    without the box advance)."""
    def body(carry, offset):
        return carry | ref.ray_tris_occluded(p - offset[None, :], d, t_max, inst.canonical), None

    return jax.lax.scan(body, jnp.zeros(p.shape[0], dtype=bool), inst.offsets)[0]


@pytest.mark.parametrize("name", INSTANCED)
def test_instanced_plain_f64_matches_jitted_reference(x64, name):
    """The K9 pair's float64 twins against ``_instanced_tris_nearest_xla``
    and the instance scan of ``tri_occluded`` jitted under x64, and the
    port's ``tri_nearest``/``tri_occluded`` (box advance, then the sweeps)
    against the reference's: every lane."""
    args, offsets = problem(name)
    p, d, t_max, v0, e1, e2 = args
    inst = ref.InstancedTriArrays(canonical=ref.TriangleMeshArrays(*J(v0, e1, e2)),
                                  offsets=jnp.asarray(offsets))
    got = ti.ray_tris_nearest_instanced_plain(*T(*args, offsets))
    _same(got, jax.jit(ref._instanced_tris_nearest_xla)(*J(p, d, t_max), inst))
    assert got[2].numpy().sum() > 200
    _same(ti.ray_tris_occluded_instanced_plain(*T(*args, offsets)),
          jax.jit(_occluded_scan)(*J(p, d, t_max), inst))
    tris = mesh.InstancedTriArrays(mesh.TriangleMeshArrays(*T(v0, e1, e2)), *T(offsets))
    _same(mesh.tri_nearest(*T(p, d, t_max), tris), jax.jit(ref.tri_nearest)(*J(p, d, t_max), inst))
    _same(mesh.tri_occluded(*T(p, d, t_max), tris),
          jax.jit(ref.tri_occluded)(*J(p, d, t_max), inst))


@pytest.mark.parametrize("name", FLAT)
def test_line_cull_f64_equals_the_dense_test(name):
    """The float64 sweeps' cull keeps every pair the exact test accepts:
    the culled distances equal the dense test's on every (ray, triangle)
    pair, and the cull skips most pairs of the far problems."""
    args, _ = problem(name)
    p, d, t_max, v0, e1, e2 = T(*(a[:2048] for a in args[:3]), *args[3:])  # 2048 lanes
    culled = ti._chunk_hits(p, d, v0, e1, e2, t_max)
    dense = ti._exact_hits(p[:, None], d[:, None], v0[None], e1[None], e2[None], t_max[:, None])
    assert torch.equal(culled.view(torch.int64), dense.view(torch.int64))
    assert torch.isfinite(dense).any()
    if name == "ties":
        assert ti._line_near(p, d, v0, e1, e2).float().mean() < 0.2


# ---------------------------------------------------------------------------
# the float64 kernels' twins: tie rule and cull


@pytest.mark.parametrize("name", ["cylinder vertices", "ties"])
def test_tie_rule_f64_does_not_depend_on_the_visit_order(name):
    """The flat kernel's twin on float64 triangles, in leaf order, reversed
    and in a shuffled order: the dense sweep's result bit for bit, three- to
    seven-way ties included (their normals summed again in index order)."""
    args, _ = problem(name)
    p, d, t_max, *soup = T(*args)
    bvh = ti.tri_bvh(*soup)
    assert bvh.tris.dtype == torch.float64 and bvh.nodes.dtype == torch.float32
    dense = ti.ray_tris_nearest_plain(p, d, t_max, *soup)
    rows = np.arange(bvh.tris.shape[0])
    for order in (None, rows[::-1], np.random.default_rng(5).permutation(rows)):
        _same(ti.ray_tris_nearest_bvh_plain(p, d, t_max, bvh, order), dense)
    if name == "cylinder vertices":
        assert _most_tied(args, dense[0]) >= 4


@pytest.mark.parametrize("name", ["instanced cylinder vertices", "instanced ties"])
def test_instanced_tie_rule_f64_does_not_depend_on_the_visit_order(name):
    """The instanced kernel's twin on float64 triangles and offsets, in the
    leaf order of both levels and a shuffled order of the (instance,
    triangle) pairs: the dense instanced sweep bit for bit."""
    args, offsets = problem(name)
    p, d, t_max, *soup = T(*args)
    o = T(offsets)[0]
    ibvh = ti.tri_instanced_bvh(*soup, o)
    assert ibvh.instances.dtype == ibvh.canonical.tris.dtype == torch.float64
    dense = ti.ray_tris_nearest_instanced_plain(p, d, t_max, *soup, o)
    order = np.random.default_rng(6).permutation(len(offsets) * soup[0].shape[0])
    for o_ in (None, order):
        _same(ti.ray_tris_nearest_instanced_bvh_plain(p, d, t_max, ibvh, o_), dense)


#: Lanes of ``edge_rays(default_rng(32), 100_037, <256-branch skeleton>,
#: None, 1e-3)`` that meet a branch's side at a grazing angle from 150-250 m
#: (``test_torch_tri_bvh.py``), here in float64.
GRAZING_LANES = [4430, 14974, 64299]


def _cull_rays(kind, soup):
    rng = np.random.default_rng(11)
    if kind == "grazing slivers":
        rays = edge_rays(np.random.default_rng(32), 100_037, soup, None, 1e-3, dtype=F64)
        return tuple(a[GRAZING_LANES] for a in rays)
    if kind.startswith("zero"):
        return axis_rays(rng, 3000, soup, 1e-3 if kind.endswith("far") else 1e-5, dtype=F64)
    if kind.startswith("vertices"):
        return vertex_rays(rng, 3000, np.concatenate([soup.v0, soup.v0 + soup.e1]),
                           1e-3 if kind.endswith("far") else 1e-5, dtype=F64)
    return edge_rays(rng, 3000, soup, None, 1e-3 if kind.endswith("far") else 1e-5, dtype=F64)


@pytest.mark.parametrize("kind", ["edges near", "edges far", "zero components near",
                                  "zero components far", "vertices far", "grazing slivers"])
@pytest.mark.parametrize("scale", [1.0, 1.0 / 16], ids=["margins", "margins/16"])
def test_cull_is_conservative_f64(monkeypatch, kind, scale):
    """Float64 triangles in a hierarchy of float32 boxes, tested with the
    ray rounded to float32 and the cap rounded up: every triangle the dense
    float64 sweep accepts lies in a leaf reached with the cap ``t_max`` and
    in one reached with the cap at its own ``t``. Also with both margins a
    sixteenth of their values: the float32 margins hold float64 items with
    room to spare (the float32 test's grazing slivers need a tenth of
    ``BOX_SLACK`` and a fifth of ``CAP_SLACK``)."""
    monkeypatch.setattr(bvh_mod, "BOX_SLACK", bvh_mod.BOX_SLACK * scale)
    monkeypatch.setattr(bvh_mod, "CAP_SLACK", bvh_mod.CAP_SLACK * scale)
    soup, _ = skeleton(256 if kind == "grazing slivers" else 20)
    tris = T(soup.v0, soup.e1, soup.e2)
    bvh = ti.tri_bvh(*tris)
    p, d, t_max = T(*_cull_rays(kind, soup))
    row_leaf = torch.from_numpy(bvh_mod.leaf_of_row(bvh, bvh.tris.shape[0]))
    leaf = torch.empty_like(row_leaf)
    leaf[torch.tensor(bvh_mod.row_index(bvh.tris))] = row_leaf  # the leaf of each triangle
    t_all = ti._chunk_hits(p, d, *tris, t_max)
    accepted = torch.isfinite(t_all)
    assert accepted.any(dim=1).sum() >= p.shape[0] // 8
    reached = ti.bvh_leaves_reached_plain(p, d, t_max, bvh)
    assert not (accepted & ~reached[:, leaf]).any()
    lanes, tri = torch.nonzero(accepted, as_tuple=True)
    own = ti.bvh_leaves_reached_plain(p[lanes], d[lanes], t_all[lanes, tri], bvh)
    assert own[torch.arange(lanes.shape[0]), leaf[tri]].all()


def test_float64_boxes_contain_the_float64_vertices():
    """A float64 soup's leaf boxes (float32, rounded outward after one
    float64 ulp) contain its vertices ``v0``, ``v0 + e1`` and ``v0 + e2`` as
    float64 computes them, and the rows hold the inputs bit for bit."""
    soup, _ = skeleton()
    bvh = ti.tri_bvh(*T(soup.v0, soup.e1, soup.e2))
    tris = bvh.tris.numpy()
    index = np.asarray(bvh_mod.row_index(bvh.tris))
    assert sorted(index) == list(range(soup.v0.shape[0]))
    for cols, x in ((slice(0, 3), soup.v0), (slice(4, 7), soup.e1), (slice(8, 11), soup.e2)):
        np.testing.assert_array_equal(tris[:, cols].view(np.int64), x[index].view(np.int64))
    np.testing.assert_array_equal(tris[:, [7, 11]], 0.0)
    _, _, lo, hi = ti.bvh_leaves(bvh)
    row_leaf = bvh_mod.leaf_of_row(bvh, tris.shape[0])
    for vert in (soup.v0, soup.v0 + soup.e1, soup.v0 + soup.e2):
        assert (lo[row_leaf] <= vert[index]).all() and (vert[index] <= hi[row_leaf]).all()


def test_f64_wrappers_run_the_plain_versions_on_the_cpu():
    """Float64 CPU rays and soups run the float64 plain versions through the
    wrappers (and ``mesh.tri_accel`` builds nothing on the CPU) and count no
    launch; rays and a soup of two dtypes raise."""
    args, offsets = problem("instanced cylinder edges")
    t = T(*args, offsets)
    before = (dict(ti.launches), dict(ti.launches_f64))
    _same(ti.ray_tris_nearest(*t[:6]), ti.ray_tris_nearest_plain(*t[:6]))
    _same(ti.ray_tris_occluded_instanced(*t), ti.ray_tris_occluded_instanced_plain(*t))
    soup = mesh.InstancedTriArrays(mesh.TriangleMeshArrays(*t[3:6]), t[6])
    cull, lo, hi = mesh.tri_accel(soup)
    assert cull is None and lo.dtype == hi.dtype == torch.float64
    assert (ti.launches, ti.launches_f64) == before
    for mixed in ([*t[:3], t[3].float(), *t[4:6]], [t[0].float(), *t[1:6]]):
        with pytest.raises(TypeError, match="all float32 or all float64"):
            ti.ray_tris_nearest(*mixed)
    with pytest.raises(TypeError):
        ti.ray_tris_occluded_instanced(*t[:6], t[6].float())
    with pytest.raises(TypeError):
        ti.tri_instanced_bvh(*t[3:6], t[6].float())


# ---------------------------------------------------------------------------
# the tree canopies in the double modes


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    """``test_torch_tree_experiment.py``'s 12-branch wood skeleton as an OBJ
    file."""
    path = tmp_path_factory.mktemp("meshes") / "wood.obj"
    write_obj(path, *wood_skeleton(np.random.default_rng(7), n_branches=12))
    return path


def compiled(case, mode_id, mesh_file, reference):
    """``compile_canopy_scene`` of a small tree canopy's first measure in
    ``mode_id`` (the reference's under x64); a polarized mode takes the
    polarized integrator."""
    pkg = eradiate_tpu if reference else eradiate_tpu_torch
    pkg.set_mode(mode_id)
    kw = kwargs(case, mesh_file)
    if pkg.mode().is_polarized:
        kw["integrator"] = {"type": "volpath", "stokes": True}
    exp = (RefCanopyAtmosphere if reference else CanopyAtmosphereExperiment)(**kw)
    m = exp.measures[0]
    return exp.compile_canopy_scene(m, exp.spectral_context(m))


@pytest.mark.parametrize("case", ["trees", "wood"])
def test_compile_canopy_scene_bitwise_under_x64(x64, mesh_file, case):
    """Leaves, triangles, offsets and both optics rows float64 and bitwise
    the reference's, instanced trunks (``trees``) and a flattened wood
    (``wood``)."""
    out = _leaves(compiled(case, "mono_double", mesh_file, False)[:7])
    want = _leaves(compiled(case, "mono_double", mesh_file, True)[:7])
    assert out.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k
    tri_keys = [k for k in out if k.startswith("[5]")]
    assert tri_keys and all(out[k].dtype == F64 for k in tri_keys)
    assert any(k.endswith("offsets") for k in tri_keys) == (case == "trees")
    assert all(out[k].dtype == F64 for k in out if k.startswith("[6]"))


@pytest.mark.parametrize("case, mode_id, spp", [("trees", "mono_double", 256),
                                                ("wood", "mono_double", 128),
                                                ("trees", "mono_polarized_double", 128)])
def test_tree_canopy_lane_gate_against_reference_under_x64(x64, mesh_file, case, mode_id, spp):
    """The small ``c5_trees`` and ``c5_wood`` at one seed through both
    packages' regenerative canopy loops, lane by lane: float64 leaves,
    triangles and path state, the lane gate of ``test_torch_canopy_double``
    and every pixel within |z| <= 5."""
    want = _ref_lanes(compiled(case, mode_id, mesh_file, True), spp, 7)
    out = compiled(case, mode_id, mesh_file, False)
    assert np.asarray(out[5].canonical.v0 if case == "trees" else out[5].v0).dtype == F64
    assert out[2].polarized == (mode_id == "mono_polarized_double")
    canopy_lane_gate(_port_lanes(out, spp, 7), want, spp)
