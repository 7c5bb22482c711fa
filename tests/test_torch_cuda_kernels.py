"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``: they carry the ``cuda`` marker
and skip elsewhere (the decision is taken inside a fixture, never at import
time). Run them on a machine with a card with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX's virtual CPU devices
for the reference's tests, which these tests do not use.)

They are a quick form of what ``chip_smoke.py`` checks at full size: each
kernel equals its plain version bit pattern for bit pattern (so that a
-0.0 is not taken for a +0.0). The collision fetch is held on the c1 column
merged and not, and on a table with runs of equal levels, with queries of
NaN, +-inf, -0.0, every level and its neighbours one ulp either side, at lane
counts of every remainder modulo 4 and on a misaligned ``q[1:]`` view (its
scalar paths), at L = 1 and L = 12287 (a 64 KB search tree) and at K = 1 and
K = 16 (the table rows read through the read-only cache). Each leaf-sweep kernel is held on random
disks with rays aimed at their rims (a stress of the kernels' conservative
culls), at a ragged lane count, from origins near the disks and from origins
a hundred times farther away (where float32 rounding of the ray moves the
hit point by a sizeable part of a disk, and the culls' margins have to grow
with it), and on disks whose normals have components of exactly +-0 (the
winner's -0.0 comes out +0.0); the flat ones, which traverse a bounding
volume hierarchy, also with direction components exactly +-0 along the
planes of the disks' box faces, at grazing incidence, and on exact ties of
the hit distance inside one 512-disk chunk and across two.
The triangle-sweep kernels are held the same way on a wood skeleton (closed
cylinders) with rays aimed at shared edges and vertices; the flat ones, which
traverse a bounding volume hierarchy, also with direction components exactly
+-0 (origins on the planes of box faces) and on exact ties of the hit
distance inside one 512-triangle chunk and across two (the tie rule must not
depend on the traversal's order); the instanced ones, which traverse a
hierarchy of two levels, also with direction components exactly +-0 near
and far, on triangles whose normals have components of exactly +-0, on
instances 2 km from the world origin with rays from near it, and on the
instanced tie soup (ties inside a chunk, across chunks, and across
instances, where the walk meets the higher instance first). The slant-depth kernel is held on points
spread through the shells (steep, grazing and blocked rays), and it and the
shell-event kernel (whose flight is then given no length, so that its event
point is the point itself) on the stresses of
``eradiate_tpu_torch.test_tools.shells``: points on shell radii, tangent
radii on shell radii and at the ground, ``b`` above ``r`` by rounding,
``p.w = +-0``, points above the top radius, vacuum shells and 1200 shells;
the slant loop's division is held against the IEEE division on every
divisor significand and on random operands inside and beyond its range.
The shell-flight and shell-event kernels (one sweep with float64
checkpoints, a bounded resume) are held on the flight's stresses of
``test_tools.shells.flight_stress_inputs`` (``v`` on a level's G inside runs
of vacuum shells across a checkpoint, ``tau_s`` at 0 and one ulp either side
of ``tau_max``, ``t_max = 0``, ``x0 = +-0``, ``b2`` at ``fl(r_k^2)`` and one
ulp either side, grazing lanes in the top shell) on six columns, whose
checkpoint strides are 15, 15, 75, 15, 2 and 1, the slant depth at the
event points equal to the shell event's; the flight loop's square root is
held against ``sqrtf`` on every float32 of its range, and the wrapper's
checkpoint stride and shared-memory sizes against the library's.

The float64 builds of the double modes (K1's ``collision_fetch_f64_kernel``,
K2-K4's ``shell_flight_f64_kernel``, ``shell_event_f64_kernel`` and
``slant_tau_f64_kernel``) are held the same way on float64 operands: the
collision fetch on the c1 column compiled in ``mono_double`` (merged and
not) and on random columns up to L = 12287 (a 128 KiB search tree), with
float64 NaN, +-inf, -0.0 and every level one ulp either side; the shell
kernels on the flight's and the slant's stresses taken into float64 and on
a planet of 1e6 km (1200 shells of 0.1 km, which float32 cannot tell
apart), K4 at K2's event points equal to K3's tau_sun. The leaf sweeps'
float64 builds (``leaf_bvh_nearest_f64_kernel``,
``leaf_bvh_occluded_f64_kernel``, ``leaf_ibvh_nearest_f64_kernel``,
``leaf_ibvh_occluded_f64_kernel``) are held on float64 disks and rays as
the float32 kernels are, and on the float64 tie table (three- and four-way
ties, whose float64 normals they sum again in index order); a float64
operand beside float32 ones raises before any launch. The triangle sweeps'
float64 builds (``bvh_nearest_f64_kernel``, ``bvh_occluded_f64_kernel``,
``tri_ibvh_nearest_f64_kernel``, ``tri_ibvh_occluded_f64_kernel``) are held
on the float64 wood skeleton with rays at its edges from near and far, with
direction components of +-0, and exactly at its vertices (a cap's apex
joins twelve triangles: three- to twelve-way ties, whose float64 normals
they sum again in index order), on the float64 tie soups, and on instances
2 km from the world origin.
"""

import numpy as np
import pytest
import torch

from eradiate_tpu_torch.kernels import collision_fetch as cf
from eradiate_tpu_torch.kernels import leaf_intersect as li
from eradiate_tpu_torch.kernels import shell_flight as sf
from eradiate_tpu_torch.kernels import tri_intersect as ti
from eradiate_tpu_torch.ops.mesh import mesh_from_vertices
from eradiate_tpu_torch.ops.spherical import TAU_BLOCKED, fma
from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools
from eradiate_tpu_torch.test_tools import disks, shells
from eradiate_tpu_torch.test_tools.meshes import (
    axis_rays,
    edge_rays,
    instanced_tie_soup,
    tie_soup,
    vertex_rays,
    wood_skeleton,
    zero_normal_tris,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form but their plain versions")
    return torch.device("cuda")


def same_bits(got, want):
    """Every output equal bit pattern for bit pattern (floats as integers of
    their width)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.is_floating_point():
            bits = torch.int64 if g.dtype == torch.float64 else torch.int32
            g, w = g.view(bits), w.view(bits)
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def fetch_columns():
    """The collision fetch's operands: the c1 column merged and unmerged,
    and the table with runs of equal levels (numpy, float32)."""
    import eradiate_tpu_torch as etp

    etp.set_mode("mono_single")
    return {"c1": fetch_tools.column_operands(),
            "1200 layers": fetch_tools.column_operands(None),
            "flat runs": fetch_tools.flat_run_operands()}


def random_column(L, K, seed):
    """L random layers (a fifth of them empty: runs of equal levels) and K
    seeded table rows."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.0, 1.0, L) * (rng.uniform(size=L) > 0.2)
    tau = np.concatenate([[0.0], np.cumsum(dtau)])
    z = np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 1.0, L))])
    return [np.asarray(a, np.float32) for a in (z, tau, rng.uniform(size=(K, L)))]


def fetch_held(q, column, card):
    """Launch the collision fetch once on queries ``q`` (a CUDA tensor) and
    hold it against its twin bit pattern for bit pattern on every lane."""
    args = (q, *(torch.tensor(a, device=card) for a in column))
    before = cf.launches
    got = cf.collision_fetch(*args)
    torch.cuda.synchronize()
    assert cf.launches == before + 1
    same_bits(got, cf.collision_fetch_plain(*args))
    return got


@pytest.mark.parametrize("column", ["c1", "1200 layers", "flat runs"])
@pytest.mark.parametrize("B", [1_000_000, 1_000_001, 1_000_002, 1_000_003])
def test_collision_fetch_kernel_equals_plain_version(card, fetch_columns, column, B):
    levels = fetch_columns[column]
    q = torch.tensor(fetch_tools.stress_queries(levels[1], B, seed=B), device=card)
    _, layer, _ = fetch_held(q, levels, card)
    L = levels[2].shape[1]
    assert int(layer[0]) == L - 1  # the NaN query: past every level
    assert int(layer.min()) == 0 and int(layer.max()) == L - 1


@pytest.mark.parametrize("column", ["c1", "1200 layers"])
@pytest.mark.parametrize("B", [5, 100_004])
def test_collision_fetch_kernel_misaligned_queries(card, fetch_columns, column, B):
    """A ``q[1:]`` view: the queries start 4 bytes past a 16-byte boundary."""
    levels = fetch_columns[column]
    base = torch.tensor(fetch_tools.stress_queries(levels[1], B + 1, seed=7), device=card)
    q = base[1:]
    assert q.data_ptr() % 16 == 4
    fetch_held(q, levels, card)


@pytest.mark.parametrize("L, K", [(1, 3), (2, 1), (46, 16), (1200, 1), (1200, 16), (12287, 1),
                                  (12287, 3)])
@pytest.mark.parametrize("B", [3, 200_001])
def test_collision_fetch_kernel_shapes(card, L, K, B):
    column = random_column(L, K, seed=L + K)
    q = torch.tensor(fetch_tools.stress_queries(column[1], B, seed=B), device=card)
    fetch_held(q, column, card)


@pytest.fixture(scope="module")
def fetch_columns_f64():
    """The c1 column's operands compiled in ``mono_double``, merged and not,
    and the table with runs of equal levels (numpy, float64)."""
    import eradiate_tpu_torch as etp

    etp.set_mode("mono_double")
    try:
        return {"c1": fetch_tools.column_operands(dtype=np.float64),
                "1200 layers": fetch_tools.column_operands(None, dtype=np.float64),
                "flat runs": fetch_tools.flat_run_operands(dtype=np.float64)}
    finally:
        etp.set_mode("mono_single")


def fetch_held_f64(q, column, card):
    """The float64 build once on queries ``q``, held against its twin."""
    args = (q, *(torch.tensor(a, device=card) for a in column))
    before = cf.launches, cf.launches_f64
    got = cf.collision_fetch(*args)
    torch.cuda.synchronize()
    assert (cf.launches, cf.launches_f64) == (before[0], before[1] + 1)
    assert got[0].dtype == got[2].dtype == torch.float64
    same_bits(got, cf.collision_fetch_plain(*args))
    return got


@pytest.mark.parametrize("column", ["c1", "1200 layers", "flat runs"])
@pytest.mark.parametrize("B", [1_000_000, 1_000_003])
def test_collision_fetch_f64_kernel_equals_plain_version(card, fetch_columns_f64, column, B):
    levels = fetch_columns_f64[column]
    assert levels[1].dtype == np.float64
    q = torch.tensor(fetch_tools.stress_queries(levels[1], B, seed=B), device=card)
    _, layer, _ = fetch_held_f64(q, levels, card)
    L = levels[2].shape[1]
    assert int(layer[0]) == L - 1  # the NaN query: past every level
    assert int(layer.min()) == 0 and int(layer.max()) == L - 1


@pytest.mark.parametrize("L, K", [(1, 3), (46, 16), (1200, 3), (12287, 1)])
@pytest.mark.parametrize("B", [3, 200_001])
def test_collision_fetch_f64_kernel_shapes(card, L, K, B):
    column = [a.astype(np.float64) for a in random_column(L, K, seed=L + K)]
    q = torch.tensor(fetch_tools.stress_queries(column[1], B, seed=B), device=card)
    fetch_held_f64(q, column, card)


def rim_problem(B, seed, instanced, far=False, zero_normals=False, dtype=np.float32):
    """700 random disks (at three offsets when ``instanced``) and rays at
    their rims from 0.5-3 units (``far``: 100x farther); ``zero_normals``
    gives every normal a component of exactly +-0. In ``dtype``."""
    rng = np.random.default_rng(seed)
    c, n, r = disks.random_disks(rng, 700)
    if zero_normals:
        n = disks.zero_normal_disks(rng, n, share=1.0)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]]) if instanced else None
    arrays = [*disks.rim_rays(rng, B, c, n, r, offsets, 100.0 if far else 1.0, dtype=dtype),
              c, n, r]
    if instanced:
        arrays.append(offsets)
    return [np.asarray(a, dtype) for a in arrays]


def _held(mod, name, args, slice_lanes=2**14):
    """Launch sweep ``name`` of module ``mod`` once and hold it against its
    plain version (in slices of lanes: its [B, 512] float64 temporaries) on
    every lane, bit pattern for bit pattern. Float64 operands launch the
    float64 build, counted in ``launches_f64``."""
    counts, key = ((mod.launches_f64, name + "_f64") if args[0].dtype == torch.float64
                   else (mod.launches, name))
    before = counts[key]
    got = getattr(mod, name)(*args)
    torch.cuda.synchronize()
    assert counts[key] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = []
    for start in range(0, args[0].shape[0], slice_lanes):
        sl = [a[start : start + slice_lanes] for a in args[:3]]
        out = getattr(mod, name + "_plain")(*sl, *args[3:])
        want.append(out if isinstance(out, tuple) else (out,))
    same_bits(got, [torch.cat(w) for w in zip(*want)])
    return got


@pytest.mark.parametrize(
    "name", ["ray_leaves_nearest", "ray_leaves_occluded", "ray_leaves_nearest_instanced",
             "ray_leaves_occluded_instanced"]
)
@pytest.mark.parametrize("B", [1, 100_037])
@pytest.mark.parametrize("far", [False, True])
def test_leaf_kernel_equals_plain_version(card, name, B, far):
    problem = rim_problem(B, 3, name.endswith("instanced"), far)
    got = _held(li, name, [torch.tensor(a, device=card) for a in problem])
    assert got[-1].any() or B == 1


@pytest.mark.parametrize(
    "name", ["ray_leaves_nearest", "ray_leaves_nearest_instanced"]
)
def test_leaf_kernel_zero_normals(card, name):
    """Winners with a normal component of -0.0: the kernels return +0.0, as
    the plain versions and the reference do."""
    problem = rim_problem(100_037, 4, name.endswith("instanced"), zero_normals=True)
    n = problem[4]
    assert (np.signbit(n) & (n == 0)).any()
    got = _held(li, name, [torch.tensor(a, device=card) for a in problem])
    assert got[2].any() and not torch.signbit(got[1][got[1] == 0]).any()


@pytest.mark.parametrize("name", ["ray_leaves_nearest", "ray_leaves_occluded"])
@pytest.mark.parametrize("case", ["ties", "zero components near", "zero components far",
                                  "grazing"])
def test_flat_leaf_kernel_stress(card, name, case):
    rng = np.random.default_rng(9)
    if case == "ties":
        table, rays = disks.tie_disks(rng, 30_011)
    else:
        table = disks.random_disks(rng, 700)
        make = disks.grazing_rays if case == "grazing" else disks.axis_rays
        rays = make(rng, 100_037, *table, distance=100.0 if case.endswith("far") else 1.0)
    args = [torch.tensor(np.asarray(a, np.float32), device=card) for a in (*rays, *table)]
    got = _held(li, name, args)
    assert got[-1].any()


@pytest.mark.parametrize("name", ["ray_leaves_nearest_instanced", "ray_leaves_occluded_instanced"])
@pytest.mark.parametrize("case", ["ties", "zero components near", "zero components far",
                                  "grazing", "far offsets"])
def test_instanced_leaf_kernel_stress(card, name, case):
    """The two-level traversal on the instanced tie table (ties inside a
    chunk, across chunks, across instances with opposite normals, where the
    lower instance wins from a higher chunk, and four coincident disks with
    normals n, n, n, -n, whose float32 sum in index order misses n / 2),
    direction components exactly +-0 near and far, grazing rays, and
    instances 200 units from the world origin with rays from near it."""
    rng = np.random.default_rng(9)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]])
    if case == "ties":
        table, offsets, rays = disks.instanced_tie_disks(rng, 30_011)
    else:
        table = disks.random_disks(rng, 700)
        if case == "far offsets":
            offsets = np.array([[200.0, 0, 0], [0, -200.0, 0], [140.0, 140.0, 30.0]])
            rays = disks.rim_rays(rng, 100_037, *table, offsets,
                                  origins=rng.uniform(-1, 1, (100_037, 3)))
        elif case == "grazing":
            rays = disks.grazing_rays(rng, 100_037, *table, offsets=offsets)
        else:
            rays = disks.axis_rays(rng, 100_037, *table,
                                   100.0 if case.endswith("far") else 1.0, offsets)
    args = [torch.tensor(np.asarray(a, np.float32), device=card)
            for a in (*rays, *table, offsets)]
    got = _held(li, name, args)
    assert got[-1].any()


def edge_problem(B, seed, instanced, far=False):
    """Rays aimed at edges, vertices and interiors of a 60-branch wood
    skeleton (1476 triangles, km), from 0.5-3 m (``far``: 50-300 m) away."""
    rng = np.random.default_rng(seed)
    v, f = wood_skeleton(np.random.default_rng(7), n_branches=60)
    tris = mesh_from_vertices((v * 1e-3).astype(np.float32), f)
    offsets = np.array([[0.0, 0, 0], [0.02, 0, 0], [0, 0.03, 0]]) if instanced else None
    p, d, t_max = edge_rays(rng, B, tris, offsets, 1e-3 if far else 1e-5)
    arrays = [p, d, t_max, tris.v0, tris.e1, tris.e2]
    if instanced:
        arrays.append(offsets)
    return [np.ascontiguousarray(a, np.float32) for a in arrays]


@pytest.mark.parametrize(
    "name", ["ray_tris_nearest", "ray_tris_occluded", "ray_tris_nearest_instanced",
             "ray_tris_occluded_instanced"]
)
@pytest.mark.parametrize("B", [1, 100_037])
@pytest.mark.parametrize("far", [False, True])
def test_tri_kernel_equals_plain_version(card, name, B, far):
    problem = edge_problem(B, 3, name.endswith("instanced"), far)
    got = _held(ti, name, [torch.tensor(a, device=card) for a in problem])
    assert got[-1].any() or B == 1


@pytest.mark.parametrize("name", ["ray_tris_nearest", "ray_tris_occluded"])
@pytest.mark.parametrize("case", ["ties", "zero components near", "zero components far"])
def test_flat_tri_kernel_stress(card, name, case):
    rng = np.random.default_rng(9)
    if case == "ties":
        tris, rays = tie_soup(rng, 30_011)
    else:
        v, f = wood_skeleton(np.random.default_rng(7), n_branches=60)
        soup = mesh_from_vertices((v * 1e-3).astype(np.float32), f)
        tris = (soup.v0, soup.e1, soup.e2)
        rays = axis_rays(rng, 100_037, soup, 1e-3 if case.endswith("far") else 1e-5)
    args = [torch.tensor(np.ascontiguousarray(a), device=card) for a in (*rays, *tris)]
    got = _held(ti, name, args)
    assert got[-1].any()


@pytest.mark.parametrize("name", ["ray_tris_nearest_instanced", "ray_tris_occluded_instanced"])
@pytest.mark.parametrize("case", ["ties", "zero components near", "zero components far",
                                  "zero normals", "far offsets"])
def test_instanced_tri_kernel_stress(card, name, case):
    """The two-level traversal on the instanced tie soup (ties inside a
    chunk, across chunks, across instances, three instances at each offset,
    the lowest winning after the walk has met a higher one), direction
    components exactly +-0 near and far, normals with components of exactly
    +-0 (the winner's -0.0 comes out +0.0), and instances 2 km from the
    world origin with rays from near it."""
    rng = np.random.default_rng(9)
    offsets = np.array([[0.0, 0, 0], [0.02, 0, 0], [0, 0.03, 0]])
    if case == "ties":
        tris, offsets, rays = instanced_tie_soup(rng, 30_011)
    else:
        v, f = wood_skeleton(np.random.default_rng(7), n_branches=60)
        soup = mesh_from_vertices((v * 1e-3).astype(np.float32), f)
        tris = (soup.v0, soup.e1, soup.e2)
        if case == "zero normals":
            tris = zero_normal_tris(rng, *tris, share=1.0)
            rays = edge_rays(rng, 100_037, type(soup)(*tris), offsets)
        elif case == "far offsets":
            offsets = np.array([[2.0, 0, 0], [0, -2.0, 0], [1.4, 1.4, 0.3]])
            rays = edge_rays(rng, 100_037, soup, offsets,
                             origins=rng.uniform(-0.01, 0.01, (100_037, 3)))
        else:
            rays = axis_rays(rng, 100_037, soup, 1e-3 if case.endswith("far") else 1e-5,
                             offsets)
    args = [torch.tensor(np.ascontiguousarray(a, np.float32), device=card)
            for a in (*rays, *tris, offsets)]
    got = _held(ti, name, args)
    assert got[-1].any()
    if case == "zero normals" and len(got) == 3:
        assert not torch.signbit(got[1][got[1] == 0]).any()


@pytest.mark.parametrize(
    "name", ["ray_tris_nearest", "ray_tris_occluded", "ray_tris_nearest_instanced",
             "ray_tris_occluded_instanced"]
)
@pytest.mark.parametrize("case", ["edges near", "edges far", "zero components", "vertices",
                                  "ties", "far offsets"])
def test_tri_f64_kernel_equals_plain_version(card, name, case):
    """The float64 builds against their float64 plain versions: the
    60-branch wood skeleton in float64 (at three offsets for the instanced
    kernels; or 2 km from the world origin, at three offsets there for the
    instanced kernels, with rays from near the origin),
    rays at its edges from 0.5-3 m and 50-300 m, with direction components
    of +-0, and exactly at its vertices; the tie soups taken into float64."""
    instanced = name.endswith("instanced")
    f64 = np.float64
    rng = np.random.default_rng(19)
    offsets = np.array([[0.0, 0, 0], [0.02, 0, 0], [0, 0.03, 0]]) if instanced else None
    B = 100_037
    if case == "ties":
        if instanced:
            tris, offsets, rays = instanced_tie_soup(rng, 30_011, dtype=f64)
        else:
            tris, rays = tie_soup(rng, 30_011, dtype=f64)
    else:
        v, f = wood_skeleton(np.random.default_rng(7), n_branches=60)
        if case == "far offsets" and not instanced:
            v = v + np.array([2000.0, -2000.0, 300.0])  # the flat soup itself 2 km away
        soup = mesh_from_vertices((v * 1e-3).astype(f64), f)
        tris = (soup.v0, soup.e1, soup.e2)
        if case == "far offsets":
            if instanced:
                offsets = np.array([[2.0, 0, 0], [0, -2.0, 0], [1.4, 1.4, 0.3]])
            rays = edge_rays(rng, B, soup, offsets, origins=rng.uniform(-0.01, 0.01, (B, 3)),
                             dtype=f64)
        elif case == "vertices":
            verts = v * 1e-3 if offsets is None else np.concatenate([v * 1e-3 + o
                                                                     for o in offsets])
            rays = vertex_rays(rng, B, verts, 1e-5, dtype=f64)
        elif case == "zero components":
            rays = axis_rays(rng, B, soup, 1e-3, offsets, dtype=f64)
        else:
            rays = edge_rays(rng, B, soup, offsets, 1e-3 if case.endswith("far") else 1e-5,
                             dtype=f64)
    arrays = (*rays, *tris) + ((offsets,) if instanced else ())
    args = [torch.tensor(np.ascontiguousarray(a, f64), device=card) for a in arrays]
    got = _held(ti, name, args)
    assert got[0].dtype == (torch.float64 if len(got) == 3 else torch.bool)
    assert got[-1].any()


@pytest.mark.parametrize("B", [1, 100_037])
@pytest.mark.parametrize("L", [232, 1200])
def test_slant_tau_kernel_equals_plain_version(card, B, L):
    rng = np.random.default_rng(5)
    radii = (6378.1 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 0.5, L))])).astype(np.float32)
    sigma = (rng.uniform(0, 1, L) * np.exp(-np.arange(L) / 40.0) * 1e-2).astype(np.float32)
    sigma[L // 2 : L // 2 + 5] = 0.0  # vacuum shells
    r = rng.uniform(radii[0], radii[-1], B)
    n = rng.normal(size=(B, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = (n * r[:, None]).astype(np.float32)
    w = np.array([np.sin(1.3), 0.0, np.cos(1.3)], np.float32)
    args = [torch.tensor(a, device=card) for a in (p, w, radii, sigma)]
    before = sf.launches["slant_tau"]
    got = sf.slant_tau(*args)
    torch.cuda.synchronize()
    assert sf.launches["slant_tau"] == before + 1
    want = sf.slant_tau_exact(*args)
    assert torch.equal(got, want)
    if B > 1:
        blocked = got == TAU_BLOCKED
        assert blocked.any() and not blocked.all()


SUN_85 = np.array([np.sin(np.deg2rad(85.0)), 0.0, np.cos(np.deg2rad(85.0))], np.float32)
STRESS_COLUMNS = ["232 shells", "232 shells, vacuum", "1200 shells"]


def stress_problem(card, column, axis, B=100_037):
    radii, sigma = shells.stress_columns(np.random.default_rng(8))[column]
    w = shells.AXIS_W if axis else SUN_85
    p = shells.stress_points(np.random.default_rng(9), radii, w, B)
    return [torch.tensor(a, device=card) for a in (p, w, radii, sigma)]


def test_slant_division_equals_the_ieee_division(card):
    """The slant loop's division (the IEEE division's fast path without its
    range check) against numpy's IEEE float32 division, bit for bit."""
    n, d = shells.division_operands(np.random.default_rng(3))
    got = sf.slant_division(torch.tensor(n, device=card), torch.tensor(d, device=card))
    want = n / d
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("column", STRESS_COLUMNS)
@pytest.mark.parametrize("axis", [True, False])
def test_slant_tau_kernel_stress(card, column, axis):
    args = stress_problem(card, column, axis)
    before = sf.launches["slant_tau"]
    got = sf.slant_tau(*args)
    torch.cuda.synchronize()
    assert sf.launches["slant_tau"] == before + 1
    same_bits([got], [sf.slant_tau_exact(*args)])


@pytest.mark.parametrize("column", STRESS_COLUMNS)
@pytest.mark.parametrize("axis", [True, False])
def test_shell_event_kernel_stress(card, column, axis):
    """No flight (t_max = 0, d with negative components so that the step adds
    -0 and keeps a -0 coordinate): the slant stage sees the stress points."""
    p, w, radii, sigma = stress_problem(card, column, axis)
    B = p.shape[0]
    d = torch.full((B, 3), -(3.0**-0.5), device=card)
    t_max = torch.zeros(B, device=card)
    tau_s = torch.ones(B, device=card)
    args = (p, d, t_max, radii, sigma, tau_s, w)
    before = sf.launches["shell_event"]
    got = sf.shell_event(*args)
    torch.cuda.synchronize()
    assert sf.launches["shell_event"] == before + 1
    same_bits(got, sf.shell_event_plain(*args))
    same_bits([got[3]], [sf.slant_tau(p, w, radii, sigma)])


FLIGHT_COLUMNS = list(shells.flight_columns(np.random.default_rng(8)))


@pytest.mark.parametrize("column", FLIGHT_COLUMNS)
def test_flight_kernels_stress(card, column):
    """K2 and K3 bit for bit against their plain versions on the flight's
    stresses (the column's size sets the checkpoint stride), and K4 at K2's
    event points equal to K3's tau_sun."""
    radii, sigma = shells.flight_columns(np.random.default_rng(8))[column]
    p, d, t_max, tau_s = shells.flight_stress_inputs(np.random.default_rng(5), radii, sigma,
                                                     100_037, device=card)
    radii, sigma, w = (torch.tensor(a, device=card) for a in (radii, sigma, SUN_85))
    flight = (p, d, t_max, radii, sigma, tau_s)
    before = dict(sf.launches)
    got = sf.shell_flight(*flight)
    event = sf.shell_event(*flight, w)
    torch.cuda.synchronize()
    assert sf.launches["shell_flight"] == before["shell_flight"] + 1
    assert sf.launches["shell_event"] == before["shell_event"] + 1
    same_bits(got, sf.shell_flight_plain(*flight))
    same_bits(event, sf.shell_event_plain(*flight, w))
    p_event = fma(d, torch.where(got[0], got[1], t_max)[:, None], p).contiguous()
    same_bits([sf.slant_tau(p_event, w, radii, sigma)], [event[3]])


def test_flight_root_equals_sqrtf(card):
    """The flight loop's square root (the IEEE square root's fast path
    without its range check) equals sqrtf on every float32 of its range."""
    assert sf.flight_root_differences(card) == 0


def test_shell_layout_matches_the_library(card):
    """The wrapper's checkpoint stride and shared-memory sizes (its launch
    checks) equal the library's at every column of 1 to 4096 shells."""
    assert sf.layout_differences(4096) == []


def f64_shells_held(card, p, d, t_max, tau_s, radii, sigma, w):
    """K2, K3 and K4's float64 builds once each, held against their twins
    bit for bit; K4 at K2's event points equal to K3's tau_sun."""
    flight = (p, d, t_max, radii, sigma, tau_s)
    before = dict(sf.launches), dict(sf.launches_f64)
    got = sf.shell_flight(*flight)
    event = sf.shell_event(*flight, w)
    p_event = fma(d, torch.where(got[0], got[1], t_max)[:, None], p).contiguous()
    slant = sf.slant_tau(p_event, w, radii, sigma)
    torch.cuda.synchronize()
    assert sf.launches == before[0]
    assert sf.launches_f64 == {k: n + 1 for k, n in before[1].items()}
    same_bits(got, sf.shell_flight_plain(*flight))
    same_bits(event, sf.shell_event_plain(*flight, w))
    same_bits([slant], [event[3]])
    same_bits([slant], [sf.slant_tau_exact(p_event, w, radii, sigma)])
    return got


@pytest.mark.parametrize("column", FLIGHT_COLUMNS)
def test_shell_f64_kernels_flight_stress(card, column):
    """The flight's stresses taken exactly into float64."""
    radii, sigma = shells.flight_columns(np.random.default_rng(8))[column]
    lanes = shells.flight_stress_inputs(np.random.default_rng(5), radii, sigma, 100_037,
                                        device=card)
    radii, sigma, w = (torch.tensor(a, device=card).double() for a in (radii, sigma, SUN_85))
    f64_shells_held(card, *(x.double() for x in lanes), radii, sigma, w)


@pytest.mark.parametrize("column", STRESS_COLUMNS)
@pytest.mark.parametrize("axis", [True, False])
def test_shell_f64_kernels_slant_stress(card, column, axis):
    """The slant's stresses taken into float64, the event given no flight."""
    p, w, radii, sigma = (x.double() for x in stress_problem(card, column, axis))
    B = p.shape[0]
    d = torch.full((B, 3), -(3.0**-0.5), dtype=torch.float64, device=card)
    zeros = torch.zeros(B, dtype=torch.float64, device=card)
    f64_shells_held(card, p, d, zeros, zeros + 1.0, radii, sigma, w)


def test_shell_f64_kernels_planet_of_1e6_km(card):
    p, d, t_max, tau_s, radii, sigma = shells.planet_inputs(np.random.default_rng(6), 200_003,
                                                            device=card)
    w = torch.tensor(SUN_85, device=card).double()
    collide, _, layer = f64_shells_held(card, p, d, t_max, tau_s, radii, sigma, w)
    assert collide.any() and not collide.all() and int(layer.max()) > 1000


# ---------------------------------------------------------------------------
# the float64 builds of the leaf sweeps (K5, K6, K7: the double modes)

LEAF_SWEEPS = ["ray_leaves_nearest", "ray_leaves_occluded", "ray_leaves_nearest_instanced",
               "ray_leaves_occluded_instanced"]


@pytest.mark.parametrize("name", LEAF_SWEEPS)
@pytest.mark.parametrize("B", [1, 100_037])
@pytest.mark.parametrize("far", [False, True])
def test_leaf_f64_kernel_equals_plain_version(card, name, B, far):
    problem = rim_problem(B, 5, name.endswith("instanced"), far, dtype=np.float64)
    got = _held(li, name, [torch.tensor(a, device=card) for a in problem])
    assert got[0].dtype == torch.float64 or name.startswith("ray_leaves_occluded")
    assert got[-1].any() or B == 1


@pytest.mark.parametrize("name", ["ray_leaves_nearest", "ray_leaves_nearest_instanced"])
def test_leaf_f64_kernel_zero_normals(card, name):
    """Float64 winners with a normal component of -0.0 come out +0.0."""
    problem = rim_problem(100_037, 6, name.endswith("instanced"), zero_normals=True,
                          dtype=np.float64)
    got = _held(li, name, [torch.tensor(a, device=card) for a in problem])
    assert got[2].any() and not torch.signbit(got[1][got[1] == 0]).any()


@pytest.mark.parametrize("name", LEAF_SWEEPS)
@pytest.mark.parametrize("case", ["ties", "zero components near", "zero components far",
                                  "grazing", "far offsets"])
def test_leaf_f64_kernel_stress(card, name, case):
    """The float64 builds on the float64 tie table (two-, three- and
    four-way ties inside a chunk, whose float64 normals the kernels sum
    again in index order, ties across chunks and, instanced, across
    instances), direction components exactly +-0 near and far, grazing
    rays and (instanced) instances 200 units from the world origin."""
    inst = name.endswith("instanced")
    if case == "far offsets" and not inst:
        pytest.skip("instances only")
    rng = np.random.default_rng(10)
    offsets = np.array([[0.0, 0, 0], [5.0, 0, 0], [0, 7.0, 0]])
    f64 = np.float64
    if case == "ties":
        table, offsets, rays = disks.instanced_tie_disks(rng, 30_011, dtype=f64)
    else:
        table = disks.random_disks(rng, 700)
        if case == "far offsets":
            offsets = np.array([[200.0, 0, 0], [0, -200.0, 0], [140.0, 140.0, 30.0]])
            rays = disks.rim_rays(rng, 100_037, *table, offsets,
                                  origins=rng.uniform(-1, 1, (100_037, 3)), dtype=f64)
        elif case == "grazing":
            rays = disks.grazing_rays(rng, 100_037, *table, offsets=offsets if inst else None,
                                      dtype=f64)
        else:
            rays = disks.axis_rays(rng, 100_037, *table, 100.0 if case.endswith("far") else 1.0,
                                   offsets if inst else None, dtype=f64)
    arrays = (*rays, *table) + ((offsets,) if inst else ())
    got = _held(li, name, [torch.tensor(np.asarray(a, f64), device=card) for a in arrays])
    assert got[-1].any()


def test_leaf_f64_wrappers_refuse_mixed_dtypes(card):
    """Float64 rays against a float32 table (or the reverse) raise before
    any launch: a float64 operand is never cut to float32."""
    problem = rim_problem(1000, 7, False, dtype=np.float64)
    args = [torch.tensor(a, device=card) for a in problem]
    before = (dict(li.launches), dict(li.launches_f64))
    for mixed in (args[:3] + [a.float() for a in args[3:]], [a.float() for a in args[:3]] + args[3:]):
        with pytest.raises(TypeError):
            li.ray_leaves_nearest(*mixed)
    assert (li.launches, li.launches_f64) == before
