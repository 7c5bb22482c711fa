"""Ray / triangle sweeps: the CUDA kernels' wrappers and their plain versions.

Four functions, the counterparts of the TPU kernels of
``eradiate_tpu/ops/pallas/tri_intersect.py``:

* :func:`ray_tris_nearest` / :func:`ray_tris_occluded`: nearest hit (with the
  geometric normal) and any hit of rays against a flat triangle soup, stored
  pre-differenced as ``v0``, ``e1 = v1 - v0``, ``e2 = v2 - v0``; the kernels
  traverse a bounding volume hierarchy of the soup (:func:`tri_bvh`);
* :func:`ray_tris_nearest_instanced` / :func:`ray_tris_occluded_instanced`:
  the same against ``I`` translated copies of one canonical soup, which is
  stored once; the kernels traverse a hierarchy of two levels, the
  instances' boxes above the canonical soup's own hierarchy
  (:func:`tri_instanced_bvh`).

For CUDA tensors they launch ``csrc/tri_intersect.cu``: float32 tensors
its float32 kernels, float64 tensors (the double modes) their float64
builds (``*_f64``, counted in :data:`launches_f64`); mixed or other dtypes
raise. For CPU tensors they run the plain versions (``*_plain``), the
chunked sweeps of the reference's ``ops/mesh.py`` (``ray_tris_nearest``,
``ray_tris_occluded``, ``_instanced_tris_nearest_xla`` and the instance
scan of ``tri_occluded``), in either dtype, as the reference computes them
jitted (under x64 for float64). They never fall back from one to the other.

Semantics shared by kernel and plain version. They follow the reference's XLA
form, not its TPU kernels (which tie within 1024-triangle blocks and
normalise with ``rsqrt`` and a ``1e-24`` clamp):

* Moller-Trumbore: ``pvec = d x e2``, ``det = e1.pvec``, ``inv = 1 / det``
  where ``|det| > 1e-12`` (else no hit), ``tvec = p - v0``,
  ``u = (tvec.pvec) inv``, ``qvec = tvec x e1``, ``v = (d.qvec) inv``,
  ``t = (e2.qvec) inv``; a hit where ``u >= 0``, ``v >= 0``, ``u + v <= 1``
  and ``1e-7 < t < t_max``. Lengths are km;
* rounding as XLA:CPU rounds the jitted reference, because a closed fan of
  triangles decides on the last bit whether a ray through a shared edge hits
  one triangle, both or neither: each cross-product component is
  ``fma(a_i, b_j, -(a_j b_i))``; ``det``, ``d.qvec`` and ``e2.qvec`` are the
  first product then two fused multiply-adds (:func:`dot3`); ``tvec.pvec`` is
  three products and two sums, unfused; the quotient is ``1 / det`` followed
  by multiplications; XLA:CPU contracts the float64 graph under x64 the
  same way;
* the geometric normal is ``cross(e1, e2) / max(|cross(e1, e2)|, 1e-12)``
  (:func:`tri_normals`), the norm the square root of the contracted
  ``dot3``, taken in float64 and rounded to float32 for float32 triangles;
* an instance translates the ray, ``p - offset``, not the triangles;
* exact ties of ``t`` inside one 512-triangle chunk of one instance average
  their unit normals (the average is not renormalised); across chunks and
  instances the first wins. The winners' normals are summed into a zero,
  as the reference sums them, so a component -0.0 comes out +0.0. Tied
  float32 normals are summed in float64, exactly, so the result does not
  depend on the order of the sum; tied float64 normals are summed from zero
  in index order, the reference's order (two sum alike in either order;
  the float64 kernels sum three or more again in index order after their
  walk). A kernel that visits the triangles out of index order (the
  hierarchy's traversal) applies the rule as: a hit replaces the best when
  its ``t`` is smaller, or equal with a lower key; it adds its normal when
  ``t`` and key are equal. The key is the chunk, original index // 512
  (:func:`ray_tris_nearest_bvh_plain`),
  and for the instanced kernels ``instance * ceil(N / 512) + index // 512``
  with the instance's row in ``offsets``
  (:func:`ray_tris_nearest_instanced_bvh_plain`);
* misses keep ``t = t_max`` and the normal ``(0, 0, 1)``.

The float64 plain sweeps run the exact test, whose emulated float64 fused
multiply-adds cost ~45 operations each, only where the ray's line passes
near the triangle (:func:`_line_near`), as the leaf sweeps' plain versions
do; the result is the dense test's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh import (
    LEAF,
    STACK,
    TOP_STACK,
    _round_down,
    _round_up,
    build,
    bvh_leaves,
    bvh_leaves_reached_plain,
    instance_level,
    instanced_nearest_plain,
    nearest_over_instances,
    nearest_plain,
    occluded_over_instances,
)
from .dual import refuse_tangents
from .leaf_intersect import (
    _build,
    _check_operands,
    _launch,
    _on_cpu,
    _sum_in_index_order,
    dot3,
    fma,
)

__all__ = [
    "CHUNK",
    "LEAF",
    "STACK",
    "TOP_STACK",
    "InstancedTriBVH",
    "TriBVH",
    "launches",
    "launches_f64",
    "tri_bvh",
    "tri_instanced_bvh",
    "bvh_leaves",
    "bvh_leaves_reached_plain",
    "tri_normals",
    "ray_tris_nearest",
    "ray_tris_occluded",
    "ray_tris_nearest_instanced",
    "ray_tris_occluded_instanced",
    "ray_tris_nearest_plain",
    "ray_tris_occluded_plain",
    "ray_tris_nearest_bvh_plain",
    "ray_tris_nearest_instanced_bvh_plain",
    "ray_tris_nearest_instanced_plain",
    "ray_tris_occluded_instanced_plain",
]

#: Triangles per chunk of the plain sweep, which is also the tie-averaging
#: unit (reference ``ray_tris_nearest(chunk=512)``).
CHUNK = 512
_EPS_T = 1e-7
_DET_MIN = 1e-12

#: Kernel launches made in this process, by kernel name: ``launches`` the
#: float32 kernels', ``launches_f64`` their float64 builds'.
launches = {
    "ray_tris_nearest": 0,
    "ray_tris_occluded": 0,
    "ray_tris_nearest_instanced": 0,
    "ray_tris_occluded_instanced": 0,
}
launches_f64 = {f"{k}_f64": 0 for k in launches}


# ---------------------------------------------------------------------------
# the kernels' bounding volume hierarchies


@dataclasses.dataclass(frozen=True)
class TriBVH:
    """The flat kernels' acceleration structure, made by :func:`tri_bvh`.

    ``nodes`` [M, 16] float32: the inner nodes of :mod:`~.bvh` (a leaf
    holds ``count`` rows of ``tris`` from ``first``). Row 0 is the root.

    ``tris`` [N, 12] in the soup's dtype, float32 or float64: the triangles
    in leaf order, three float4 (double4) each: ``v0`` with the original
    index's int32 (int64) bits in the fourth element, ``e1`` and ``e2`` with
    a zero; bitwise copies of the inputs. The nodes stay float32 for
    either: the boxes are rounded outward from the float64 vertices, and
    the float64 kernels test them with their ray rounded to float32
    (:func:`~.bvh.box_ray`).

    ``depth``: inner nodes on the longest path from the root to a leaf; the
    kernels' stack holds :data:`STACK`."""

    nodes: torch.Tensor
    tris: torch.Tensor
    depth: int


def tri_bvh(v0, e1, e2) -> TriBVH:
    """The flat kernels' bounding volume hierarchy of a soup (``v0``,
    ``e1``, ``e2`` [N, 3] tensors of one dtype, float32 or float64), built
    on the host with numpy and returned on their device
    (:func:`~.bvh.build`: binned SAH, leaves of at most :data:`LEAF`
    triangles, each referenced once). A triangle's box is that of its
    vertices ``v0``, ``v0 + e1``, ``v0 + e2`` summed in float64 and rounded
    outward to float32; for a float64 soup those sums are themselves
    rounded, so the box is first widened by one float64 ulp on each side.
    Deterministic: the same soup gives the same bytes. Raises if the soup
    is empty, not of one dtype float32 or float64, or the tree is deeper
    than :data:`STACK`. Compute once per render and pass as ``bvh``."""
    device = v0.device
    v0n, e1n, e2n = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (v0, e1, e2))
    dt = v0n.dtype
    if dt not in (np.float32, np.float64) or e1n.dtype != dt or e2n.dtype != dt:
        raise TypeError("tri_bvh: v0, e1 and e2 must be all float32 or all float64, got "
                        f"{v0n.dtype}, {e1n.dtype}, {e2n.dtype}")
    N = v0n.shape[0]
    if N < 1:
        raise ValueError("tri_bvh: needs at least one triangle")
    if N >= 2**28:
        raise ValueError("tri_bvh: more than 2^28 - 1 triangles")
    a = v0n.astype(np.float64)
    verts = np.stack([a, a + e1n, a + e2n])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    if dt == np.float64:
        lo, hi = np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)
    nodes, perm, depth = build(_round_down(lo), _round_up(hi), "tri_bvh")
    tris = np.zeros((N, 12), dt)
    tris[:, 0:3], tris[:, 4:7], tris[:, 8:11] = v0n[perm], e1n[perm], e2n[perm]
    tris[:, 3] = perm.astype(np.int32 if dt == np.float32 else np.int64).view(dt)
    return TriBVH(torch.from_numpy(nodes).to(device), torch.from_numpy(tris).to(device), depth)


@dataclasses.dataclass(frozen=True)
class InstancedTriBVH:
    """The instanced kernels' acceleration structure, made by
    :func:`tri_instanced_bvh`: two levels.

    ``canonical``: the canonical soup's :class:`TriBVH`, in its own frame.

    ``top`` [M, 16] float32 (for either soup dtype): the inner nodes of
    :mod:`~.bvh` over the instances (a leaf holds ``count`` rows of
    ``instances`` from ``first``), each instance's box the canonical root
    box moved by its offset (:func:`~.bvh.instance_level`). Row 0 is the
    root.

    ``instances`` [I, 4] in the soup's dtype: the offsets in the top level's
    leaf order, ``(ox, oy, oz, original row as int32 (int64) bits)``;
    bitwise copies of the inputs. The row, not the position, is the
    instance in the tie key.

    ``top_depth``: inner nodes on the longest path from the top's root to a
    leaf; the kernels' outer stack holds :data:`TOP_STACK`."""

    canonical: TriBVH
    top: torch.Tensor
    instances: torch.Tensor
    top_depth: int


def tri_instanced_bvh(v0, e1, e2, offsets) -> InstancedTriBVH:
    """The instanced kernels' hierarchy of the canonical soup (``v0``,
    ``e1``, ``e2`` [N, 3]) at ``offsets`` [I, 3], tensors of one dtype,
    float32 or float64: :func:`tri_bvh` of the soup below, the instances'
    boxes (:func:`~.bvh.instance_level`) above, built on the host with numpy
    and returned on the tensors' device. Deterministic: the same inputs give
    the same bytes. Raises as :func:`tri_bvh` does, and if there is no
    instance, the offsets are not of the soup's dtype, or the top level is
    deeper than :data:`TOP_STACK`. Compute once per render and pass as
    ``bvh``."""
    o = np.ascontiguousarray(offsets.detach().cpu().numpy())
    if o.dtype != v0.cpu().numpy().dtype:
        raise TypeError(f"tri_instanced_bvh: offsets are {o.dtype}, v0 {v0.dtype}: one dtype "
                        "for all")
    if o.ndim != 2 or o.shape[1] != 3 or o.shape[0] < 1:
        raise ValueError(f"tri_instanced_bvh: offsets must be [I >= 1, 3], got {list(o.shape)}")
    canonical = tri_bvh(v0, e1, e2)
    top, instances, depth = instance_level(canonical.nodes.cpu().numpy(), o, "tri_instanced_bvh")
    device = v0.device
    return InstancedTriBVH(canonical, torch.from_numpy(top).to(device),
                           torch.from_numpy(instances).to(device), depth)


# ---------------------------------------------------------------------------
# plain versions


def _cross(a, b):
    """Cross product over the last axis, each component
    ``fma(a_i, b_j, -(a_j b_i))`` as XLA:CPU contracts it."""
    def comp(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def _sqrt_rn(x):
    """The correctly rounded square root of a float64 tensor, as XLA's and
    the card's (``__dsqrt_rn``) are: torch's CPU square root is off by one
    ulp on about 0.7% of float64 inputs, so CPU tensors take numpy's (the
    processor's)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def tri_normals(e1, e2):
    """Unit geometric normals [N, 3] of triangles with edges ``e1``, ``e2``
    [N, 3]: ``cross(e1, e2) / max(norm, 1e-12)``, rounded as the jitted
    reference's chunk rounds it (``jnp.linalg.norm``: the correctly rounded
    square root of the contracted ``dot3``; for float32 triangles taken in
    float64 and rounded once to float32)."""
    n = _cross(e1, e2)
    if n.dtype == torch.float64:
        norm = _sqrt_rn(dot3(n, n))
    else:
        norm = torch.sqrt(dot3(n, n).double()).float()
    return n / torch.clamp(norm, min=1e-12)[:, None]


def _exact_hits(p, d, v0, e1, e2, t_max):
    """The Moller-Trumbore test of rays ``p``, ``d`` [..., 3] with caps
    ``t_max`` [...] against triangles broadcast with them: ``t`` where hit,
    else +inf (reference ``mesh._chunk_hits`` as XLA:CPU rounds it)."""
    pvec = _cross(d, e2)
    det = dot3(e1, pvec)
    live = torch.abs(det) > _DET_MIN
    inv_det = torch.where(live, 1.0 / det, 0.0)
    tvec = p - v0
    u = (
        (tvec[..., 0] * pvec[..., 0] + tvec[..., 1] * pvec[..., 1])
        + tvec[..., 2] * pvec[..., 2]
    ) * inv_det
    qvec = _cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    ok = (
        live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > _EPS_T) & (t < t_max)
    )
    return torch.where(ok, t, torch.inf)


#: The float64 plain sweeps' line cull: its margin, of the coordinates'
#: magnitude (the leaf sweeps' ``_LINE_SLACK``), and of the coordinates'
#: magnitude times the triangle's squared radius in km^2.
_LINE_SLACK = 2e-6
_LINE_SLACK_AREA = 1e-2


def _line_near(p, d, v0, e1, e2):
    """Bool [B, Nc], float64: does the line of ray ``p``, ``d`` [B, 3] pass
    within the bounding sphere of each triangle ``v0``, ``e1``, ``e2``
    [Nc, 3] (about ``v0 + (e1 + e2) / 3``, through its farthest vertex),
    grown by ``_LINE_SLACK`` (2e-6) of the coordinates' magnitude ``m``
    (the L1 norms of the centre from the origin of the ray and of the
    origin, plus the radius ``R``) and by ``_LINE_SLACK_AREA * m * R^2``
    (1e-2, ``R`` in km)?

    The float64 exact test accepts a triangle whose plane the line meets
    within its rounding of the triangle: that of ``u`` and ``v``, ``k eps
    |p - v0| |pvec| / |det|`` each with ``k`` a few units (8 at most),
    which puts the point at most ``k eps |p - v0| |e1| |e2| / 1e-12`` off
    the triangle in its plane, since ``|det| > 1e-12``. With ``|e1| |e2| <=
    4 R^2``, ``eps = 1.1e-16`` and ``|p - v0| <= m`` that is below ``4e-3 m
    R^2``: the second term covers it 2.5 times over, and for triangles of a
    few metres (a trunk, a branch: ``R <= 5e-3`` km) the first 20 times
    over. The first also covers a direction of norm ``1 +- 1e-7`` (a
    float32 unit vector taken into float64), which moves the computed
    distance of the line by ``2e-7 m`` at most. A triangle the exact test
    accepts therefore lies within the grown sphere of the line, and
    skipping the others leaves the result the dense test's."""
    c = v0 + (e1 + e2) / 3.0
    verts = torch.stack([v0, v0 + e1, v0 + e2])
    R = torch.sqrt(((verts - c) ** 2).sum(-1)).max(dim=0).values  # [Nc]
    v = c[None] - p[:, None]  # [B, Nc, 3]
    tc = (v * d[:, None]).sum(-1)
    e = v - d[:, None] * tc[..., None]
    m = v.abs().sum(-1) + p.abs().sum(-1)[:, None] + R[None]
    reach = R[None] + m * (_LINE_SLACK + _LINE_SLACK_AREA * (R * R)[None])
    return (e * e).sum(-1) <= reach * reach


def _chunk_hits(p, d, v0, e1, e2, t_max):
    """Moller-Trumbore distances [B, Nc] of rays against a triangle chunk,
    +inf where missed (reference ``mesh._chunk_hits`` as XLA:CPU rounds
    it). float64: the exact test only on the pairs :func:`_line_near`
    keeps, with the same result."""
    if p.dtype != torch.float64:
        return _exact_hits(p[:, None], d[:, None], v0[None], e1[None], e2[None], t_max[:, None])
    b, k = torch.nonzero(_line_near(p, d, v0, e1, e2), as_tuple=True)
    t = torch.full((p.shape[0], v0.shape[0]), torch.inf, dtype=p.dtype, device=p.device)
    t[b, k] = _exact_hits(p[b], d[b], v0[k], e1[k], e2[k], t_max[b])
    return t


def _chunks(v0, e1, e2, chunk):
    for start in range(0, v0.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield v0[sl], e1[sl], e2[sl]


def ray_tris_nearest_plain(p, d, t_max, v0, e1, e2, chunk: int = CHUNK):
    """Nearest triangle hit along ``p + t d`` for t in (0, t_max): the
    chunked dense sweep. Returns ``(t_hit [B], normal [B, 3], hit [B])``."""
    B = p.shape[0]
    best_t = torch.full((B,), torch.inf, dtype=p.dtype, device=p.device)
    best_n = torch.zeros((B, 3), dtype=p.dtype, device=p.device)
    best_n[:, 2] = 1.0
    for a, b, c in _chunks(v0, e1, e2, chunk):
        t = _chunk_hits(p, d, a, b, c, t_max)
        n_tri = tri_normals(b, c)
        tmin, first = t.min(dim=1)
        # the reference sums the winners' normals into a zero, which turns a
        # component -0.0 into +0.0; exact ties average their normals, and
        # they are rare, so only those lanes pay for the masked sum: float32
        # normals summed in float64 (exact, so the order does not matter),
        # float64 ones in index order as the reference sums them
        n_sel = n_tri[first] + 0.0
        m = (t == tmin[:, None]) & torch.isfinite(tmin)[:, None]
        cnt = m.sum(dim=1)
        tied = torch.nonzero(cnt > 1)[:, 0]
        if tied.numel():
            if n_tri.dtype == torch.float32:
                s = ((m[tied, :, None] * n_tri.double()[None]).sum(dim=1) + 0.0).float()
            else:
                s = _sum_in_index_order(m[tied], n_tri)
            n_sel[tied] = s / cnt[tied, None].to(t.dtype)
        better = tmin < best_t
        best_n = torch.where(better[:, None], n_sel, best_n)
        best_t = torch.where(better, tmin, best_t)
    hit = torch.isfinite(best_t)
    return torch.where(hit, best_t, t_max), best_n, hit


def ray_tris_occluded_plain(p, d, t_max, v0, e1, e2, chunk: int = CHUNK):
    """True where any triangle blocks the segment (shadow rays)."""
    occ = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for a, b, c in _chunks(v0, e1, e2, chunk):
        occ = occ | torch.isfinite(_chunk_hits(p, d, a, b, c, t_max)).any(dim=1)
    return occ


def ray_tris_nearest_bvh_plain(p, d, t_max, bvh: TriBVH, order=None):
    """:func:`ray_tris_nearest_plain` as the flat kernel computes it: the
    triangles of ``bvh`` visited one at a time in ``order`` (a permutation of
    the rows of ``bvh.tris``; default their leaf order), each ray testing
    only those in leaves its cull reaches with the cap ``t_max``, with the
    order-free tie rule: a hit replaces the best when its ``t`` is smaller,
    or equal with a lower chunk (original index // :data:`CHUNK`); it adds
    its normal (float64 sum, from zero) when ``t`` and chunk are equal; three
    or more tied float64 normals are summed again in index order, as the
    float64 kernel sums them (:func:`~.bvh.nearest_record`). Equals the
    dense sweep bit for bit whatever the order."""
    tris = bvh.tris
    v0, e1, e2 = tris[:, 0:3], tris[:, 4:7], tris[:, 8:11]
    t, normals = _chunk_hits(p, d, v0, e1, e2, t_max), tri_normals(e1, e2)
    return nearest_plain(p, d, t_max, bvh, tris, lambda k: (t[:, k], normals[k]), order, CHUNK)


def ray_tris_nearest_instanced_bvh_plain(p, d, t_max, ibvh: InstancedTriBVH, order=None):
    """:func:`ray_tris_nearest_instanced_plain` as the instanced kernel
    computes it: the (instance, triangle) pairs of ``ibvh`` visited one at a
    time in ``order`` (a permutation of ``range(I * N)``, pair ``j * N + k``
    being row ``j`` of ``ibvh.instances`` and row ``k`` of the canonical
    ``tris``; default the leaf order of both levels), each ray testing only
    the pairs whose top leaf it reaches with the world ray and whose
    canonical leaf it reaches with the translated ray ``p - offset``, both
    with the cap ``t_max``; with the order-free tie rule on the key
    ``instance * ceil(N / 512) + index // 512``, the instance being the
    offset's original row. Equals the dense instanced sweep bit for bit
    whatever the order."""
    tris = ibvh.canonical.tris
    v0, e1, e2 = tris[:, 0:3], tris[:, 4:7], tris[:, 8:11]
    return instanced_nearest_plain(p, d, t_max, ibvh, tris,
                                   lambda pj: _chunk_hits(pj, d, v0, e1, e2, t_max),
                                   tri_normals(e1, e2), order, CHUNK)


def ray_tris_nearest_instanced_plain(p, d, t_max, v0, e1, e2, offsets):
    """Nearest hit against the translated copies: the canonical soup swept
    in each instance's frame, the winner kept in instance order
    (:func:`~.bvh.nearest_over_instances`)."""
    return nearest_over_instances(
        p, d, t_max, offsets,
        lambda pj, dj, tj: ray_tris_nearest_plain(pj, dj, tj, v0, e1, e2))


def ray_tris_occluded_instanced_plain(p, d, t_max, v0, e1, e2, offsets):
    """Any hit against the translated copies."""
    return occluded_over_instances(
        p, d, t_max, offsets,
        lambda pj, dj, tj: ray_tris_occluded_plain(pj, dj, tj, v0, e1, e2))


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(name, named, B, N, offsets, depth=None, top_depth=None):
    """Validate the operands of a launch: ``named`` holds the rays, the
    soup (with the ``offsets`` of an instanced one) and the hierarchy: a
    :class:`TriBVH`'s ``nodes`` and ``tris`` with its ``depth``, and for the
    instanced kernels an :class:`InstancedTriBVH`'s ``top`` and
    ``instances`` with its ``top_depth``. float32 and float64 soups are
    taken, each in one dtype."""
    shapes = {"p": (B, 3), "d": (B, 3), "t_max": (B,), "v0": (N, 3), "e1": (N, 3),
              "e2": (N, 3)}
    if "nodes" in named:
        shapes["nodes"] = (max(named["nodes"].shape[0], 1), 16)
        shapes["tris"] = (N, 12)
    if offsets is not None:
        shapes["offsets"] = (offsets.shape[0], 3)
    if "top" in named:
        shapes["top"] = (max(named["top"].shape[0], 1), 16)
        shapes["instances"] = (offsets.shape[0], 4)
    _check_operands(name, named, shapes, depth, (torch.float32, torch.float64))
    if top_depth is not None and not 1 <= top_depth <= TOP_STACK:
        raise ValueError(f"{name}: a top level {top_depth} deep, the kernels' outer stack "
                         f"holds {TOP_STACK}")
    if N < 1:
        raise ValueError(f"{name}: needs at least one triangle")
    if offsets is not None and offsets.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one instance")
    if B >= 2**31 or N >= 2**28:
        raise ValueError(f"{name}: more than 2^31 - 1 lanes or 2^28 - 1 triangles")
    if offsets is not None and offsets.shape[0] * -(-N // CHUNK) >= 2**31:
        raise ValueError(f"{name}: instances x 512-triangle chunks must stay below 2^31 (the "
                         "kernels' int32 tie key)")


def _launch_flat(name, nearest, p, d, t_max, v0, e1, e2, bvh):
    """The flat kernels: check the rays, the soup and its hierarchy (built
    here when ``bvh`` is None), launch the traversal. The float64 nearest
    hit also reads the soup in its original order, where it sums three or
    more tied normals in index order."""
    if bvh is None:
        bvh = tri_bvh(v0, e1, e2)
    if not isinstance(bvh, TriBVH):
        raise TypeError(f"{name}: bvh must be a TriBVH (tri_bvh), got {type(bvh).__name__}")
    named = {"p": p, "d": d, "t_max": t_max, "v0": v0, "e1": e1, "e2": e2,
             "nodes": bvh.nodes, "tris": bvh.tris}
    B, N = p.shape[0], v0.shape[0]
    _check(name, named, B, N, None, depth=bvh.depth)
    if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16:
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    kernel, counts = _build(name, p, launches, launches_f64)
    ins, sizes = (p, d, t_max, bvh.nodes, bvh.tris), (B,)
    if nearest and p.dtype == torch.float64:
        ins, sizes = ins + (v0, e1, e2), (B, N)
    return _launch(kernel, nearest, p, ins, sizes, counts)


def _launch_instanced(name, nearest, p, d, t_max, v0, e1, e2, offsets, bvh):
    """The instanced kernels: check the rays, the soup, the offsets and
    their two-level hierarchy (built here when ``bvh`` is None), launch the
    traversal. The float64 nearest hit also reads the soup and the offsets
    in their original order (:func:`_launch_flat`)."""
    if bvh is None:
        bvh = tri_instanced_bvh(v0, e1, e2, offsets)
    if not isinstance(bvh, InstancedTriBVH):
        raise TypeError(f"{name}: bvh must be an InstancedTriBVH (tri_instanced_bvh), got "
                        f"{type(bvh).__name__}")
    canon = bvh.canonical
    named = {"p": p, "d": d, "t_max": t_max, "v0": v0, "e1": e1, "e2": e2,
             "offsets": offsets, "nodes": canon.nodes, "tris": canon.tris, "top": bvh.top,
             "instances": bvh.instances}
    B, N = p.shape[0], v0.shape[0]
    _check(name, named, B, N, offsets, depth=canon.depth, top_depth=bvh.top_depth)
    arrays = (bvh.top, bvh.instances, canon.nodes, canon.tris)
    if any(t.data_ptr() % 16 for t in arrays):
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    kernel, counts = _build(name, p, launches, launches_f64)
    ins = (p, d, t_max, *arrays)
    sizes = (B, N) if nearest else (B,)  # the nearest hit's tie key needs N
    if nearest and p.dtype == torch.float64:
        ins = ins + (v0, e1, e2, offsets)
    return _launch(kernel, nearest, p, ins, sizes, counts)


def _plain(name, p, *tensors):
    """True where the operands lie on the CPU (the plain versions run), after
    checking that the rays and the soup (and offsets) are all float32 or
    all float64: a float64 operand is never cut to float32."""
    cpu = _on_cpu(p, name)
    if cpu and ({t.dtype for t in tensors} | {p.dtype}) not in ({torch.float32},
                                                                {torch.float64}):
        raise TypeError(f"{name}: rays and triangles must be all float32 or all float64, got "
                        f"{sorted({str(t.dtype) for t in (p, *tensors)})}")
    return cpu


def ray_tris_nearest(p, d, t_max, v0, e1, e2, bvh=None):
    """Nearest triangle hit of rays ``p`` [B, 3], ``d`` [B, 3] (unit) within
    ``t_max`` [B] against triangles ``v0``, ``e1``, ``e2`` [N, 3], all
    float32 or all float64. Returns ``(t_hit [B], normal [B, 3], hit [B]
    bool)`` in their dtype. ``bvh`` optionally passes :func:`tri_bvh` of the
    soup. CUDA tensors go through the kernel of their dtype, float32 or its
    float64 build (the wrapper checks device, dtype, contiguity, shapes and
    the hierarchy's depth, and raises on mixed or other dtypes and if the
    launch fails); CPU tensors through :func:`ray_tris_nearest_plain`."""
    refuse_tangents("ray_tris_nearest", p=p, d=d, t_max=t_max, v0=v0, e1=e1, e2=e2)
    if _plain("ray_tris_nearest", p, d, t_max, v0, e1, e2):
        return ray_tris_nearest_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_nearest", True, p, d, t_max, v0, e1, e2, bvh)


def ray_tris_occluded(p, d, t_max, v0, e1, e2, bvh=None):
    """True [B] where any triangle blocks the segment; operands as
    :func:`ray_tris_nearest`."""
    refuse_tangents("ray_tris_occluded", p=p, d=d, t_max=t_max, v0=v0, e1=e1, e2=e2)
    if _plain("ray_tris_occluded", p, d, t_max, v0, e1, e2):
        return ray_tris_occluded_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_occluded", False, p, d, t_max, v0, e1, e2, bvh)[0]


def ray_tris_nearest_instanced(p, d, t_max, v0, e1, e2, offsets, bvh=None):
    """:func:`ray_tris_nearest` against the union of the canonical soup
    translated by each of ``offsets`` [I, 3]; ``bvh`` optionally passes
    :func:`tri_instanced_bvh` of the soup and the offsets."""
    refuse_tangents("ray_tris_nearest_instanced", p=p, d=d, t_max=t_max,
                    v0=v0, e1=e1, e2=e2, offsets=offsets)
    if _plain("ray_tris_nearest_instanced", p, d, t_max, v0, e1, e2, offsets):
        return ray_tris_nearest_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_nearest_instanced", True, p, d, t_max, v0, e1, e2,
                             offsets, bvh)


def ray_tris_occluded_instanced(p, d, t_max, v0, e1, e2, offsets, bvh=None):
    """:func:`ray_tris_occluded` against the translated copies."""
    refuse_tangents("ray_tris_occluded_instanced", p=p, d=d, t_max=t_max,
                    v0=v0, e1=e1, e2=e2, offsets=offsets)
    if _plain("ray_tris_occluded_instanced", p, d, t_max, v0, e1, e2, offsets):
        return ray_tris_occluded_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_occluded_instanced", False, p, d, t_max, v0, e1, e2,
                             offsets, bvh)[0]
