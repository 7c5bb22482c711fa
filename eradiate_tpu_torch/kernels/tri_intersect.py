"""Ray / triangle sweeps: the CUDA kernels' wrappers and their plain versions.

Four functions, the counterparts of the TPU kernels of
``eradiate_tpu/ops/pallas/tri_intersect.py``:

* :func:`ray_tris_nearest` / :func:`ray_tris_occluded`: nearest hit (with the
  geometric normal) and any hit of rays against a flat triangle soup, stored
  pre-differenced as ``v0``, ``e1 = v1 - v0``, ``e2 = v2 - v0``; the kernels
  traverse a bounding volume hierarchy of the soup (:func:`tri_bvh`);
* :func:`ray_tris_nearest_instanced` / :func:`ray_tris_occluded_instanced`:
  the same against ``I`` translated copies of one canonical soup, which is
  stored once; the kernels cull per group of :data:`GROUP` triangles by a
  bounding sphere (:func:`tri_sweep_spheres`).

For CUDA tensors they launch ``csrc/tri_intersect.cu``; for CPU tensors they
run the plain versions (``*_plain``), the chunked dense sweeps of the
reference's ``ops/mesh.py`` (``ray_tris_nearest``, ``ray_tris_occluded``,
``_instanced_tris_nearest_xla`` and the instance scan of ``tri_occluded``).
They never fall back from one to the other.

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
  by multiplications;
* the geometric normal is ``cross(e1, e2) / max(|cross(e1, e2)|, 1e-12)``
  (:func:`tri_normals`);
* an instance translates the ray, ``p - offset``, not the triangles;
* exact ties of ``t`` inside one 512-triangle chunk of one instance average
  their unit normals (the average is not renormalised); across chunks and
  instances the first wins. The tied normals are summed in float64, so the
  result does not depend on the order of the sum. A kernel that visits the
  triangles out of index order (the hierarchy's traversal) applies the rule
  as: a hit replaces the best when its ``t`` is smaller, or equal with a
  lower chunk (original index // 512); it adds its normal when ``t`` and
  chunk are equal (:func:`ray_tris_nearest_bvh_plain`);
* misses keep ``t = t_max`` and the normal ``(0, 0, 1)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .leaf_intersect import _launcher, _on_cpu, dot3, fma

__all__ = [
    "CHUNK",
    "GROUP",
    "LEAF",
    "STACK",
    "TriBVH",
    "launches",
    "tri_block_spheres",
    "tri_sweep_spheres",
    "tri_bvh",
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
    "ray_tris_nearest_instanced_plain",
    "ray_tris_occluded_instanced_plain",
]

#: Triangles per chunk of the plain sweep, which is also the tie-averaging
#: unit (reference ``ray_tris_nearest(chunk=512)``).
CHUNK = 512
#: Triangles per bounding sphere of the instanced kernels' cull. The result
#: does not depend on it.
GROUP = 64
#: Most triangles in a leaf of :func:`tri_bvh` (``kLeaf`` of the kernels).
LEAF = 4
#: Entries of the flat kernels' traversal stack (``kStack``): the deepest
#: hierarchy they take.
STACK = 64
#: Margins of the flat kernels' cull (``kBoxSlack``, ``kBoxCapSlack``): a
#: box is grown by BOX_SLACK times the coordinates' magnitude and the segment
#: by CAP_SLACK of the distance to the box at both ends. A sliver seen at a
#: grazing angle multiplies the exact test's rounding: on the edge-ray
#: stresses from 50-300 m the worst accepted pair needed a tenth of BOX_SLACK
#: and a fifth of CAP_SLACK (its computed t 9.4e-3 of the distance before its
#: box).
BOX_SLACK = 1e-4
CAP_SLACK = 5e-2

_EPS_T = 1e-7
_DET_MIN = 1e-12
_BINS = 16  # SAH bins per axis of the hierarchy's build

#: Kernel launches made in this process, by kernel name.
launches = {
    "ray_tris_nearest": 0,
    "ray_tris_occluded": 0,
    "ray_tris_nearest_instanced": 0,
    "ray_tris_occluded_instanced": 0,
}


def tri_block_spheres(v0, e1, e2, block_n: int = GROUP):
    """Per-triangle-block bounding spheres (centers [M, 3], radius^2 [M]) of
    ``block_n`` consecutive triangles (reference ``tri_block_spheres``): each
    covers all three vertices of every triangle of its block."""
    N = v0.shape[0]
    M = -(-N // block_n)
    pad = M * block_n - N
    verts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)  # [N, 3, 3]
    if pad:
        # the last real triangle fills the padding so the final sphere is
        # not dragged to the origin
        verts = torch.cat([verts, verts[N - 1 :].expand(pad, 3, 3)])
    verts = verts.reshape(M, 3 * block_n, 3)
    mid = (verts.min(dim=1).values + verts.max(dim=1).values) * 0.5
    diff = verts - mid[:, None, :]
    R = torch.sqrt((diff * diff).sum(dim=-1)).max(dim=1).values
    return mid, R * R


def tri_sweep_spheres(v0, e1, e2):
    """The instanced kernels' cull operand ``[1 + M, 4]`` (x, y, z,
    radius^2): row 0 bounds the whole soup (the per-instance sphere), rows
    1.. bound its :data:`GROUP`-triangle blocks. Compute once per render and
    pass as ``spheres``."""
    whole_c, whole_r2 = tri_block_spheres(v0, e1, e2, max(v0.shape[0], 1))
    sc, sr2 = tri_block_spheres(v0, e1, e2, GROUP)
    return torch.cat(
        [torch.cat([whole_c, sc]), torch.cat([whole_r2, sr2])[:, None]], dim=1
    ).contiguous()


# ---------------------------------------------------------------------------
# the flat kernels' bounding volume hierarchy


@dataclasses.dataclass(frozen=True)
class TriBVH:
    """The flat kernels' acceleration structure, made by :func:`tri_bvh`.

    ``nodes`` [M, 16] float32, one binary inner node a row in the layout of
    Aila and Laine (2009), four float4: ``(c0.lo.x, c0.hi.x, c0.lo.y,
    c0.hi.y)``, ``(c1.lo.x, c1.hi.x, c1.lo.y, c1.hi.y)``, ``(c0.lo.z, c0.hi.z,
    c1.lo.z, c1.hi.z)`` and ``(child 0, child 1, 0, 0)``, the children's
    codes as int32 bits. A code >= 0 is an inner node; a code < 0 is the leaf
    ``~(first << 3 | count)``, ``count`` (0 to :data:`LEAF`) rows of ``tris``
    from ``first``. Row 0 is the root.

    ``tris`` [N, 12] float32: the triangles in leaf order, three float4 each:
    ``v0`` with the original index's int32 bits in the fourth float, ``e1``
    and ``e2`` with a zero; bitwise copies of the inputs.

    ``depth``: inner nodes on the longest path from the root to a leaf; the
    kernels' stack holds :data:`STACK`."""

    nodes: torch.Tensor
    tris: torch.Tensor
    depth: int


def _round_down(x):
    """float64 -> the largest float32 not above it."""
    y = x.astype(np.float32)
    above = y.astype(np.float64) > x
    y[above] = np.nextafter(y[above], np.float32(-np.inf))
    return y


def _round_up(x):
    """float64 -> the smallest float32 not below it."""
    y = x.astype(np.float32)
    below = y.astype(np.float64) < x
    y[below] = np.nextafter(y[below], np.float32(np.inf))
    return y


def _half_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _sah_split(cent, lo, hi, seg, lens):
    """One level of the build: for each of ``S`` segments (the elements of
    segment ``s`` are the rows with ``seg == s``, contiguous, ``lens[s]`` of
    them), the binned surface-area split over all three axes; returns a
    bool per element, True for the right side."""
    S = lens.size
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cmin = np.minimum.reduceat(cent, off, axis=0)
    cmax = np.maximum.reduceat(cent, off, axis=0)
    best = np.full(S, np.inf)
    best_axis = np.zeros(S, np.int64)
    best_bin = np.zeros(S, np.int64)
    bins = np.empty(cent.shape, np.int64)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    for ax in range(3):
        ext = cmax[:, ax] - cmin[:, ax]
        scale = np.where(ext > 0, _BINS / np.where(ext > 0, ext, 1.0), 0.0)
        b = np.minimum(((cent[:, ax] - cmin[seg, ax]) * scale[seg]).astype(np.int64), _BINS - 1)
        bins[:, ax] = b
        key = torch.from_numpy(seg * _BINS + b)[:, None].expand(-1, 3)
        blo = torch.full((S * _BINS, 3), np.inf, dtype=torch.float64)
        bhi = torch.full((S * _BINS, 3), -np.inf, dtype=torch.float64)
        blo = blo.scatter_reduce_(0, key, lo_t, "amin").numpy().reshape(S, _BINS, 3)
        bhi = bhi.scatter_reduce_(0, key, hi_t, "amax").numpy().reshape(S, _BINS, 3)
        count = np.bincount(seg * _BINS + b, minlength=S * _BINS).reshape(S, _BINS)
        n_left = np.cumsum(count, axis=1)[:, :-1]
        n_right = lens[:, None] - n_left
        left = _half_area(np.minimum.accumulate(blo, axis=1)[:, :-1],
                          np.maximum.accumulate(bhi, axis=1)[:, :-1])
        right = _half_area(np.minimum.accumulate(blo[:, ::-1], axis=1)[:, ::-1][:, 1:],
                           np.maximum.accumulate(bhi[:, ::-1], axis=1)[:, ::-1][:, 1:])
        cost = np.where((n_left > 0) & (n_right > 0), left * n_left + right * n_right, np.inf)
        i = np.argmin(cost, axis=1)
        c = cost[np.arange(S), i]
        better = c < best  # strict: the lowest axis wins a tie
        best[better], best_axis[better], best_bin[better] = c[better], ax, i[better]
    rows = np.arange(seg.size)
    side = bins[rows, best_axis[seg]] > best_bin[seg]
    # every centroid of the segment in one place: split it at its middle
    middle = rows - off[seg] >= (lens // 2)[seg]
    return np.where(np.isfinite(best)[seg], side, middle)


def tri_bvh(v0, e1, e2) -> TriBVH:
    """The flat kernels' bounding volume hierarchy of a soup (``v0``,
    ``e1``, ``e2`` [N, 3] float32 tensors), built on the host with numpy and
    returned on their device.

    Binned surface-area heuristic (16 bins on each axis, level by level):
    splits a node until it holds at most :data:`LEAF` triangles. Each
    triangle is referenced once. A triangle's box is that of its float64
    vertices ``v0``, ``v0 + e1``, ``v0 + e2`` rounded outward to float32; a
    child's box is the union of its triangles' boxes, so a parent's box is
    the exact union of its children's. Deterministic: the same soup gives the
    same bytes. Raises if the soup is empty or the tree is deeper than
    :data:`STACK`. Compute once per render and pass as ``bvh``."""
    device = v0.device
    v0n, e1n, e2n = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (v0, e1, e2))
    if any(a.dtype != np.float32 for a in (v0n, e1n, e2n)):
        raise TypeError("tri_bvh: v0, e1 and e2 must be float32")
    N = v0n.shape[0]
    if N < 1:
        raise ValueError("tri_bvh: needs at least one triangle")
    if N >= 2**28:
        raise ValueError("tri_bvh: more than 2^28 - 1 triangles")
    a = v0n.astype(np.float64)
    verts = np.stack([a, a + e1n, a + e2n])
    tri_lo, tri_hi = _round_down(verts.min(axis=0)), _round_up(verts.max(axis=0))
    lo64, hi64 = tri_lo.astype(np.float64), tri_hi.astype(np.float64)
    cent = 0.5 * (lo64 + hi64)

    perm = np.arange(N)
    levels = []  # per level: (inner node ids [S], child starts [S, 2], child ends [S, 2], codes)
    ids = np.array([0])
    starts, ends = np.array([0]), np.array([N])
    n_nodes = 1
    if N <= LEAF:  # a root with one leaf and one empty one
        cs, ce = np.array([[0, N]]), np.array([[N, N]])
        levels.append((ids, cs, ce, ~((cs << 3) | (ce - cs))))
        starts = starts[:0]
    while starts.size:
        lens = ends - starts
        seg = np.repeat(np.arange(starts.size), lens)
        pos = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens) + starts[seg]
        el = perm[pos]
        right = _sah_split(cent[el], lo64[el], hi64[el], seg, lens)
        perm[pos] = el[np.argsort(seg * 2 + right, kind="stable")]
        n_left = lens - np.bincount(seg, weights=right, minlength=starts.size).astype(np.int64)
        cs = np.stack([starts, starts + n_left], axis=1)
        ce = np.stack([starts + n_left, ends], axis=1)
        inner = ce - cs > LEAF
        child = np.zeros(cs.shape, np.int64)
        child[inner] = n_nodes + np.arange(int(inner.sum()))
        n_nodes += int(inner.sum())
        levels.append((ids, cs, ce, np.where(inner, child, ~((cs << 3) | (ce - cs)))))
        ids, starts, ends = child[inner], cs[inner], ce[inner]
    depth = len(levels)
    if depth > STACK:
        raise ValueError(f"tri_bvh: the tree is {depth} deep, the kernels' stack holds {STACK}")

    # children's boxes: unions of their triangles' boxes over their ranges
    # (the ranges of one level are disjoint; a sentinel row closes the last)
    lo_p = np.concatenate([tri_lo[perm], tri_lo[:1]])
    hi_p = np.concatenate([tri_hi[perm], tri_hi[:1]])
    nodes = np.zeros((n_nodes, 16), np.float32)
    for ids, cs, ce, codes in levels:
        order = np.argsort(cs.ravel(), kind="stable")
        bounds = np.stack([cs.ravel()[order], ce.ravel()[order]], axis=1).ravel()
        box_lo = np.empty((cs.size, 3), np.float32)
        box_hi = np.empty((cs.size, 3), np.float32)
        filled = ce.ravel()[order] > cs.ravel()[order]
        box_lo[order] = np.where(filled[:, None], np.minimum.reduceat(lo_p, bounds)[::2], 0.0)
        box_hi[order] = np.where(filled[:, None], np.maximum.reduceat(hi_p, bounds)[::2], 0.0)
        box_lo, box_hi = box_lo.reshape(-1, 2, 3), box_hi.reshape(-1, 2, 3)
        if not filled.all():  # the empty leaf takes its sibling's box
            box_lo[:, 1], box_hi[:, 1] = box_lo[:, 0], box_hi[:, 0]
        for c in range(2):
            nodes[ids, 4 * c] = box_lo[:, c, 0]
            nodes[ids, 4 * c + 1] = box_hi[:, c, 0]
            nodes[ids, 4 * c + 2] = box_lo[:, c, 1]
            nodes[ids, 4 * c + 3] = box_hi[:, c, 1]
            nodes[ids, 8 + 2 * c] = box_lo[:, c, 2]
            nodes[ids, 9 + 2 * c] = box_hi[:, c, 2]
        nodes[ids, 12:14] = codes.astype(np.int32).view(np.float32)

    tris = np.zeros((N, 12), np.float32)
    tris[:, 0:3], tris[:, 4:7], tris[:, 8:11] = v0n[perm], e1n[perm], e2n[perm]
    tris[:, 3] = perm.astype(np.int32).view(np.float32)
    return TriBVH(torch.from_numpy(nodes).to(device), torch.from_numpy(tris).to(device), depth)


def bvh_leaves(bvh: TriBVH):
    """The leaves of a hierarchy, in the order of the child slots that hold
    them: ``(first [L], count [L], lo [L, 3], hi [L, 3])`` numpy arrays,
    ``count`` rows of ``bvh.tris`` from ``first``, and the leaf's box."""
    n = bvh.nodes.cpu().numpy()
    lo = np.stack([n[:, [0, 4]], n[:, [2, 6]], n[:, [8, 10]]], axis=-1).reshape(-1, 3)
    hi = np.stack([n[:, [1, 5]], n[:, [3, 7]], n[:, [9, 11]]], axis=-1).reshape(-1, 3)
    code = np.ascontiguousarray(n[:, 12:14]).view(np.int32).ravel()
    leaf = code < 0
    code = ~code[leaf]
    return code >> 3, code & 7, lo[leaf], hi[leaf]


def _box_reach(p, d, cap, lo, hi):
    """The kernels' slab test in float32: can the segment ``p + t d``, t in
    [-slack, cap + slack], reach the box grown by ``delta``? ``p``, ``d``
    [B, 3], ``cap`` [B], ``lo``, ``hi`` [L, 3]; returns bool [B, L].

    ``dist`` bounds the L1 distance from ``p`` to any point of the box;
    ``delta = BOX_SLACK (dist + |p|_1)`` and ``slack = CAP_SLACK dist +
    1e-6`` are the margins of the exact test's rounding. The near and far
    planes follow the sign of ``1 / d``; a zero component gives +-inf, and
    an origin on a grown face of such an axis gives ``0 * inf = NaN``, which
    ``fmax``/``fmin`` drop: the axis then bounds nothing (NaN counts as
    reached). Monotone under box containment, so a box that is reached has
    every ancestor reached."""
    f32 = torch.float32
    grow = torch.tensor(BOX_SLACK, dtype=f32)
    cap_slack = torch.tensor(CAP_SLACK, dtype=f32)
    tiny = torch.tensor(1e-6, dtype=f32)
    inv = 1.0 / d
    a = lo[None] - p[:, None]  # [B, L, 3]
    b = hi[None] - p[:, None]
    far_side = torch.fmax(-a, b)
    dist = (far_side[..., 0] + far_side[..., 1]) + far_side[..., 2]
    ap = torch.abs(p)
    l1 = ((ap[:, 0] + ap[:, 1]) + ap[:, 2])[:, None]
    delta = grow * (dist + l1)
    slack = cap_slack * dist + tiny
    a = a - delta[..., None]
    b = b + delta[..., None]
    neg = (inv < 0)[:, None, :]
    near = torch.where(neg, b, a) * inv[:, None, :]
    far = torch.where(neg, a, b) * inv[:, None, :]
    t_near = torch.fmax(torch.fmax(torch.fmax(near[..., 0], near[..., 1]), near[..., 2]), -slack)
    t_far = torch.fmin(torch.fmin(torch.fmin(far[..., 0], far[..., 1]), far[..., 2]),
                       cap[:, None] + slack)
    return t_near <= t_far


def bvh_leaves_reached_plain(p, d, cap, bvh: TriBVH):
    """Which leaves of :func:`bvh_leaves` the kernels' cull reaches for rays
    ``p``, ``d`` [B, 3] with caps ``cap`` [B] (float32): bool [B, L]. The
    plain twin of the flat kernels' box test (same margins, same NaN rule),
    applied to each leaf's own box."""
    _, _, lo, hi = bvh_leaves(bvh)
    return _box_reach(p, d, cap, *(torch.from_numpy(x).to(p.device) for x in (lo, hi)))


# ---------------------------------------------------------------------------
# plain versions


def _cross(a, b):
    """Cross product over the last axis, each component
    ``fma(a_i, b_j, -(a_j b_i))`` as XLA:CPU contracts it."""
    def comp(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def tri_normals(e1, e2):
    """Unit geometric normals [N, 3] of triangles with edges ``e1``, ``e2``
    [N, 3]: ``cross(e1, e2) / max(norm, 1e-12)``, rounded as the jitted
    reference's chunk rounds it."""
    n = _cross(e1, e2)
    norm = torch.sqrt(dot3(n, n).double()).float()
    return n / torch.clamp(norm, min=1e-12)[:, None]


def _chunk_hits(p, d, v0, e1, e2, t_max):
    """Moller-Trumbore distances [B, Nc] of rays against a triangle chunk,
    +inf where missed (reference ``mesh._chunk_hits`` as XLA:CPU rounds
    it)."""
    pvec = _cross(d[:, None, :], e2[None, :, :])  # [B, Nc, 3]
    det = dot3(e1[None, :, :], pvec)
    live = torch.abs(det) > _DET_MIN
    inv_det = torch.where(live, 1.0 / det, 0.0)
    tvec = p[:, None, :] - v0[None, :, :]
    u = (
        (tvec[..., 0] * pvec[..., 0] + tvec[..., 1] * pvec[..., 1])
        + tvec[..., 2] * pvec[..., 2]
    ) * inv_det
    qvec = _cross(tvec, e1[None, :, :])
    v = dot3(d[:, None, :], qvec) * inv_det
    t = dot3(e2[None, :, :], qvec) * inv_det
    ok = (
        live & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > _EPS_T) & (t < t_max[:, None])
    )
    return torch.where(ok, t, torch.inf)


def _chunks(v0, e1, e2, chunk):
    for start in range(0, v0.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield v0[sl], e1[sl], e2[sl]


def ray_tris_nearest_plain(p, d, t_max, v0, e1, e2, spheres=None, chunk: int = CHUNK):
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
        # they are rare, so only those lanes pay for the masked sum
        n_sel = n_tri[first] + 0.0
        m = (t == tmin[:, None]) & torch.isfinite(tmin)[:, None]
        cnt = m.sum(dim=1)
        tied = torch.nonzero(cnt > 1)[:, 0]
        if tied.numel():
            s = ((m[tied, :, None] * n_tri.double()[None]).sum(dim=1) + 0.0).float()
            n_sel[tied] = s / cnt[tied, None].to(t.dtype)
        better = tmin < best_t
        best_n = torch.where(better[:, None], n_sel, best_n)
        best_t = torch.where(better, tmin, best_t)
    hit = torch.isfinite(best_t)
    return torch.where(hit, best_t, t_max), best_n, hit


def ray_tris_occluded_plain(p, d, t_max, v0, e1, e2, spheres=None, chunk: int = CHUNK):
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
    its normal (float64 sum) when ``t`` and chunk are equal. Equals the dense
    sweep bit for bit whatever the order."""
    B = p.shape[0]
    row_leaf = np.empty(bvh.tris.shape[0], np.int64)
    for leaf, (first, count) in enumerate(zip(*bvh_leaves(bvh)[:2])):
        row_leaf[first : first + count] = leaf
    reached = bvh_leaves_reached_plain(p, d, t_max, bvh)
    tris = bvh.tris
    index = tris[:, 3].contiguous().view(torch.int32).long()
    best_t = t_max.clone()
    best_chunk = torch.full((B,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                            device=p.device)
    total = torch.zeros((B, 3), dtype=torch.float64, device=p.device)
    cnt = torch.zeros(B, dtype=torch.int64, device=p.device)
    for k in range(tris.shape[0]) if order is None else order:
        v0, e1, e2 = tris[k : k + 1, 0:3], tris[k : k + 1, 4:7], tris[k : k + 1, 8:11]
        t = _chunk_hits(p, d, v0, e1, e2, t_max)[:, 0]
        found = torch.isfinite(t) & reached[:, int(row_leaf[k])]
        chunk = index[k] // CHUNK
        tie = found & (t == best_t)
        replace = found & ((t < best_t) | (tie & (chunk < best_chunk)))
        add = tie & (chunk == best_chunk)
        n = tri_normals(e1, e2)[0].double()
        total = torch.where(replace[:, None], 0.0 + n, torch.where(add[:, None], total + n, total))
        cnt = torch.where(replace, 1, cnt + add.long())
        best_t = torch.where(replace, t, best_t)
        best_chunk = torch.where(replace, chunk, best_chunk)
    hit = cnt > 0
    normal = total.float() / torch.clamp(cnt, min=1)[:, None].float()
    normal = torch.where(hit[:, None], normal, torch.tensor([0.0, 0.0, 1.0], device=p.device))
    return torch.where(hit, best_t, t_max), normal, hit


def ray_tris_nearest_instanced_plain(p, d, t_max, v0, e1, e2, offsets, spheres=None):
    """Nearest hit against the translated copies: scan the instances,
    translate the ray into each instance frame, sweep the canonical soup
    with the running best as the cap, keep the winner."""
    B = p.shape[0]
    best_t = t_max
    best_n = torch.zeros((B, 3), dtype=p.dtype, device=p.device)
    best_n[:, 2] = 1.0
    hit = torch.zeros(B, dtype=torch.bool, device=p.device)
    for offset in offsets:
        t, n, h = ray_tris_nearest_plain(p - offset[None, :], d, best_t, v0, e1, e2)
        better = h & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_n = torch.where(better[:, None], n, best_n)
        hit = hit | better
    return torch.where(hit, best_t, t_max), best_n, hit


def ray_tris_occluded_instanced_plain(p, d, t_max, v0, e1, e2, offsets, spheres=None):
    """Any hit against the translated copies."""
    occ = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for offset in offsets:
        occ = occ | ray_tris_occluded_plain(p - offset[None, :], d, t_max, v0, e1, e2)
    return occ


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(name, named, B, N, offsets, depth=None):
    """Validate the operands of a launch: ``named`` holds the rays, the
    soup, and the cull operand: ``spheres`` (instanced kernels) or a
    :class:`TriBVH`'s ``nodes`` and ``tris`` with its ``depth`` (flat)."""
    p = named["p"]
    for key, t in named.items():
        if t.device != p.device:
            raise ValueError(f"{name}: {key} is on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    shapes = {"p": (B, 3), "d": (B, 3), "t_max": (B,), "v0": (N, 3), "e1": (N, 3),
              "e2": (N, 3)}
    if "spheres" in named:
        shapes["spheres"] = (1 + -(-N // GROUP), 4)
    if "nodes" in named:
        shapes["nodes"] = (max(named["nodes"].shape[0], 1), 16)
        shapes["tris"] = (N, 12)
    if offsets is not None:
        shapes["offsets"] = (offsets.shape[0], 3)
    for key, shape in shapes.items():
        if tuple(named[key].shape) != shape:
            raise ValueError(
                f"{name}: {key} must be {list(shape)}, got {list(named[key].shape)}"
            )
    if N < 1:
        raise ValueError(f"{name}: needs at least one triangle")
    if offsets is not None and offsets.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one instance")
    if B >= 2**31 or N >= 2**28:
        raise ValueError(f"{name}: more than 2^31 - 1 lanes or 2^28 - 1 triangles")
    if depth is not None and not 1 <= depth <= STACK:
        raise ValueError(f"{name}: a hierarchy {depth} deep, the kernels' stack holds {STACK}")


def _launch(name, nearest, named, ins, sizes):
    """Allocate the outputs and launch kernel ``name`` on the current stream
    with the tensors ``ins`` and the integers ``sizes``; raises if the
    launch fails. ``named`` has been checked."""
    p = named["p"]
    B = p.shape[0]
    if nearest:
        outs = (
            torch.empty(B, dtype=torch.float32, device=p.device),
            torch.empty((B, 3), dtype=torch.float32, device=p.device),
            torch.empty(B, dtype=torch.bool, device=p.device),
        )
    else:
        outs = (torch.empty(B, dtype=torch.bool, device=p.device),)
    if B == 0:
        return outs
    with torch.cuda.device(p.device):
        rc = _launcher(name, len(ins) + len(outs), len(sizes))(
            *[t.data_ptr() for t in ins + outs], *sizes,
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return outs


def _launch_flat(name, nearest, p, d, t_max, v0, e1, e2, bvh):
    """The flat kernels: check the rays, the soup and its hierarchy (built
    here when ``bvh`` is None), launch the traversal."""
    if bvh is None:
        bvh = tri_bvh(v0, e1, e2)
    if not isinstance(bvh, TriBVH):
        raise TypeError(f"{name}: bvh must be a TriBVH (tri_bvh), got {type(bvh).__name__}")
    named = {"p": p, "d": d, "t_max": t_max, "v0": v0, "e1": e1, "e2": e2,
             "nodes": bvh.nodes, "tris": bvh.tris}
    _check(name, named, p.shape[0], v0.shape[0], None, depth=bvh.depth)
    if bvh.nodes.data_ptr() % 16 or bvh.tris.data_ptr() % 16:
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    return _launch(name, nearest, named, (p, d, t_max, bvh.nodes, bvh.tris), (p.shape[0],))


def _launch_instanced(name, nearest, p, d, t_max, v0, e1, e2, offsets, spheres):
    """The instanced kernels: check the operands (spheres built here when
    None), launch the sphere-culled sweep."""
    if spheres is None:
        spheres = tri_sweep_spheres(v0, e1, e2)
    named = {"p": p, "d": d, "t_max": t_max, "v0": v0, "e1": e1, "e2": e2,
             "spheres": spheres, "offsets": offsets}
    B, N = p.shape[0], v0.shape[0]
    _check(name, named, B, N, offsets)
    return _launch(name, nearest, named, tuple(named.values()), (B, N, offsets.shape[0]))


def ray_tris_nearest(p, d, t_max, v0, e1, e2, bvh=None):
    """Nearest triangle hit of rays ``p`` [B, 3], ``d`` [B, 3] (unit) within
    ``t_max`` [B] against triangles ``v0``, ``e1``, ``e2`` [N, 3], all
    float32. Returns ``(t_hit [B], normal [B, 3], hit [B] bool)``.
    ``bvh`` optionally passes :func:`tri_bvh` of the soup. CUDA tensors go
    through the kernel (the wrapper checks device, dtype, contiguity, shapes
    and the hierarchy's depth, and raises if the launch fails); CPU tensors
    through :func:`ray_tris_nearest_plain`."""
    if _on_cpu(p, "ray_tris_nearest"):
        return ray_tris_nearest_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_nearest", True, p, d, t_max, v0, e1, e2, bvh)


def ray_tris_occluded(p, d, t_max, v0, e1, e2, bvh=None):
    """True [B] where any triangle blocks the segment; operands as
    :func:`ray_tris_nearest`."""
    if _on_cpu(p, "ray_tris_occluded"):
        return ray_tris_occluded_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_occluded", False, p, d, t_max, v0, e1, e2, bvh)[0]


def ray_tris_nearest_instanced(p, d, t_max, v0, e1, e2, offsets, spheres=None):
    """:func:`ray_tris_nearest` against the union of the canonical soup
    translated by each of ``offsets`` [I, 3]; ``spheres`` optionally passes
    :func:`tri_sweep_spheres` of the canonical soup."""
    if _on_cpu(p, "ray_tris_nearest_instanced"):
        return ray_tris_nearest_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_nearest_instanced", True, p, d, t_max, v0, e1, e2,
                             offsets, spheres)


def ray_tris_occluded_instanced(p, d, t_max, v0, e1, e2, offsets, spheres=None):
    """:func:`ray_tris_occluded` against the translated copies."""
    if _on_cpu(p, "ray_tris_occluded_instanced"):
        return ray_tris_occluded_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_occluded_instanced", False, p, d, t_max, v0, e1, e2,
                             offsets, spheres)[0]
