"""Ray / leaf-disk sweeps: the CUDA kernels' wrappers and their plain versions.

Four functions, each the counterpart of a TPU kernel of
``eradiate_tpu/ops/pallas/leaf_intersect.py``:

* :func:`ray_leaves_nearest` / :func:`ray_leaves_occluded`: nearest hit and
  any hit of rays against a flat table of leaf disks; the kernels traverse a
  bounding volume hierarchy of the table (:func:`leaf_bvh`);
* :func:`ray_leaves_nearest_instanced` / :func:`ray_leaves_occluded_instanced`:
  the same against ``I`` translated copies of one canonical cloud, which is
  stored once; the kernels traverse a hierarchy of two levels, the
  instances' boxes above the canonical cloud's own hierarchy
  (:func:`leaf_instanced_bvh`).

For CUDA tensors they launch ``csrc/leaf_intersect.cu``: float32 tensors
its float32 kernels, float64 tensors (the double modes) their float64
builds (``*_f64``, counted in :data:`launches_f64`); mixed or other dtypes
raise. For CPU tensors they run the plain versions (``*_plain``), the
chunked sweeps of the reference's ``ops/canopy.py`` (``ray_leaves_nearest``,
``ray_leaves_occluded``, ``_instanced_nearest_xla`` and the instance scan
of ``leaf_occluded``), in either dtype, as the reference computes them
jitted (under x64 for float64). They never fall back from one to the
other.

Semantics shared by kernel and plain version (the reference's XLA form):

* a disk is hit where ``1e-7 < t < t_max``, ``|q - c|^2 <= r^2`` and
  ``|d.n| > 1e-12``, with ``t = (c.n - p.n) / d.n`` and ``q = p + d t``;
  ``d.n`` and ``p.n`` are the product-then-two-FMA chains XLA:CPU makes of
  a 3-term contraction, ``c.n`` is a plain sum, ``q`` and ``|q - c|^2``
  are FMAs: ``fmaf``/``__fma_rn`` in the kernels, :func:`fma` (the same
  single rounding, emulated) in the plain versions, so they agree bit for
  bit; XLA:CPU contracts the float64 graph under x64 the same way;
* an instance translates the ray, ``p - offset``, not the leaves;
* exact ties of ``t`` inside one 512-leaf chunk of one instance average
  their normals; across chunks and instances the first wins. The winners'
  normals are summed into a zero, as the reference sums them, so a
  component -0.0 comes out +0.0. Tied float32 normals are summed in
  float64, exactly, so the result does not depend on the order of the sum;
  tied float64 normals are summed from zero in index order, the
  reference's order (two sum alike in either order; the float64 kernels
  sum three or more again in index order after their walk). A kernel that
  visits the disks out of index order (the hierarchy's traversal) applies
  the rule as: a hit replaces the best when its ``t`` is smaller, or equal
  with a lower key; it adds its normal when ``t`` and key are equal. The key is the chunk, original index // 512
  (:func:`ray_leaves_nearest_bvh_plain`), and for the instanced kernels
  ``instance * ceil(N / 512) + index // 512`` with the instance's row in
  ``offsets`` (:func:`ray_leaves_nearest_instanced_bvh_plain`);
* misses keep ``t = t_max`` and the normal ``(0, 0, 1)``.
"""

from __future__ import annotations

import ctypes
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

__all__ = [
    "CHUNK",
    "LEAF",
    "STACK",
    "TOP_STACK",
    "InstancedLeafBVH",
    "LeafBVH",
    "launches",
    "launches_f64",
    "leaf_bvh",
    "leaf_instanced_bvh",
    "bvh_leaves",
    "bvh_leaves_reached_plain",
    "ray_leaves_nearest",
    "ray_leaves_occluded",
    "ray_leaves_nearest_instanced",
    "ray_leaves_occluded_instanced",
    "ray_leaves_nearest_plain",
    "ray_leaves_occluded_plain",
    "ray_leaves_nearest_bvh_plain",
    "ray_leaves_nearest_instanced_bvh_plain",
    "ray_leaves_nearest_instanced_plain",
    "ray_leaves_occluded_instanced_plain",
]

#: Leaves per chunk of the plain sweep, which is also the tie-averaging unit
#: (reference ``ray_leaves_nearest(chunk=512)``).
CHUNK = 512

_EPS_T = 1e-7

#: Kernel launches made in this process, by kernel name: ``launches`` the
#: float32 kernels', ``launches_f64`` their float64 builds'.
launches = {
    "ray_leaves_nearest": 0,
    "ray_leaves_occluded": 0,
    "ray_leaves_nearest_instanced": 0,
    "ray_leaves_occluded_instanced": 0,
}
launches_f64 = {f"{k}_f64": 0 for k in launches}

_launchers = {}


# ---------------------------------------------------------------------------
# the kernels' bounding volume hierarchies


@dataclasses.dataclass(frozen=True)
class LeafBVH:
    """The flat kernels' acceleration structure, made by :func:`leaf_bvh`.

    ``nodes`` [M, 16] float32: the inner nodes of :mod:`~.bvh` (a leaf
    holds ``count`` rows of ``disks`` from ``first``). Row 0 is the root.

    ``disks`` [N, 12] in the table's dtype, float32 or float64: the disks
    in leaf order, three float4 (double4) each: ``(cx, cy, cz, original
    index as int32 (int64) bits)``, ``(nx, ny, nz, r)`` and ``(r * r, (cx nx
    + cy ny) + cz nz, 0, 0)``, the last two rounded as the exact test rounds
    them (plain products and sums); bitwise copies of the inputs. The nodes
    stay float32 for either: the boxes are rounded outward from the
    float64 coordinates, and the float64 kernels test them with their ray
    rounded to float32 (:func:`~.bvh.box_ray`).

    ``depth``: inner nodes on the longest path from the root to a leaf; the
    kernels' stack holds :data:`STACK`."""

    nodes: torch.Tensor
    disks: torch.Tensor
    depth: int


def leaf_bvh(centers, normals, radii) -> LeafBVH:
    """The flat kernels' bounding volume hierarchy of a leaf table
    (``centers``, ``normals`` [N, 3], ``radii`` [N] tensors of one dtype,
    float32 or float64), built
    on the host with numpy and returned on their device
    (:func:`~.bvh.build`: binned SAH, leaves of at most :data:`LEAF` disks,
    each referenced once).

    A disk's box is its own: ``c +- r sqrt(1 - n_i^2)`` on axis ``i`` (the
    unit normal's components in float64), rounded outward to float32. The
    exact test accepts a point ``q = p + d t`` within ``r`` of ``c`` that
    lies off the disk's plane by the rounding of ``c.n - p.n``, a few ulp of
    the coordinates; the kernels' box margin (``BOX_SLACK`` of the
    coordinates' magnitude) covers that, and ``q`` lies on the ray's line at
    the computed ``t`` up to the rounding of the fused multiply-add, so the
    line crosses the grown box at ``t`` however the division rounds.
    Deterministic: the same table gives the same bytes. Raises if the table
    is empty, not of one dtype float32 or float64, or the tree is deeper
    than :data:`STACK`. Compute once per render and pass as ``bvh``."""
    device = centers.device
    c, n, r = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (centers, normals, radii))
    if c.dtype not in (np.float32, np.float64) or n.dtype != c.dtype or r.dtype != c.dtype:
        raise TypeError("leaf_bvh: centers, normals and radii must be all float32 or all "
                        f"float64, got {c.dtype}, {n.dtype}, {r.dtype}")
    N = c.shape[0]
    if N < 1:
        raise ValueError("leaf_bvh: needs at least one leaf")
    if N >= 2**28:
        raise ValueError("leaf_bvh: more than 2^28 - 1 leaves")
    c64, n64, r64 = c.astype(np.float64), n.astype(np.float64), r.astype(np.float64)
    norm = np.linalg.norm(n64, axis=1, keepdims=True)
    unit = n64 / np.where(norm > 0, norm, 1.0)
    # a zero normal never passes |d.n| > 1e-12: any box will do, take the cube
    half = r64[:, None] * np.where(norm > 0, np.sqrt(np.clip(1.0 - unit**2, 0.0, 1.0)), 1.0)
    nodes, perm, depth = build(_round_down(c64 - half), _round_up(c64 + half), "leaf_bvh")
    cp, npm, rp = c[perm], n[perm], r[perm]
    disks = np.zeros((N, 12), c.dtype)
    disks[:, 0:3], disks[:, 4:7], disks[:, 7] = cp, npm, rp
    disks[:, 3] = perm.astype(np.int32 if c.dtype == np.float32 else np.int64).view(c.dtype)
    disks[:, 8] = rp * rp
    disks[:, 9] = (cp[:, 0] * npm[:, 0] + cp[:, 1] * npm[:, 1]) + cp[:, 2] * npm[:, 2]
    return LeafBVH(torch.from_numpy(nodes).to(device), torch.from_numpy(disks).to(device), depth)


@dataclasses.dataclass(frozen=True)
class InstancedLeafBVH:
    """The instanced kernels' acceleration structure, made by
    :func:`leaf_instanced_bvh`: two levels.

    ``canonical``: the canonical cloud's :class:`LeafBVH`, in its own frame.

    ``top`` [M, 16] float32 (for either table dtype): the inner nodes of
    :mod:`~.bvh` over the
    instances (a leaf holds ``count`` rows of ``instances`` from ``first``),
    each instance's box the canonical root box moved by its offset
    (:func:`~.bvh.instance_level`). Row 0 is the root.

    ``instances`` [I, 4] in the table's dtype: the offsets in the top
    level's leaf order, ``(ox, oy, oz, original row as int32 (int64)
    bits)``; bitwise copies of the inputs. The row, not the position, is the
    instance in the tie key.

    ``top_depth``: inner nodes on the longest path from the top's root to a
    leaf; the kernels' outer stack holds :data:`TOP_STACK`."""

    canonical: LeafBVH
    top: torch.Tensor
    instances: torch.Tensor
    top_depth: int


def leaf_instanced_bvh(centers, normals, radii, offsets) -> InstancedLeafBVH:
    """The instanced kernels' hierarchy of the canonical cloud (``centers``,
    ``normals`` [N, 3], ``radii`` [N]) at ``offsets`` [I, 3], tensors of one
    dtype, float32 or float64: :func:`leaf_bvh` of the cloud below, the instances' boxes
    (:func:`~.bvh.instance_level`) above, built on the host with numpy and
    returned on the tensors' device. Deterministic: the same inputs give the
    same bytes. Raises as :func:`leaf_bvh` does, and if there is no
    instance, the offsets are not of the table's dtype, or the top level is
    deeper than
    :data:`TOP_STACK`. Compute once per render and pass as ``bvh``."""
    o = np.ascontiguousarray(offsets.detach().cpu().numpy())
    if o.dtype != centers.cpu().numpy().dtype:
        raise TypeError(f"leaf_instanced_bvh: offsets are {o.dtype}, centers "
                        f"{centers.dtype}: one dtype for all")
    if o.ndim != 2 or o.shape[1] != 3 or o.shape[0] < 1:
        raise ValueError(f"leaf_instanced_bvh: offsets must be [I >= 1, 3], got {list(o.shape)}")
    canonical = leaf_bvh(centers, normals, radii)
    top, instances, depth = instance_level(canonical.nodes.cpu().numpy(), o, "leaf_instanced_bvh")
    device = centers.device
    return InstancedLeafBVH(canonical, torch.from_numpy(top).to(device),
                            torch.from_numpy(instances).to(device), depth)


# ---------------------------------------------------------------------------
# plain versions


def _two_sum(a, b):
    """``(s, e)``: ``s = fl(a + b)`` and its exact error, ``a + b = s + e``
    (Knuth's TwoSum, six float64 operations, no branch)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s, err):
    """``s`` rounded to odd toward the exact ``s + err``: its last bit set
    whenever ``err`` is not zero (one ulp toward ``err`` where it was
    even). Rounding the result once more to fewer bits is the correct
    single rounding of ``s + err`` (Boldo and Melquiond)."""
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits).view(torch.float64)


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a float64 into two 26-bit halves


def _two_prod(a, b):
    """``(p, e)``: ``p = fl(a b)`` and its exact error (Dekker's TwoProduct
    on Veltkamp's split). Exact where ``|a|, |b| < 2^995`` and the error
    does not underflow, ``|a b| > 2^-969``."""

    def split(x):
        g = _SPLIT * x
        hi = g - (g - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64_normal(a, b, c):
    """The correctly rounded ``a b + c`` of float64 tensors where
    :func:`_two_prod` is exact and the product is not zero: Boldo and
    Melquiond's emulated FMA, the
    exact product's high part summed with ``c``, both low parts rounded to
    odd, and the final sum rounded to nearest."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    v, ve = _two_sum(tl, pl)
    return th + _round_odd(v, ve)


def _pow2(e):
    """``2^e`` for an int64 tensor ``e`` in [-1022, 1023], exactly."""
    return ((e + 1023) << 52).view(torch.float64)


def _fma64(a, b, c):
    """``a b + c`` of float64 tensors rounded once, as a hardware float64
    fused multiply-add rounds it (``__fma_rn`` on the card, XLA:CPU's
    contracted products and sums under x64), for every finite result that
    is zero or normal, and for infinite and NaN operands.

    Most lanes take :func:`_fma64_normal` as they are; an exact zero product
    or an infinite or NaN ``a`` or ``b`` takes IEEE's ``a * b + c``, which
    is then the FMA's. Lanes whose operands leave the range of
    :func:`_fma64_normal` (a product beyond 2^1000 or below 2^-900 in
    magnitude, ``|c|`` beyond 2^1000) are scaled: ``a`` and ``b`` to
    [0.5, 1) by their exponents (exact), ``c`` by the product's exponent,
    or replaced by a number of its sign far below the product's last bit
    where it is that small (it then only breaks a tie, as the exact ``c``
    would), or returned as it is where the product lies more than 2^-110 of
    it below ``c``'s (the product then cannot move ``c``); the result is
    scaled back, which overflows to +-inf exactly where the rounded result
    does."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    prod = a * b
    big = 2.0**995
    zero = (a == 0) | (b == 0)  # an exact product: IEEE's sum of it and c is the FMA's
    ordinary = ((torch.abs(a) < big) & (torch.abs(b) < big) & (torch.abs(c) < 2.0**1000)
                & (torch.abs(prod) > 2.0**-900) & (torch.abs(prod) < 2.0**1000))
    # the other lanes' results (inf or NaN there) are replaced below
    out = torch.where(ordinary, _fma64_normal(a, b, c), prod + c)
    rest = ~ordinary & ~zero & torch.isfinite(a) & torch.isfinite(b)
    if not bool(rest.any()):
        return out
    idx = torch.nonzero(rest)[:, 0]
    a1, b1, c1 = a.reshape(-1)[idx], b.reshape(-1)[idx], c.reshape(-1)[idx]
    ma, ea = torch.frexp(a1)
    mb, eb = torch.frexp(b1)
    E = ea.long() + eb.long()
    # c / 2^E in two exact steps where it stays normal
    _, ec = torch.frexp(c1)
    rel = ec.long() - E  # c's exponent over the product's
    h = torch.clamp(-E // 2, -1022, 1023)
    cs = c1 * _pow2(h) * _pow2(torch.clamp(-E - h, -1022, 1023))
    cs = torch.where(rel < -900, torch.copysign(torch.full_like(c1, 2.0**-1000), c1), cs)
    cs = torch.where(c1 == 0, c1, cs)
    r = _fma64_normal(ma, mb, cs)
    h = torch.clamp(E // 2, -1022, 1023)
    r = r * _pow2(h) * _pow2(torch.clamp(E - h, -1022, 1023))
    r = torch.where(((rel > 110) & (c1 != 0)) | ~torch.isfinite(c1), c1, r)
    flat = out.reshape(-1).clone()
    flat[idx] = r
    return flat.view(out.shape)


def fma(a, b, c):
    """``a * b + c`` rounded once, exactly as a hardware fused multiply-add
    rounds it (``fmaf``/``__fma_rn`` on the card, XLA:CPU's contracted
    products and sums in the reference), of three float32 or three float64
    tensors; the result has their dtype. Mixed dtypes raise: a float64
    operand never becomes float32.

    float32: the product is exact in float64. The sum is rounded to float64
    and then to float32; to keep the second rounding from seeing a tie the
    first one made, the float64 sum is rounded to odd (its last bit is set
    whenever the sum was inexact, found with the error-free TwoSum), which
    makes the final rounding the correct single one (53 >= 2 * 24 + 2
    bits).

    float64: Dekker's exact product on Veltkamp's split, then the sum of
    three float64 rounded once by rounding to odd (:func:`_fma64`)."""
    dtypes = {a.dtype, b.dtype, c.dtype}
    if dtypes == {torch.float64}:
        return _fma64(a, b, c)
    if dtypes != {torch.float32}:
        raise TypeError(f"fma: operands must all be float32 or all float64, got "
                        f"{a.dtype}, {b.dtype}, {c.dtype}")
    p = a.double() * b.double()
    s, err = _two_sum(p, c.double())
    return _round_odd(s, err).float()


def dot3(a, b):
    """Dot product over the last axis of [..., 3] vectors (``b`` broadcasts)
    as XLA:CPU evaluates a 3-term contraction: the first product, then two
    fused multiply-adds."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _exact_hits(p, d, centers, normals, radii, t_max):
    """The exact test of rays ``p``, ``d`` [..., 3] with caps ``t_max``
    [...] against disks broadcast with them: ``t`` where hit, else +inf
    (reference ``canopy._chunk_hits`` as XLA:CPU rounds it)."""
    dn = dot3(d, normals)
    cn = (centers[..., 0] * normals[..., 0] + centers[..., 1] * normals[..., 1]) + (
        centers[..., 2] * normals[..., 2]
    )
    pn = dot3(p, normals)
    live = torch.abs(dn) > 1e-12
    t = (cn - pn) / torch.where(live, dn, 1e-12)
    x = [fma(d[..., j], t, p[..., j]) - centers[..., j] for j in range(3)]
    dist2 = fma(x[2], x[2], fma(x[1], x[1], x[0] * x[0]))
    ok = (t > _EPS_T) & (t < t_max) & (dist2 <= radii * radii) & live
    return torch.where(ok, t, torch.inf)


#: The plain sweeps' line cull: its margin, of the coordinates' magnitude
#: (the kernels' ``kLineSlack``).
_LINE_SLACK = 2e-6


def _chunk_hits(p, d, centers, normals, radii, t_max):
    """Intersection distances [B, Nc] of rays against a leaf chunk, +inf
    where missed (reference ``canopy._chunk_hits`` as XLA:CPU rounds it).

    As the kernels do, it first asks, in float64, whether a ray's line
    passes within a disk's radius of its centre, with a margin of 2e-6 of
    the coordinates (``line_near``: ~30 float32 ulp, ~1e10 float64 ulp),
    and runs the exact test, whose emulated fused multiply-adds cost ~10
    (float32) or ~45 (float64) operations each, only on the pairs that
    pass. A disk the exact test accepts lies within that distance of the
    line, so the result is the dense test's."""
    p64, d64 = p.double(), d.double()
    v = centers.double()[None] - p64[:, None]  # [B, Nc, 3]
    tc = (v * d64[:, None]).sum(-1)
    e = v - d64[:, None] * tc[..., None]
    r = radii.double()[None]
    reach = r + _LINE_SLACK * (v.abs().sum(-1) + p64.abs().sum(-1)[:, None] + r)
    b, k = torch.nonzero((e * e).sum(-1) <= reach * reach, as_tuple=True)
    t = torch.full(tc.shape, torch.inf, dtype=p.dtype, device=p.device)
    t[b, k] = _exact_hits(p[b], d[b], centers[k], normals[k], radii[k], t_max[b])
    return t


def _chunks(centers, normals, radii, chunk):
    for start in range(0, centers.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield centers[sl], normals[sl], radii[sl]


def _sum_in_index_order(mask, n):
    """Each row of ``mask`` [T, Nc]'s selected normals of ``n`` [Nc, 3]
    summed from +0.0 one at a time in index order, as the reference's
    masked reduction sums them: [T, 3]."""
    total = torch.zeros((mask.shape[0], 3), dtype=n.dtype, device=n.device)
    rank = mask.cumsum(dim=1)
    for j in range(1, int(rank[:, -1].max()) + 1):
        # one selected normal a row, plus zeros: that normal exactly
        total = total + torch.where((mask & (rank == j))[:, :, None], n[None], 0.0).sum(dim=1)
    return total


def ray_leaves_nearest_plain(p, d, t_max, centers, normals, radii, spheres=None,
                             chunk: int = CHUNK):
    """Nearest leaf hit along ``p + t d`` for t in (0, t_max): the chunked
    dense sweep. Returns ``(t_hit [B], normal [B, 3], hit [B])``."""
    B = p.shape[0]
    best_t = torch.full((B,), torch.inf, dtype=p.dtype, device=p.device)
    best_n = torch.zeros((B, 3), dtype=p.dtype, device=p.device)
    best_n[:, 2] = 1.0
    for c, n, r in _chunks(centers, normals, radii, chunk):
        t = _chunk_hits(p, d, c, n, r, t_max)
        tmin, first = t.min(dim=1)
        # the reference sums the winners' normals into a zero, which turns a
        # component -0.0 into +0.0; exact ties average their normals, and
        # they are rare, so only those lanes pay for the sum: float32
        # normals summed in float64 (exact, so the order does not matter),
        # float64 ones in index order as the reference sums them
        n_sel = n[first] + 0.0
        m = (t == tmin[:, None]) & torch.isfinite(tmin)[:, None]
        cnt = m.sum(dim=1)
        tied = torch.nonzero(cnt > 1)[:, 0]
        if tied.numel():
            if n.dtype == torch.float32:
                s = ((m[tied, :, None] * n.double()[None]).sum(dim=1) + 0.0).float()
            else:
                s = _sum_in_index_order(m[tied], n)
            n_sel[tied] = s / cnt[tied, None].to(t.dtype)
        better = tmin < best_t
        best_n = torch.where(better[:, None], n_sel, best_n)
        best_t = torch.where(better, tmin, best_t)
    hit = torch.isfinite(best_t)
    return torch.where(hit, best_t, t_max), best_n, hit


def ray_leaves_occluded_plain(p, d, t_max, centers, normals, radii, spheres=None,
                              chunk: int = CHUNK):
    """True where any leaf blocks the segment (shadow rays)."""
    occ = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for c, n, r in _chunks(centers, normals, radii, chunk):
        occ = occ | torch.isfinite(_chunk_hits(p, d, c, n, r, t_max)).any(dim=1)
    return occ


def ray_leaves_nearest_bvh_plain(p, d, t_max, bvh: LeafBVH, order=None):
    """:func:`ray_leaves_nearest_plain` as the flat kernel computes it: the
    disks of ``bvh`` visited one at a time in ``order`` (a permutation of
    the rows of ``bvh.disks``; default their leaf order), each ray testing
    only those in leaves its cull reaches with the cap ``t_max``, with the
    order-free tie rule: a hit replaces the best when its ``t`` is smaller,
    or equal with a lower chunk (original index // :data:`CHUNK`); it adds
    its normal (float64 sum, from zero) when ``t`` and chunk are equal.
    Equals the dense sweep bit for bit whatever the order."""
    disks = bvh.disks

    def test(k):
        c, n, r = disks[k : k + 1, 0:3], disks[k : k + 1, 4:7], disks[k : k + 1, 7]
        return _chunk_hits(p, d, c, n, r, t_max)[:, 0], n[0]

    return nearest_plain(p, d, t_max, bvh, disks, test, order, CHUNK)


def ray_leaves_nearest_instanced_bvh_plain(p, d, t_max, ibvh: InstancedLeafBVH, order=None):
    """:func:`ray_leaves_nearest_instanced_plain` as the instanced kernel
    computes it: the (instance, disk) pairs of ``ibvh`` visited one at a
    time in ``order`` (a permutation of ``range(I * N)``, pair ``j * N + k``
    being row ``j`` of ``ibvh.instances`` and row ``k`` of the canonical
    ``disks``; default the leaf order of both levels), each ray testing only
    the pairs whose top leaf it reaches with the world ray and whose
    canonical leaf it reaches with the translated ray ``p - offset``, both
    with the cap ``t_max``; with the order-free tie rule on the key
    ``instance * ceil(N / 512) + index // 512``, the instance being the
    offset's original row. Equals the dense instanced sweep bit for bit
    whatever the order."""
    disks = ibvh.canonical.disks
    c, n, r = disks[:, 0:3], disks[:, 4:7], disks[:, 7]
    return instanced_nearest_plain(p, d, t_max, ibvh, disks,
                                   lambda pj: _chunk_hits(pj, d, c, n, r, t_max), n, order, CHUNK)


def ray_leaves_nearest_instanced_plain(p, d, t_max, centers, normals, radii, offsets,
                                       spheres=None):
    """Nearest hit against the translated copies: the canonical cloud swept
    in each instance's frame, the winner kept in instance order
    (:func:`~.bvh.nearest_over_instances`)."""
    return nearest_over_instances(
        p, d, t_max, offsets,
        lambda pj, dj, tj: ray_leaves_nearest_plain(pj, dj, tj, centers, normals, radii))


def ray_leaves_occluded_instanced_plain(p, d, t_max, centers, normals, radii, offsets,
                                        spheres=None):
    """Any hit against the translated copies."""
    return occluded_over_instances(
        p, d, t_max, offsets,
        lambda pj, dj, tj: ray_leaves_occluded_plain(pj, dj, tj, centers, normals, radii))


# ---------------------------------------------------------------------------
# kernel wrappers (the launch plumbing is shared with tri_intersect)


def _launcher(name, n_ptr, n_int):
    fn = _launchers.get(name)
    if fn is None:
        from ._build import library

        fn = getattr(library(), f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


#: Operands that stay float32 whatever the table's dtype: the hierarchies'
#: nodes (boxes rounded outward).
_BOXES = ("nodes", "top")


def _check_operands(name, named, shapes, depth=None, dtypes=(torch.float32,)):
    """Validate the tensors ``named`` of a launch: on ``p``'s device,
    contiguous and of the ``shapes`` given by name; ``p`` of one of
    ``dtypes`` and every other tensor of ``p``'s dtype (the hierarchies'
    nodes float32); a hierarchy's ``depth`` within the kernels' stack."""
    p = named["p"]
    if p.dtype not in dtypes:
        raise TypeError(f"{name}: p must be {' or '.join(str(t) for t in dtypes)}, got {p.dtype}")
    for key, t in named.items():
        if t.device != p.device:
            raise ValueError(f"{name}: {key} is on {t.device}, p on {p.device}")
        want = torch.float32 if key in _BOXES else p.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, p {p.dtype}: it must be {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, shape in shapes.items():
        if tuple(named[key].shape) != shape:
            raise ValueError(
                f"{name}: {key} must be {list(shape)}, got {list(named[key].shape)}"
            )
    if depth is not None and not 1 <= depth <= STACK:
        raise ValueError(f"{name}: a hierarchy {depth} deep, the kernels' stack holds {STACK}")


def _check(name, named, B, N, offsets, depth=None, top_depth=None):
    """Validate the operands of a launch: ``named`` holds the rays, the
    table (with the ``offsets`` of an instanced one) and the hierarchy: a
    :class:`LeafBVH`'s ``nodes`` and ``disks`` with its ``depth``, and for
    the instanced kernels an :class:`InstancedLeafBVH`'s ``top`` and
    ``instances`` with its ``top_depth``. float32 and float64 tables are
    taken, each in one dtype."""
    shapes = {"p": (B, 3), "d": (B, 3), "t_max": (B,), "centers": (N, 3),
              "normals": (N, 3), "radii": (N,)}
    if "nodes" in named:
        shapes["nodes"] = (max(named["nodes"].shape[0], 1), 16)
        shapes["disks"] = (N, 12)
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
        raise ValueError(f"{name}: needs at least one leaf")
    if offsets is not None and offsets.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one instance")
    if B >= 2**31 or N >= 2**28:
        raise ValueError(f"{name}: more than 2^31 - 1 lanes or 2^28 - 1 leaves")
    if offsets is not None and offsets.shape[0] * -(-N // CHUNK) >= 2**31:
        raise ValueError(f"{name}: instances x 512-leaf chunks must stay below 2^31 (the "
                         "kernels' int32 tie key)")


def _launch(name, nearest, p, ins, sizes, counts):
    """Allocate the outputs and launch kernel ``name`` on the current stream
    with the tensors ``ins`` and the integers ``sizes``; raises if the
    launch fails, and adds one to ``counts[name]`` where it launched. The
    operands have been checked; ``p`` gives the lanes, the device and the
    outputs' dtype."""
    B = p.shape[0]
    if nearest:
        outs = (
            torch.empty(B, dtype=p.dtype, device=p.device),
            torch.empty((B, 3), dtype=p.dtype, device=p.device),
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
    counts[name] += 1
    return outs


def _build(name, p, counts=None, counts_f64=None):
    """The kernel's name and launch counts for ``p``'s dtype: the float32
    kernel (counted in ``counts``, default :data:`launches`), or its float64
    build (``_f64``, counted in ``counts_f64``, default
    :data:`launches_f64`)."""
    if p.dtype == torch.float64:
        return f"{name}_f64", launches_f64 if counts_f64 is None else counts_f64
    return name, launches if counts is None else counts


def _launch_flat(name, nearest, p, d, t_max, centers, normals, radii, bvh):
    """The flat kernels: check the rays, the table and its hierarchy (built
    here when ``bvh`` is None), launch the traversal. The float64 nearest
    hit also reads the table in its original order, where it sums three or
    more tied normals in index order."""
    if bvh is None:
        bvh = leaf_bvh(centers, normals, radii)
    if not isinstance(bvh, LeafBVH):
        raise TypeError(f"{name}: bvh must be a LeafBVH (leaf_bvh), got {type(bvh).__name__}")
    named = {"p": p, "d": d, "t_max": t_max, "centers": centers, "normals": normals,
             "radii": radii, "nodes": bvh.nodes, "disks": bvh.disks}
    B, N = p.shape[0], centers.shape[0]
    _check(name, named, B, N, None, depth=bvh.depth)
    if bvh.nodes.data_ptr() % 16 or bvh.disks.data_ptr() % 16:
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    kernel, counts = _build(name, p)
    ins, sizes = (p, d, t_max, bvh.nodes, bvh.disks), (B,)
    if nearest and p.dtype == torch.float64:
        ins, sizes = ins + (centers, normals, radii), (B, N)
    return _launch(kernel, nearest, p, ins, sizes, counts)


def _launch_instanced(name, nearest, p, d, t_max, centers, normals, radii, offsets, bvh):
    """The instanced kernels: check the rays, the table, the offsets and
    their two-level hierarchy (built here when ``bvh`` is None), launch the
    traversal. The float64 nearest hit also reads the table and the offsets
    in their original order (:func:`_launch_flat`)."""
    if bvh is None:
        bvh = leaf_instanced_bvh(centers, normals, radii, offsets)
    if not isinstance(bvh, InstancedLeafBVH):
        raise TypeError(f"{name}: bvh must be an InstancedLeafBVH (leaf_instanced_bvh), got "
                        f"{type(bvh).__name__}")
    canon = bvh.canonical
    named = {"p": p, "d": d, "t_max": t_max, "centers": centers, "normals": normals,
             "radii": radii, "offsets": offsets, "nodes": canon.nodes, "disks": canon.disks,
             "top": bvh.top, "instances": bvh.instances}
    B, N = p.shape[0], centers.shape[0]
    _check(name, named, B, N, offsets, depth=canon.depth, top_depth=bvh.top_depth)
    arrays = (bvh.top, bvh.instances, canon.nodes, canon.disks)
    if any(t.data_ptr() % 16 for t in arrays):
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    kernel, counts = _build(name, p)
    ins = (p, d, t_max, *arrays)
    sizes = (B, N) if nearest else (B,)  # the nearest hit's tie key needs N
    if nearest and p.dtype == torch.float64:
        ins = ins + (centers, normals, radii, offsets)
    return _launch(kernel, nearest, p, ins, sizes, counts)


def _on_cpu(p, name):
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {p.device}")
    return p.device.type == "cpu"


def ray_leaves_nearest(p, d, t_max, centers, normals, radii, bvh=None):
    """Nearest leaf-disk hit of rays ``p`` [B, 3], ``d`` [B, 3] (unit)
    within ``t_max`` [B] against disks ``centers`` [N, 3], ``normals``
    [N, 3], ``radii`` [N], all float32 or all float64. Returns ``(t_hit
    [B], normal [B, 3], hit [B] bool)`` in their dtype. ``bvh`` optionally
    passes :func:`leaf_bvh` of the table. CUDA tensors go through the
    kernel of their dtype, float32 or its float64 build (the wrapper checks
    device, dtype, contiguity, shapes and the hierarchy's depth, and raises
    on mixed or other dtypes and if the launch fails); CPU tensors through
    :func:`ray_leaves_nearest_plain`."""
    refuse_tangents("ray_leaves_nearest", p=p, d=d, t_max=t_max,
                    centers=centers, normals=normals, radii=radii)
    if _on_cpu(p, "ray_leaves_nearest"):
        return ray_leaves_nearest_plain(p, d, t_max, centers, normals, radii)
    return _launch_flat("ray_leaves_nearest", True, p, d, t_max, centers, normals, radii, bvh)


def ray_leaves_occluded(p, d, t_max, centers, normals, radii, bvh=None):
    """True [B] where any leaf disk blocks the segment; operands as
    :func:`ray_leaves_nearest`."""
    refuse_tangents("ray_leaves_occluded", p=p, d=d, t_max=t_max,
                    centers=centers, normals=normals, radii=radii)
    if _on_cpu(p, "ray_leaves_occluded"):
        return ray_leaves_occluded_plain(p, d, t_max, centers, normals, radii)
    return _launch_flat("ray_leaves_occluded", False, p, d, t_max, centers, normals, radii,
                        bvh)[0]


def ray_leaves_nearest_instanced(p, d, t_max, centers, normals, radii, offsets, bvh=None):
    """:func:`ray_leaves_nearest` against the union of the canonical cloud
    translated by each of ``offsets`` [I, 3]; ``bvh`` optionally passes
    :func:`leaf_instanced_bvh` of the cloud and the offsets."""
    refuse_tangents("ray_leaves_nearest_instanced", p=p, d=d, t_max=t_max,
                    centers=centers, normals=normals, radii=radii, offsets=offsets)
    if _on_cpu(p, "ray_leaves_nearest_instanced"):
        return ray_leaves_nearest_instanced_plain(p, d, t_max, centers, normals, radii, offsets)
    return _launch_instanced("ray_leaves_nearest_instanced", True, p, d, t_max, centers,
                             normals, radii, offsets, bvh)


def ray_leaves_occluded_instanced(p, d, t_max, centers, normals, radii, offsets, bvh=None):
    """:func:`ray_leaves_occluded` against the translated copies."""
    refuse_tangents("ray_leaves_occluded_instanced", p=p, d=d, t_max=t_max,
                    centers=centers, normals=normals, radii=radii, offsets=offsets)
    if _on_cpu(p, "ray_leaves_occluded_instanced"):
        return ray_leaves_occluded_instanced_plain(p, d, t_max, centers, normals, radii, offsets)
    return _launch_instanced("ray_leaves_occluded_instanced", False, p, d, t_max, centers,
                             normals, radii, offsets, bvh)[0]
