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
  lower key; it adds its normal when ``t`` and key are equal. The key is
  the chunk, original index // 512 (:func:`ray_tris_nearest_bvh_plain`),
  and for the instanced kernels ``instance * ceil(N / 512) + index // 512``
  with the instance's row in ``offsets``
  (:func:`ray_tris_nearest_instanced_bvh_plain`);
* misses keep ``t = t_max`` and the normal ``(0, 0, 1)``.
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
from .leaf_intersect import _check_operands, _launch, _on_cpu, dot3, fma

__all__ = [
    "CHUNK",
    "LEAF",
    "STACK",
    "TOP_STACK",
    "InstancedTriBVH",
    "TriBVH",
    "launches",
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

#: Kernel launches made in this process, by kernel name.
launches = {
    "ray_tris_nearest": 0,
    "ray_tris_occluded": 0,
    "ray_tris_nearest_instanced": 0,
    "ray_tris_occluded_instanced": 0,
}


# ---------------------------------------------------------------------------
# the kernels' bounding volume hierarchies


@dataclasses.dataclass(frozen=True)
class TriBVH:
    """The flat kernels' acceleration structure, made by :func:`tri_bvh`.

    ``nodes`` [M, 16] float32: the inner nodes of :mod:`~.bvh` (a leaf
    holds ``count`` rows of ``tris`` from ``first``). Row 0 is the root.

    ``tris`` [N, 12] float32: the triangles in leaf order, three float4 each:
    ``v0`` with the original index's int32 bits in the fourth float, ``e1``
    and ``e2`` with a zero; bitwise copies of the inputs.

    ``depth``: inner nodes on the longest path from the root to a leaf; the
    kernels' stack holds :data:`STACK`."""

    nodes: torch.Tensor
    tris: torch.Tensor
    depth: int


def tri_bvh(v0, e1, e2) -> TriBVH:
    """The flat kernels' bounding volume hierarchy of a soup (``v0``,
    ``e1``, ``e2`` [N, 3] float32 tensors), built on the host with numpy and
    returned on their device (:func:`~.bvh.build`: binned SAH, leaves of at
    most :data:`LEAF` triangles, each referenced once). A triangle's box is
    that of its float64 vertices ``v0``, ``v0 + e1``, ``v0 + e2`` rounded
    outward to float32. Deterministic: the same soup gives the same bytes.
    Raises if the soup is empty or the tree is deeper than :data:`STACK`.
    Compute once per render and pass as ``bvh``."""
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
    nodes, perm, depth = build(
        _round_down(verts.min(axis=0)), _round_up(verts.max(axis=0)), "tri_bvh"
    )
    tris = np.zeros((N, 12), np.float32)
    tris[:, 0:3], tris[:, 4:7], tris[:, 8:11] = v0n[perm], e1n[perm], e2n[perm]
    tris[:, 3] = perm.astype(np.int32).view(np.float32)
    return TriBVH(torch.from_numpy(nodes).to(device), torch.from_numpy(tris).to(device), depth)


@dataclasses.dataclass(frozen=True)
class InstancedTriBVH:
    """The instanced kernels' acceleration structure, made by
    :func:`tri_instanced_bvh`: two levels.

    ``canonical``: the canonical soup's :class:`TriBVH`, in its own frame.

    ``top`` [M, 16] float32: the inner nodes of :mod:`~.bvh` over the
    instances (a leaf holds ``count`` rows of ``instances`` from ``first``),
    each instance's box the canonical root box moved by its offset
    (:func:`~.bvh.instance_level`). Row 0 is the root.

    ``instances`` [I, 4] float32: the offsets in the top level's leaf order,
    ``(ox, oy, oz, original row as int32 bits)``; bitwise copies of the
    inputs. The row, not the position, is the instance in the tie key.

    ``top_depth``: inner nodes on the longest path from the top's root to a
    leaf; the kernels' outer stack holds :data:`TOP_STACK`."""

    canonical: TriBVH
    top: torch.Tensor
    instances: torch.Tensor
    top_depth: int


def tri_instanced_bvh(v0, e1, e2, offsets) -> InstancedTriBVH:
    """The instanced kernels' hierarchy of the canonical soup (``v0``,
    ``e1``, ``e2`` [N, 3]) at ``offsets`` [I, 3], all float32 tensors:
    :func:`tri_bvh` of the soup below, the instances' boxes
    (:func:`~.bvh.instance_level`) above, built on the host with numpy and
    returned on the tensors' device. Deterministic: the same inputs give the
    same bytes. Raises as :func:`tri_bvh` does, and if there is no instance,
    the offsets are not float32, or the top level is deeper than
    :data:`TOP_STACK`. Compute once per render and pass as ``bvh``."""
    o = np.ascontiguousarray(offsets.detach().cpu().numpy())
    if o.dtype != np.float32:
        raise TypeError("tri_instanced_bvh: offsets must be float32")
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
    its normal (float64 sum) when ``t`` and chunk are equal. Equals the dense
    sweep bit for bit whatever the order."""
    tris = bvh.tris

    def test(k):
        v0, e1, e2 = tris[k : k + 1, 0:3], tris[k : k + 1, 4:7], tris[k : k + 1, 8:11]
        return _chunk_hits(p, d, v0, e1, e2, t_max)[:, 0], tri_normals(e1, e2)[0]

    return nearest_plain(p, d, t_max, bvh, tris, test, order, CHUNK)


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
    ``instances`` with its ``top_depth``."""
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
    _check_operands(name, named, shapes, depth)
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
    return _launch(name, nearest, p, (p, d, t_max, bvh.nodes, bvh.tris), (p.shape[0],),
                   launches)


def _launch_instanced(name, nearest, p, d, t_max, v0, e1, e2, offsets, bvh):
    """The instanced kernels: check the rays, the soup, the offsets and
    their two-level hierarchy (built here when ``bvh`` is None), launch the
    traversal."""
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
    sizes = (B, N) if nearest else (B,)  # the nearest hit's tie key needs N
    return _launch(name, nearest, p, (p, d, t_max, *arrays), sizes, launches)


def _on_cpu_f32(p, name):
    """:func:`~.leaf_intersect._on_cpu`, refusing float64 rays first: the
    triangle sweeps have no float64 build (a float64 soup is never cut to
    float32)."""
    if p.dtype == torch.float64:
        raise TypeError(f"{name}: float64 rays and triangles: the triangle sweeps have no "
                        "float64 build yet")
    return _on_cpu(p, name)


def ray_tris_nearest(p, d, t_max, v0, e1, e2, bvh=None):
    """Nearest triangle hit of rays ``p`` [B, 3], ``d`` [B, 3] (unit) within
    ``t_max`` [B] against triangles ``v0``, ``e1``, ``e2`` [N, 3], all
    float32 (float64 raises). Returns ``(t_hit [B], normal [B, 3], hit [B]
    bool)``. ``bvh`` optionally passes :func:`tri_bvh` of the soup. CUDA tensors go
    through the kernel (the wrapper checks device, dtype, contiguity, shapes
    and the hierarchy's depth, and raises if the launch fails); CPU tensors
    through :func:`ray_tris_nearest_plain`."""
    if _on_cpu_f32(p, "ray_tris_nearest"):
        return ray_tris_nearest_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_nearest", True, p, d, t_max, v0, e1, e2, bvh)


def ray_tris_occluded(p, d, t_max, v0, e1, e2, bvh=None):
    """True [B] where any triangle blocks the segment; operands as
    :func:`ray_tris_nearest`."""
    if _on_cpu_f32(p, "ray_tris_occluded"):
        return ray_tris_occluded_plain(p, d, t_max, v0, e1, e2)
    return _launch_flat("ray_tris_occluded", False, p, d, t_max, v0, e1, e2, bvh)[0]


def ray_tris_nearest_instanced(p, d, t_max, v0, e1, e2, offsets, bvh=None):
    """:func:`ray_tris_nearest` against the union of the canonical soup
    translated by each of ``offsets`` [I, 3]; ``bvh`` optionally passes
    :func:`tri_instanced_bvh` of the soup and the offsets."""
    if _on_cpu_f32(p, "ray_tris_nearest_instanced"):
        return ray_tris_nearest_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_nearest_instanced", True, p, d, t_max, v0, e1, e2,
                             offsets, bvh)


def ray_tris_occluded_instanced(p, d, t_max, v0, e1, e2, offsets, bvh=None):
    """:func:`ray_tris_occluded` against the translated copies."""
    if _on_cpu_f32(p, "ray_tris_occluded_instanced"):
        return ray_tris_occluded_instanced_plain(p, d, t_max, v0, e1, e2, offsets)
    return _launch_instanced("ray_tris_occluded_instanced", False, p, d, t_max, v0, e1, e2,
                             offsets, bvh)[0]
