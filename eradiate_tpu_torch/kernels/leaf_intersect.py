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

For CUDA tensors they launch ``csrc/leaf_intersect.cu``; for CPU tensors
they run the plain versions (``*_plain``), the chunked dense sweeps of the
reference's ``ops/canopy.py`` (``ray_leaves_nearest``, ``ray_leaves_occluded``,
``_instanced_nearest_xla`` and the instance scan of ``leaf_occluded``). They
never fall back from one to the other.

Semantics shared by kernel and plain version (the reference's XLA form):

* a disk is hit where ``1e-7 < t < t_max``, ``|q - c|^2 <= r^2`` and
  ``|d.n| > 1e-12``, with ``t = (c.n - p.n) / d.n`` and ``q = p + d t``;
  ``d.n`` and ``p.n`` are the product-then-two-FMA chains XLA:CPU makes of
  a 3-term contraction, ``c.n`` is a plain sum, ``q`` and ``|q - c|^2``
  are FMAs: ``fmaf`` in the kernels, :func:`fma` (the same single
  rounding, emulated in float64) in the plain versions, so they agree bit
  for bit;
* an instance translates the ray, ``p - offset``, not the leaves;
* exact ties of ``t`` inside one 512-leaf chunk of one instance average
  their normals; across chunks and instances the first wins. The winners'
  normals are summed into a zero, as the reference sums them, so a
  component -0.0 comes out +0.0. Tied normals are summed in float64,
  rounded once, so the result does not depend on the order of the sum; a
  kernel that visits the disks out of index order (the hierarchy's
  traversal) applies the rule as: a hit replaces the best when its ``t`` is
  smaller, or equal with a lower key; it adds its normal when ``t`` and key
  are equal. The key is the chunk, original index // 512
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

__all__ = [
    "CHUNK",
    "LEAF",
    "STACK",
    "TOP_STACK",
    "InstancedLeafBVH",
    "LeafBVH",
    "launches",
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

#: Kernel launches made in this process, by kernel name.
launches = {
    "ray_leaves_nearest": 0,
    "ray_leaves_occluded": 0,
    "ray_leaves_nearest_instanced": 0,
    "ray_leaves_occluded_instanced": 0,
}

_launchers = {}


# ---------------------------------------------------------------------------
# the kernels' bounding volume hierarchies


@dataclasses.dataclass(frozen=True)
class LeafBVH:
    """The flat kernels' acceleration structure, made by :func:`leaf_bvh`.

    ``nodes`` [M, 16] float32: the inner nodes of :mod:`~.bvh` (a leaf
    holds ``count`` rows of ``disks`` from ``first``). Row 0 is the root.

    ``disks`` [N, 12] float32: the disks in leaf order, three float4 each:
    ``(cx, cy, cz, original index as int32 bits)``, ``(nx, ny, nz, r)`` and
    ``(r * r, (cx nx + cy ny) + cz nz, 0, 0)``, the last two rounded as the
    exact test rounds them (plain float32 products and sums); bitwise copies
    of the inputs.

    ``depth``: inner nodes on the longest path from the root to a leaf; the
    kernels' stack holds :data:`STACK`."""

    nodes: torch.Tensor
    disks: torch.Tensor
    depth: int


def leaf_bvh(centers, normals, radii) -> LeafBVH:
    """The flat kernels' bounding volume hierarchy of a leaf table
    (``centers``, ``normals`` [N, 3], ``radii`` [N] float32 tensors), built
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
    is empty, not float32, or the tree is deeper than :data:`STACK`.
    Compute once per render and pass as ``bvh``."""
    device = centers.device
    c, n, r = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (centers, normals, radii))
    if any(a.dtype != np.float32 for a in (c, n, r)):
        raise TypeError("leaf_bvh: centers, normals and radii must be float32")
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
    disks = np.zeros((N, 12), np.float32)
    disks[:, 0:3], disks[:, 4:7], disks[:, 7] = cp, npm, rp
    disks[:, 3] = perm.astype(np.int32).view(np.float32)
    disks[:, 8] = rp * rp
    disks[:, 9] = (cp[:, 0] * npm[:, 0] + cp[:, 1] * npm[:, 1]) + cp[:, 2] * npm[:, 2]
    return LeafBVH(torch.from_numpy(nodes).to(device), torch.from_numpy(disks).to(device), depth)


@dataclasses.dataclass(frozen=True)
class InstancedLeafBVH:
    """The instanced kernels' acceleration structure, made by
    :func:`leaf_instanced_bvh`: two levels.

    ``canonical``: the canonical cloud's :class:`LeafBVH`, in its own frame.

    ``top`` [M, 16] float32: the inner nodes of :mod:`~.bvh` over the
    instances (a leaf holds ``count`` rows of ``instances`` from ``first``),
    each instance's box the canonical root box moved by its offset
    (:func:`~.bvh.instance_level`). Row 0 is the root.

    ``instances`` [I, 4] float32: the offsets in the top level's leaf order,
    ``(ox, oy, oz, original row as int32 bits)``; bitwise copies of the
    inputs. The row, not the position, is the instance in the tie key.

    ``top_depth``: inner nodes on the longest path from the top's root to a
    leaf; the kernels' outer stack holds :data:`TOP_STACK`."""

    canonical: LeafBVH
    top: torch.Tensor
    instances: torch.Tensor
    top_depth: int


def leaf_instanced_bvh(centers, normals, radii, offsets) -> InstancedLeafBVH:
    """The instanced kernels' hierarchy of the canonical cloud (``centers``,
    ``normals`` [N, 3], ``radii`` [N]) at ``offsets`` [I, 3], all float32
    tensors: :func:`leaf_bvh` of the cloud below, the instances' boxes
    (:func:`~.bvh.instance_level`) above, built on the host with numpy and
    returned on the tensors' device. Deterministic: the same inputs give the
    same bytes. Raises as :func:`leaf_bvh` does, and if there is no
    instance, the offsets are not float32, or the top level is deeper than
    :data:`TOP_STACK`. Compute once per render and pass as ``bvh``."""
    o = np.ascontiguousarray(offsets.detach().cpu().numpy())
    if o.dtype != np.float32:
        raise TypeError("leaf_instanced_bvh: offsets must be float32")
    if o.ndim != 2 or o.shape[1] != 3 or o.shape[0] < 1:
        raise ValueError(f"leaf_instanced_bvh: offsets must be [I >= 1, 3], got {list(o.shape)}")
    canonical = leaf_bvh(centers, normals, radii)
    top, instances, depth = instance_level(canonical.nodes.cpu().numpy(), o, "leaf_instanced_bvh")
    device = centers.device
    return InstancedLeafBVH(canonical, torch.from_numpy(top).to(device),
                            torch.from_numpy(instances).to(device), depth)


# ---------------------------------------------------------------------------
# plain versions


def fma(a, b, c):
    """``a * b + c`` of float32 tensors rounded once, exactly as a hardware
    fused multiply-add rounds it (``fmaf`` on the card, XLA:CPU's contracted
    products and sums in the reference).

    The product is exact in float64. The sum is rounded to float64 and then
    to float32; to keep the second rounding from seeing a tie the first one
    made, the float64 sum is rounded to odd (its last bit is set whenever the
    sum was inexact, found with the error-free TwoSum), which makes the final
    rounding the correct single one (53 >= 2 * 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)  # one ulp toward the exact sum
    odd = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return odd.view(torch.float64).float()


def dot3(a, b):
    """Dot product over the last axis of [..., 3] vectors (``b`` broadcasts)
    as XLA:CPU evaluates a 3-term contraction: the first product, then two
    fused multiply-adds."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _chunk_hits(p, d, centers, normals, radii, t_max):
    """Intersection distances [B, Nc] of rays against a leaf chunk, +inf
    where missed (reference ``canopy._chunk_hits`` as XLA:CPU rounds it)."""
    dn = dot3(d[:, None, :], normals[None, :, :])
    cn = (centers[:, 0] * normals[:, 0] + centers[:, 1] * normals[:, 1]) + (
        centers[:, 2] * normals[:, 2]
    )
    pn = dot3(p[:, None, :], normals[None, :, :])
    live = torch.abs(dn) > 1e-12
    t = (cn[None, :] - pn) / torch.where(live, dn, 1e-12)
    x = [fma(d[:, j : j + 1], t, p[:, j : j + 1]) - centers[None, :, j] for j in range(3)]
    dist2 = fma(x[2], x[2], fma(x[1], x[1], x[0] * x[0]))
    ok = (t > _EPS_T) & (t < t_max[:, None]) & (dist2 <= (radii * radii)[None, :]) & live
    return torch.where(ok, t, torch.inf)


def _chunks(centers, normals, radii, chunk):
    for start in range(0, centers.shape[0], chunk):
        sl = slice(start, start + chunk)
        yield centers[sl], normals[sl], radii[sl]


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
        # component -0.0 into +0.0; exact ties average their normals (summed
        # in float64 and rounded once, so the order of the sum does not
        # matter), and they are rare, so only those lanes pay for the sum
        n_sel = n[first] + 0.0
        m = (t == tmin[:, None]) & torch.isfinite(tmin)[:, None]
        cnt = m.sum(dim=1)
        tied = torch.nonzero(cnt > 1)[:, 0]
        if tied.numel():
            s = ((m[tied, :, None] * n.double()[None]).sum(dim=1) + 0.0).float()
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


def _check_operands(name, named, shapes, depth=None):
    """Validate the tensors ``named`` of a launch: on ``p``'s device,
    float32, contiguous and of the ``shapes`` given by name; a hierarchy's
    ``depth`` within the kernels' stack."""
    p = named["p"]
    for key, t in named.items():
        if t.device != p.device:
            raise ValueError(f"{name}: {key} is on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
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
    ``instances`` with its ``top_depth``."""
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
    _check_operands(name, named, shapes, depth)
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
    operands have been checked; ``p`` gives the lanes and the device."""
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
    counts[name] += 1
    return outs


def _launch_flat(name, nearest, p, d, t_max, centers, normals, radii, bvh):
    """The flat kernels: check the rays, the table and its hierarchy (built
    here when ``bvh`` is None), launch the traversal."""
    if bvh is None:
        bvh = leaf_bvh(centers, normals, radii)
    if not isinstance(bvh, LeafBVH):
        raise TypeError(f"{name}: bvh must be a LeafBVH (leaf_bvh), got {type(bvh).__name__}")
    named = {"p": p, "d": d, "t_max": t_max, "centers": centers, "normals": normals,
             "radii": radii, "nodes": bvh.nodes, "disks": bvh.disks}
    _check(name, named, p.shape[0], centers.shape[0], None, depth=bvh.depth)
    if bvh.nodes.data_ptr() % 16 or bvh.disks.data_ptr() % 16:
        raise ValueError(f"{name}: the hierarchy's arrays must be 16-byte aligned (float4)")
    return _launch(name, nearest, p, (p, d, t_max, bvh.nodes, bvh.disks), (p.shape[0],),
                   launches)


def _launch_instanced(name, nearest, p, d, t_max, centers, normals, radii, offsets, bvh):
    """The instanced kernels: check the rays, the table, the offsets and
    their two-level hierarchy (built here when ``bvh`` is None), launch the
    traversal."""
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
    sizes = (B, N) if nearest else (B,)  # the nearest hit's tie key needs N
    return _launch(name, nearest, p, (p, d, t_max, *arrays), sizes, launches)


def _on_cpu(p, name):
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {p.device}")
    return p.device.type == "cpu"


def ray_leaves_nearest(p, d, t_max, centers, normals, radii, bvh=None):
    """Nearest leaf-disk hit of rays ``p`` [B, 3], ``d`` [B, 3] (unit)
    within ``t_max`` [B] against disks ``centers`` [N, 3], ``normals``
    [N, 3], ``radii`` [N], all float32. Returns ``(t_hit [B], normal [B, 3],
    hit [B] bool)``. ``bvh`` optionally passes :func:`leaf_bvh` of the
    table. CUDA tensors go through the kernel (the wrapper checks device,
    dtype, contiguity, shapes and the hierarchy's depth, and raises if the
    launch fails); CPU tensors through :func:`ray_leaves_nearest_plain`."""
    if _on_cpu(p, "ray_leaves_nearest"):
        return ray_leaves_nearest_plain(p, d, t_max, centers, normals, radii)
    return _launch_flat("ray_leaves_nearest", True, p, d, t_max, centers, normals, radii, bvh)


def ray_leaves_occluded(p, d, t_max, centers, normals, radii, bvh=None):
    """True [B] where any leaf disk blocks the segment; operands as
    :func:`ray_leaves_nearest`."""
    if _on_cpu(p, "ray_leaves_occluded"):
        return ray_leaves_occluded_plain(p, d, t_max, centers, normals, radii)
    return _launch_flat("ray_leaves_occluded", False, p, d, t_max, centers, normals, radii,
                        bvh)[0]


def ray_leaves_nearest_instanced(p, d, t_max, centers, normals, radii, offsets, bvh=None):
    """:func:`ray_leaves_nearest` against the union of the canonical cloud
    translated by each of ``offsets`` [I, 3]; ``bvh`` optionally passes
    :func:`leaf_instanced_bvh` of the cloud and the offsets."""
    if _on_cpu(p, "ray_leaves_nearest_instanced"):
        return ray_leaves_nearest_instanced_plain(p, d, t_max, centers, normals, radii, offsets)
    return _launch_instanced("ray_leaves_nearest_instanced", True, p, d, t_max, centers,
                             normals, radii, offsets, bvh)


def ray_leaves_occluded_instanced(p, d, t_max, centers, normals, radii, offsets, bvh=None):
    """:func:`ray_leaves_occluded` against the translated copies."""
    if _on_cpu(p, "ray_leaves_occluded_instanced"):
        return ray_leaves_occluded_instanced_plain(p, d, t_max, centers, normals, radii, offsets)
    return _launch_instanced("ray_leaves_occluded_instanced", False, p, d, t_max, centers,
                             normals, radii, offsets, bvh)[0]
