"""Triangle-mesh geometry: triangle soups and their ray sweeps.

Port of ``eradiate_tpu/ops/mesh.py`` (tree trunks, mesh trees). Storage is
pre-differenced: ``v0`` [N, 3] plus the edge vectors ``e1 = v1 - v0``,
``e2 = v2 - v0``, lengths in km. A mesh is a flat soup
(:class:`TriangleMeshArrays`) or one canonical soup with per-instance
translations (:class:`InstancedTriArrays`), which the sweeps treat as the
union of the translated copies without materialising them.

:func:`tri_nearest` and :func:`tri_occluded` clip each ray to the mesh's
bounding box (:func:`..canopy._advance_to_aabb`, as the leaf sweeps do) and
hand the clipped segment to the sweeps of
:mod:`eradiate_tpu_torch.kernels.tri_intersect`: CUDA kernels for CUDA
tensors (float32, or their float64 builds for a float64 soup and rays), the
plain sweeps for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.tri_intersect import (
    ray_tris_nearest,
    ray_tris_nearest_instanced,
    ray_tris_occluded,
    ray_tris_occluded_instanced,
    tri_bvh,
    tri_instanced_bvh,
)
from .canopy import _advance_to_aabb

__all__ = [
    "InstancedTriArrays",
    "TriangleMeshArrays",
    "mesh_from_vertices",
    "tri_accel",
    "tri_nearest",
    "tri_occluded",
    "cylinder_mesh",
    "cone_mesh",
]


@dataclasses.dataclass
class TriangleMeshArrays:
    v0: Any  # [N, 3]
    e1: Any  # [N, 3]
    e2: Any  # [N, 3]


@dataclasses.dataclass
class InstancedTriArrays:
    """One canonical triangle soup and per-instance translations; triangle
    storage is the canonical soup alone."""

    canonical: TriangleMeshArrays
    offsets: Any  # [I, 3]


def mesh_from_vertices(vertices, faces) -> TriangleMeshArrays:
    """Pre-differenced arrays from [V, 3] vertices (numpy or tensor; the
    edges are differences in the vertices' dtype) and [N, 3] integer
    faces."""
    faces = np.asarray(faces, dtype=np.int64)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    return TriangleMeshArrays(v0=v0, e1=v1 - v0, e2=v2 - v0)


def tri_accel(tris):
    """Acceleration data for the triangle sweeps: ``(cull, box_lo,
    box_hi)``. ``cull`` is the kernels' cull operand on CUDA, built here on
    the host: the bounding volume hierarchy of a flat soup
    (:func:`~eradiate_tpu_torch.kernels.tri_intersect.tri_bvh`) or the
    two-level one of an instanced set, the instances' boxes above the
    canonical soup's hierarchy
    (:func:`~eradiate_tpu_torch.kernels.tri_intersect.tri_instanced_bvh`);
    None on the CPU, where the dense sweeps use none and nothing is built.
    The box is the vertices' (plus the offsets' for instances), in the
    soup's dtype; a float64 soup (a double mode) gets the float64 hierarchy,
    which the float64 builds of the sweeps traverse. Compute once per
    render, outside the path loop, and pass to every
    :func:`tri_nearest`/:func:`tri_occluded`."""
    instanced = isinstance(tris, InstancedTriArrays)
    base = tris.canonical if instanced else tris
    verts = torch.cat([base.v0, base.v0 + base.e1, base.v0 + base.e2])
    lo = verts.min(dim=0).values
    hi = verts.max(dim=0).values
    if instanced:
        lo = lo + tris.offsets.min(dim=0).values
        hi = hi + tris.offsets.max(dim=0).values
    if base.v0.device.type == "cpu":
        return None, lo, hi
    if instanced:
        return tri_instanced_bvh(base.v0, base.e1, base.e2, tris.offsets), lo, hi
    return tri_bvh(base.v0, base.e1, base.e2), lo, hi


def tri_nearest(p, d, t_max, tris, accel=None):
    """Nearest triangle hit of rays ``p + t d``, t in (0, t_max):
    box-advanced origins, then the sweep (flat or instanced). Returns
    ``(t [B], normal [B, 3], hit [B])``; misses keep ``t = t_max``."""
    cull, lo, hi = accel if accel is not None else tri_accel(tris)
    p_adv, t0, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(tris, InstancedTriArrays):
        c = tris.canonical
        t_loc, n, hit = ray_tris_nearest_instanced(
            p_adv, d, t_cap, c.v0, c.e1, c.e2, tris.offsets, cull
        )
    else:
        t_loc, n, hit = ray_tris_nearest(p_adv, d, t_cap, tris.v0, tris.e1, tris.e2, cull)
    return torch.where(hit, t0 + t_loc, t_max), n, hit


def tri_occluded(p, d, t_max, tris, accel=None):
    """Shadow-ray any-hit with the box advance; returns bool [B]."""
    cull, lo, hi = accel if accel is not None else tri_accel(tris)
    p_adv, _, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(tris, InstancedTriArrays):
        c = tris.canonical
        return ray_tris_occluded_instanced(
            p_adv, d, t_cap, c.v0, c.e1, c.e2, tris.offsets, cull
        )
    return ray_tris_occluded(p_adv, d, t_cap, tris.v0, tris.e1, tris.e2, cull)


# ---------------------------------------------------------------------------
# Procedural meshes (host-side numpy; trunk and branch primitives for trees),
# as in the reference's ``ops/mesh.py``
# ---------------------------------------------------------------------------


def cylinder_mesh(radius, height, center=(0.0, 0.0, 0.0), n_seg=12, cap=True):
    """Closed cylinder (axis +z) as (vertices [V, 3], faces [N, 3])."""
    c = np.asarray(center, dtype=np.float64)
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=-1)
    bot = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1) + c
    top = bot + np.array([0.0, 0.0, height])
    verts = [bot, top]
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append([i, j, n_seg + i])
        faces.append([j, n_seg + j, n_seg + i])
    if cap:
        verts.append((c + np.array([0.0, 0.0, height]))[None, :])
        apex = 2 * n_seg
        for i in range(n_seg):
            j = (i + 1) % n_seg
            faces.append([n_seg + i, n_seg + j, apex])
    return np.concatenate(verts, axis=0), np.asarray(faces, dtype=np.int64)


def cone_mesh(radius, height, center=(0.0, 0.0, 0.0), n_seg=12):
    """Open cone (apex up, axis +z) as (vertices, faces)."""
    c = np.asarray(center, dtype=np.float64)
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    ring = np.stack(
        [np.cos(ang) * radius, np.sin(ang) * radius, np.zeros(n_seg)], axis=-1
    ) + c
    apex = (c + np.array([0.0, 0.0, height]))[None, :]
    verts = np.concatenate([ring, apex], axis=0)
    faces = [[i, (i + 1) % n_seg, n_seg] for i in range(n_seg)]
    return verts, np.asarray(faces, dtype=np.int64)
