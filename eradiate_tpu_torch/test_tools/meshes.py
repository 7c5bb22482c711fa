"""Procedural wood meshes for the tests, the smoke script and the sweeps.

:func:`wood_skeleton` builds the triangle mesh of one tree's wood, a trunk
with straight branches, from a seeded generator; :func:`write_obj` writes it
as a Wavefront OBJ file that ``scenes.shapes.load_obj`` reads back exactly;
:func:`edge_rays` aims rays at the shared edges and vertices of a mesh, where
the last bit of the intersection test decides.
"""

from __future__ import annotations

import numpy as np

from ..ops.mesh import cylinder_mesh

__all__ = ["wood_skeleton", "write_obj", "edge_rays"]


def _along(vertices, direction):
    """Rotate vertices built along +z so that +z maps onto ``direction``."""
    w = np.asarray(direction, dtype=np.float64)
    w = w / np.linalg.norm(w)
    a = np.array([1.0, 0.0, 0.0]) if abs(w[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    return vertices @ np.stack([u, v, w])


def wood_skeleton(rng, n_branches=256, trunk_radius=0.25, crown_height=10.0,
                  branch_radius=0.03, branch_length=4.5):
    """One tree's wood as ``(vertices [V, 3], faces [N, 3])``, lengths in
    metres: a capped 12-segment trunk from z = 0 to the crown's centre at
    ``crown_height`` (36 triangles) and ``n_branches`` capped 8-segment
    cylinders (24 triangles each) from the crown's centre along directions
    drawn uniformly on the sphere from ``rng``."""
    verts, faces = cylinder_mesh(trunk_radius, crown_height)
    parts_v, parts_f, count = [verts], [faces], verts.shape[0]
    centre = np.array([0.0, 0.0, crown_height])
    directions = rng.normal(size=(n_branches, 3))
    for w in directions:
        v, f = cylinder_mesh(branch_radius, branch_length, n_seg=8)
        parts_v.append(_along(v, w) + centre)
        parts_f.append(f + count)
        count += v.shape[0]
    return np.concatenate(parts_v), np.concatenate(parts_f)


def write_obj(path, vertices, faces):
    """Write a triangle mesh as a Wavefront OBJ file (``v`` and 1-based ``f``
    records); coordinates are printed with 17 significant digits, so float64
    values read back unchanged."""
    with open(path, "w") as fh:
        for v in np.asarray(vertices, dtype=np.float64):
            fh.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for f in np.asarray(faces, dtype=np.int64) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def edge_rays(rng, B, tris, offsets=None, distance=1e-5):
    """``B`` rays aimed at a mesh (``tris.v0``, ``.e1``, ``.e2`` as numpy
    arrays, km): a quarter each at points of an edge, at vertices, at
    interior points and just beside an edge (1e-6 of the triangle off it),
    of triangles drawn at random, in one of the instance frames ``offsets``
    [I, 3] if given. Origins lie ``distance`` x (50..300) back along a
    random direction; the caps are twice, exactly, just above and just below
    the distance to the target. Returns float32 ``(p, d, t_max)``."""
    v0, e1, e2 = (np.asarray(x, dtype=np.float64) for x in (tris.v0, tris.e1, tris.e2))
    k = rng.integers(0, v0.shape[0], B)
    kind = rng.integers(0, 4, B)
    a, b = rng.uniform(0, 1, B), rng.uniform(0, 1, B)
    b = np.where(kind == 0, 0.0, b)
    a = np.where(kind == 1, np.round(a), a)
    b = np.where(kind == 1, 0.0, b)
    b = np.where(kind == 3, rng.choice([1e-6, -1e-6], B), b)
    s = np.maximum(a + b, 1.0)
    target = v0[k] + (a / s)[:, None] * e1[k] + (b / s)[:, None] * e2[k]
    if offsets is not None:
        target = target + np.asarray(offsets)[rng.integers(0, len(offsets), B)]
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    dist = rng.uniform(50.0, 300.0, B) * distance
    p = (target + back * dist[:, None]).astype(np.float32)
    d = target - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = dist * rng.choice([2.0, 1.0, 1 + 1e-6, 1 - 1e-6], B)
    return p, d.astype(np.float32), t_max.astype(np.float32)
