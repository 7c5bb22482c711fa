"""Procedural wood meshes for the tests, the smoke script and the sweeps.

:func:`wood_skeleton` builds the triangle mesh of one tree's wood, a trunk
with straight branches, from a seeded generator; :func:`write_obj` writes it
as a Wavefront OBJ file that ``scenes.shapes.load_obj`` reads back exactly;
:func:`edge_rays` aims rays at the shared edges and vertices of a mesh, where
the last bit of the intersection test decides; :func:`axis_rays` does so with
direction components that are exactly zero; :func:`vertex_rays` aims rays
exactly at the vertices where many triangles meet (a capped cylinder's apex
joins twelve); :func:`tie_soup` makes exact ties of the hit distance between
triangles of one chunk and of two, and :func:`instanced_tie_soup` also
between instances; :func:`zero_normal_tris` gives triangles whose normals
have components exactly +-0. The rays and soups come in float32, or in
float64 with ``dtype``.
"""

from __future__ import annotations

import numpy as np

from ..ops.mesh import cylinder_mesh

__all__ = ["wood_skeleton", "write_obj", "edge_rays", "axis_rays", "vertex_rays", "tie_soup",
           "instanced_tie_soup", "zero_normal_tris"]


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


def _targets(rng, B, tris, offsets=None):
    """``B`` float64 points of a mesh: a quarter each on an edge, at a
    vertex, inside, and just beside an edge (1e-6 of the triangle off it),
    of triangles drawn at random, in one of the frames ``offsets``."""
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
    return target


def _caps(rng, dist):
    """Caps twice, exactly, just above and just below the distance."""
    return dist * rng.choice([2.0, 1.0, 1 + 1e-6, 1 - 1e-6], dist.shape[0])


def edge_rays(rng, B, tris, offsets=None, distance=1e-5, origins=None, dtype=np.float32):
    """``B`` rays aimed at a mesh (``tris.v0``, ``.e1``, ``.e2`` as numpy
    arrays, km): a quarter each at points of an edge, at vertices, at
    interior points and just beside an edge (1e-6 of the triangle off it),
    of triangles drawn at random, in one of the instance frames ``offsets``
    [I, 3] if given. Origins lie ``distance`` x (50..300) back along a
    random direction, or at ``origins`` [B, 3] if given; the caps are twice,
    exactly, just above and just below the distance to the target. Returns
    ``(p, d, t_max)`` in ``dtype``."""
    target = _targets(rng, B, tris, offsets)
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    dist = rng.uniform(50.0, 300.0, B) * distance
    if origins is not None:
        dist = np.linalg.norm(origins - target, axis=1)
        back = (origins - target) / dist[:, None]
    p = (target + back * dist[:, None]).astype(dtype)
    d = target - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d.astype(dtype), _caps(rng, dist).astype(dtype)


def axis_rays(rng, B, tris, distance=1e-5, offsets=None, dtype=np.float32):
    """``B`` rays aimed at a mesh as :func:`edge_rays` aims them, with
    direction components that are exactly +0 or -0 (the sun and the views of
    an hplane at azimuth 0 have d_y = 0): two thirds travel in the x-z
    plane, a third along an axis (two zero components). Each zero component
    of the origin is the (world) target's own coordinate, so a ray through a
    vertex lies in the planes of its triangles' box faces. In one of the
    instance frames ``offsets`` [I, 3] if given. Returns ``(p, d, t_max)`` in
    ``dtype``."""
    target = _targets(rng, B, tris, offsets)
    angle = rng.uniform(0.0, 2.0 * np.pi, B)
    d = np.stack([np.cos(angle), np.zeros(B), np.sin(angle)], axis=1)
    along = np.eye(3)[rng.integers(0, 3, B)] * rng.choice([-1.0, 1.0], (B, 1))
    d = np.where((rng.integers(0, 3, B) == 2)[:, None], along, d).astype(dtype)
    zero = d == 0.0
    d = np.where(zero, np.copysign(dtype(0.0), rng.choice([-1.0, 1.0], (B, 3))), d)
    dist = rng.uniform(50.0, 300.0, B) * distance
    p = (target - d * dist[:, None]).astype(dtype)
    p = np.where(zero, target.astype(dtype), p)
    return p, d.astype(dtype), _caps(rng, dist).astype(dtype)


def vertex_rays(rng, B, vertices, distance=1e-5, dtype=np.float32):
    """``B`` rays aimed exactly at ``vertices`` [V, 3] (km, taken into
    ``dtype`` first) of a mesh, where several triangles meet and tie: a
    capped 12-segment cylinder's apex joins twelve, its side vertices up to
    six. Half come from random directions ``distance`` x (50..300) away;
    the other half travel along an axis, with two direction components
    exactly +0 or -0 and the origin's two other coordinates the vertex's
    own. The caps are twice, exactly, just above and just below the
    distance to the vertex. Returns ``(p, d, t_max)`` in ``dtype``."""
    target = np.asarray(vertices, dtype)[rng.integers(0, len(vertices), B)].astype(np.float64)
    dist = rng.uniform(50.0, 300.0, B) * distance
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    p = (target + back * dist[:, None]).astype(dtype)
    d = target - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(dtype)
    along = np.arange(B) % 2 == 1
    axis = np.eye(3)[rng.integers(0, 3, B)] * rng.choice([-1.0, 1.0], (B, 1))
    zero = np.copysign(0.0, rng.choice([-1.0, 1.0], (B, 3)))
    d_axis = np.where(axis == 0.0, zero, axis).astype(dtype)
    d = np.where(along[:, None], d_axis, d)
    p = np.where(along[:, None], (target - d_axis * dist[:, None]).astype(dtype), p)
    p = np.where(along[:, None] & (axis == 0.0), target.astype(dtype), p)
    return p, d, _caps(rng, dist).astype(dtype)


def tie_soup(rng, B, n=600, dtype=np.float32):
    """A soup of ``n`` random triangles (km) with exact ties of the hit
    distance, and ``B`` rays that meet them. Copies scaled by two about
    ``v0`` hit at the same ``t`` bit for bit (every product scales by a power
    of two), and so do exact duplicates; each kind sits once inside the
    first 512-triangle chunk and once across the chunk boundary, the copy at
    the higher index (its box contains the original's, so a traversal
    nearest-first meets it first), and one copy has the opposite winding.
    Those tied triangles share their normal; two pairs of coplanar squares'
    halves of opposite winding in the plane z = 0, one pair inside chunk 0
    and one across the boundary, do not: rays straight down onto them
    (dyadic coordinates, so the test is exact) average two opposite normals
    inside the chunk, and must take the lower chunk's across. A fifth of the
    rays go straight down; the rest aim at interior points of the other
    originals from 5 cm. Returns ``(v0, e1, e2)`` and ``(p, d, t_max)``, built
    in float32 and taken exactly into ``dtype`` (the ties stay ties)."""
    v0 = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 2e-3, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 2e-3, (n, 3)).astype(np.float32)
    v0[1], e1[1], e2[1] = v0[0], 2 * e1[0], 2 * e2[0]  # scaled, inside chunk 0
    v0[n - 1], e1[n - 1], e2[n - 1] = v0[2], 2 * e1[2], 2 * e2[2]  # scaled, across
    v0[3], e1[3], e2[3] = v0[4], e2[4], e1[4]  # opposite winding
    v0[7], e1[7], e2[7] = v0[5], e1[5], e2[5]  # duplicate inside chunk 0
    v0[n - 2], e1[n - 2], e2[n - 2] = v0[6], e1[6], e2[6]  # duplicate across
    side = np.float32(2.0**-7)
    ex, ey = np.array([side, 0, 0], np.float32), np.array([0, side, 0], np.float32)
    corners = {8: (2.0**-5, 2.0**-5), 9: (2.0**-5, 2.0**-5),  # inside chunk 0
               10: (-(2.0**-5), 2.0**-5), n - 3: (-(2.0**-5), 2.0**-5)}  # across
    for k, (x, y) in corners.items():
        v0[k] = (x, y, 0.0)
        e1[k], e2[k] = (ey, ex) if k in (8, 10) else (ex, ey)  # normals -z, +z
    k = np.array([0, 1, 2, 3, 4, 5, 6, 7, n - 1, n - 2])[np.arange(B) % 10]
    a, b = rng.uniform(0.05, 0.4, B), rng.uniform(0.05, 0.4, B)
    target = v0[k] + a[:, None] * e1[k] + b[:, None] * e2[k]
    back = rng.normal(size=(B, 3))
    back /= np.linalg.norm(back, axis=1, keepdims=True)
    p = (target + 0.05 * back).astype(np.float32)
    d = target - p
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    down = np.arange(B) % 5 == 4
    square = rng.choice([8, 10], B)
    fx, fy = (np.floor(rng.uniform(1, 32, (2, B))) * 2.0**-13).astype(np.float32)
    p[down, 0] = v0[square, 0][down] + fx[down]
    p[down, 1] = v0[square, 1][down] + fy[down]
    p[down, 2] = 2.0**-4
    d[down] = (0.0, 0.0, -1.0)
    arrays = (v0, e1, e2), (p, d, np.full(B, 1.0, np.float32))
    return tuple(tuple(a.astype(dtype) for a in part) for part in arrays)


def instanced_tie_soup(rng, B, n=600, dtype=np.float32):
    """A canonical soup of ``n`` triangles (km) at nine offsets, with exact
    ties of the hit distance inside an instance and across instances, and
    ``B`` rays that meet them.

    Inside an instance, the soup and rays of :func:`tie_soup` (rows 0-10 and
    the last three), five lanes in seven.

    Across instances: four squares' halves ``a`` (rows 11-14, chunk 0) in
    the plane z = 0 with the normal -z, and their copies ``b`` (rows n-5 down
    to n-8, the last chunk) moved by ``shift = (delta, 0, delta)``, ``delta =
    1 / 16``, with the opposite winding (+z); dyadic coordinates, so that the
    exact test is exact. Offsets: rows 0-2 at 0 (``A``), rows 3-5 at
    ``shift`` (``B``) and rows 6-8 at ``-shift`` (``C``), three instances
    at each offset. ``A``'s ``b`` and ``B``'s ``a`` then coincide, and so do
    ``A``'s ``a`` and ``C``'s ``b``. A lane in seven goes straight down onto
    the first pair: the lowest instance, row 0, wins from the higher chunk,
    with ``b``'s normal. Another goes straight up onto the second: row 0
    wins from the lower chunk, with ``a``'s normal. Both travel along z, with
    x and y direction components of exactly +0 or -0. The offsets' clusters
    are apart along the diagonal, so the top level holds each in leaves of
    its own; ``B``'s boxes reach higher than ``A``'s and ``C``'s lower, so a
    walk of the instances nearer first meets the higher instance (``B``,
    then ``C``) before ``A``, and the winner replaces a tie of a higher key.

    Returns ``(v0, e1, e2)``, ``offsets`` [9, 3] and ``(p, d, t_max)``, built
    in float32 and taken exactly into ``dtype``."""
    (v0, e1, e2), (p, d, t_max) = tie_soup(rng, B, n)
    delta = 2.0**-4
    side = np.float32(2.0**-7)
    ex, ey = np.array([side, 0, 0], np.float32), np.array([0, side, 0], np.float32)
    xs = -(2.0**-5) + 2.0**-6 * np.arange(4)
    a, b = 11 + np.arange(4), n - 5 - np.arange(4)
    v0[a] = np.stack([xs, np.full(4, -delta), np.zeros(4)], axis=1)
    e1[a], e2[a] = ey, ex  # normal -z
    v0[b] = v0[a] + np.float32([delta, 0.0, delta])
    e1[b], e2[b] = ex, ey  # normal +z
    shift = np.array([delta, 0.0, delta])
    offsets = np.repeat(np.stack([np.zeros(3), shift, 0.0 - shift]), 3, axis=0).astype(np.float32)

    kind = np.arange(B) % 7
    k = rng.integers(0, 4, B)
    fx = rng.integers(1, 63, B)
    fy = (rng.uniform(0, 1, B) * (63 - fx)).astype(np.int64) + 1  # fx + fy <= 63
    for want, dz, z, move in ((5, -1.0, 0.25, delta), (6, 1.0, -0.25, 0.0)):
        lanes = kind == want
        p[lanes, 0] = xs[k[lanes]] + move + fx[lanes] * 2.0**-13
        p[lanes, 1] = -delta + fy[lanes] * 2.0**-13
        p[lanes, 2] = z
        signs = rng.choice([-1.0, 1.0], (int(lanes.sum()), 2))
        d[lanes] = np.concatenate([np.copysign(0.0, signs), np.full((signs.shape[0], 1), dz)],
                                  axis=1)
    cast = lambda arrays: tuple(a.astype(dtype) for a in arrays)  # noqa: E731
    return cast((v0, e1, e2)), offsets.astype(dtype), cast((p, d, t_max))


def zero_normal_tris(rng, v0, e1, e2, share=0.5):
    """The soup ``v0``, ``e1``, ``e2`` [N, 3] with, on a ``share`` of the
    triangles, one coordinate of both edges set to exactly +0 or -0: the
    triangle then lies in a plane of that coordinate, and its normal's two
    other components are +-0 as the cross product's signed zeros give them.
    Returns float32 ``(v0, e1, e2)``."""
    e1, e2 = (np.array(x, np.float32) for x in (e1, e2))
    N = e1.shape[0]
    pick = np.nonzero(rng.uniform(0, 1, N) < share)[0]
    axis = rng.integers(0, 3, pick.size)
    for e in (e1, e2):
        e[pick, axis] = np.copysign(np.float32(0.0), rng.choice([-1.0, 1.0], pick.size))
    return np.asarray(v0, np.float32), e1, e2
