"""Leaf-disk tables and rays that stress the leaf sweeps, for the tests and
the smoke script.

:func:`random_disks` makes a Morton-ordered table of random disks;
:func:`rim_rays` aims rays at points on, just inside and just outside their
rims; :func:`axis_rays` does so with direction components that are exactly
+-0, along the planes of the disks' box faces; :func:`grazing_rays` meets
the disks at grazing incidence; :func:`tie_disks` makes exact ties of the
hit distance between disks of one 512-disk chunk and of two;
:func:`zero_normal_disks` gives normals with components exactly +-0.
Every function draws from the generator it is given; the rays and the tie
tables come in float32 unless ``dtype`` asks for float64 (the float64
builds' stresses, at full float64 resolution).
"""

from __future__ import annotations

import numpy as np

from ..ops.canopy import morton_order

__all__ = ["random_disks", "rim_rays", "axis_rays", "grazing_rays", "tie_disks",
           "instanced_tie_disks", "zero_normal_disks"]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def random_disks(rng, N):
    """``N`` disks in the box [-1, 1]^3, Morton-ordered, with unit normals
    drawn uniformly on the sphere and radii 0.05 to 0.2: float64 ``(c, n,
    r)``."""
    c = rng.uniform(-1, 1, (N, 3))
    c = c[morton_order(c)]
    n = _unit(rng.normal(size=(N, 3)))
    return c, n, rng.uniform(0.05, 0.2, N)


def _caps(rng, dist):
    """Caps twice, exactly, just above and just below the distance."""
    return dist * rng.choice([2.0, 1.0, 1 + 1e-7, 1 - 1e-7], dist.shape[0])


def _in_plane(rng, n):
    """A random unit vector in each disk's plane."""
    return _unit(np.cross(n, rng.normal(size=n.shape)))


def _frames(rng, B, offsets):
    """An offset of ``offsets`` [I, 3] drawn for each of ``B`` rays, or
    zeros (drawing nothing) where there are none."""
    if offsets is None:
        return np.zeros((B, 3))
    offsets = np.asarray(offsets, np.float64)
    return offsets[rng.integers(0, len(offsets), B)]


def rim_rays(rng, B, c, n, r, offsets=None, distance=1.0, origins=None, dtype=np.float32):
    """``B`` rays aimed at points of disks drawn at random: on the rim, just
    inside and just outside it (1e-7 and 1e-6 of the radius) and halfway in,
    in one of the instance frames ``offsets`` [I, 3] if given. Origins lie
    ``distance`` x (0.5..3) back along a random direction, or at ``origins``
    [B, 3] if given; the caps are twice, exactly, just above and just below
    the distance to the target. Returns ``(p, d, t_max)`` in ``dtype``."""
    offsets = np.zeros((1, 3)) if offsets is None else np.asarray(offsets)
    leaf = rng.integers(0, c.shape[0], B)
    u = _in_plane(rng, n[leaf])
    scale = 1 + rng.choice([0.0, 1e-7, -1e-7, 1e-6, -1e-6, -0.5], B)
    rim = c[leaf] + (r[leaf] * scale)[:, None] * u + offsets[rng.integers(0, len(offsets), B)]
    back = _unit(rng.normal(size=(B, 3)))
    dist = rng.uniform(0.5, 3.0, B) * distance
    if origins is not None:
        back = _unit(origins - rim)
        dist = np.linalg.norm(origins - rim, axis=1)
    t_max = _caps(rng, dist)
    return tuple(np.asarray(a, dtype) for a in (rim + back * dist[:, None], -back, t_max))


def axis_rays(rng, B, c, n, r, distance=1.0, offsets=None, dtype=np.float32):
    """``B`` rays with direction components that are exactly +0 or -0 (the
    sun and the views of an hplane at azimuth 0 have d_y = 0): two thirds
    travel in the x-z plane, a third along an axis. Half aim at the point of
    a disk's rim that is extreme along a zero axis, and start on that axis at
    the disk's box face (the float32 of the rim point's coordinate); the
    rest at interior points, starting on the target's own coordinates. In
    one of the instance frames ``offsets`` [I, 3] if given (the world
    target's coordinates). Origins lie ``distance`` x (0.5..3) back.
    Returns ``(p, d, t_max)`` in ``dtype``."""
    leaf = rng.integers(0, c.shape[0], B)
    angle = rng.uniform(0.0, 2.0 * np.pi, B)
    d = np.stack([np.cos(angle), np.zeros(B), np.sin(angle)], axis=1)
    along = np.eye(3)[rng.integers(0, 3, B)] * rng.choice([-1.0, 1.0], (B, 1))
    d = np.where((rng.integers(0, 3, B) == 2)[:, None], along, d).astype(dtype)
    zero = d == 0.0
    d = np.where(zero, np.copysign(dtype(0.0), rng.choice([-1.0, 1.0], (B, 3))), d)
    # a zero axis of each ray, and the rim point extreme along it
    axis = np.argmax(zero, axis=1)
    e = np.eye(3)[axis] * rng.choice([-1.0, 1.0], (B, 1))
    nl = n[leaf]
    w = e - (e * nl).sum(1, keepdims=True) * nl
    extreme = c[leaf] + r[leaf, None] * _unit(np.where(np.abs(w).sum(1, keepdims=True) > 0,
                                                        w, _in_plane(rng, nl)))
    inner = c[leaf] + (0.8 * r[leaf] * rng.uniform(0, 1, B))[:, None] * _in_plane(rng, nl)
    target = np.where((rng.integers(0, 2, B) == 0)[:, None], extreme, inner)
    target = target + _frames(rng, B, offsets)
    dist = rng.uniform(0.5, 3.0, B) * distance
    p = (target - d * dist[:, None]).astype(dtype)
    p = np.where(zero, target.astype(dtype), p)
    return p, d.astype(dtype), _caps(rng, dist).astype(dtype)


def grazing_rays(rng, B, c, n, r, distance=1.0, offsets=None, dtype=np.float32):
    """``B`` rays that meet a disk drawn at random at grazing incidence: an
    in-plane direction tilted toward the normal by 1e-2 to 1e-5 (either
    side), aimed at interior and rim points, in one of the instance frames
    ``offsets`` [I, 3] if given. Origins lie ``distance`` x (0.5..3) back.
    Returns ``(p, d, t_max)`` in ``dtype``."""
    leaf = rng.integers(0, c.shape[0], B)
    nl = n[leaf]
    tilt = rng.choice([1e-2, 1e-3, 1e-4, 1e-5], B) * rng.choice([-1.0, 1.0], B)
    d = _unit(_in_plane(rng, nl) + tilt[:, None] * nl)
    s = rng.choice([0.0, 0.5, 1.0 - 1e-6, 1.0, 1.0 + 1e-6], B)
    target = c[leaf] + (r[leaf] * s)[:, None] * _in_plane(rng, nl) + _frames(rng, B, offsets)
    dist = rng.uniform(0.5, 3.0, B) * distance
    p = target - d * dist[:, None]
    return tuple(np.asarray(a, dtype) for a in (p, d, _caps(rng, dist)))


def zero_normal_disks(rng, n, share=0.5):
    """Normals ``n`` [N, 3] with, on a ``share`` of the disks, one or two
    components set to exactly +0 or -0 (the rest renormalised): float64."""
    n = n.copy()
    N = n.shape[0]
    pick = rng.uniform(0, 1, N) < share
    zero = (np.eye(3)[rng.integers(0, 3, N)] + (rng.uniform(0, 1, N) < 0.3)[:, None]
            * np.eye(3)[rng.integers(0, 3, N)]) > 0
    zero &= pick[:, None]
    zero[zero.all(axis=1), 2] = False  # keep one component
    n = np.where(zero, 0.0, n)
    n = _unit(n)
    return np.where(zero, np.copysign(0.0, rng.choice([-1.0, 1.0], (N, 3))), n)


def tie_disks(rng, B, N=600):
    """A table of ``N`` disks (km) with exact ties of the hit distance, and
    ``B`` rays that meet them. A disk and its copy with the normal negated
    hit at the same ``t`` bit for bit (every product and sum of the test
    changes sign exactly), and so does a copy with a larger radius or an
    exact duplicate. Copies: the opposite normal inside the first 512-disk
    chunk (the two normals average to zero) and across the chunk boundary
    (the lower chunk's normal must win), the latter with twice the radius
    and so the larger box, so that a traversal nearest-first meets the
    higher chunk first; a duplicate across, and a larger copy with the same
    normal inside. Rays aim at the originals within half their radius from
    5 cm. Returns float32 ``(c, n, r)`` and ``(p, d, t_max)``."""
    c = rng.uniform(-0.02, 0.02, (N, 3))
    n = _unit(rng.normal(size=(N, 3)))
    r = rng.uniform(1e-3, 3e-3, N)
    c, n, r = (np.asarray(a, np.float32) for a in (c, n, r))
    c[1], n[1], r[1] = c[0], -n[0], r[0]  # opposite normal, inside chunk 0
    c[N - 1], n[N - 1], r[N - 1] = c[2], -n[2], 2 * r[2]  # opposite, larger, across
    c[3], n[3], r[3] = c[4], n[4], 2 * r[4]  # larger, inside chunk 0
    c[N - 2], n[N - 2], r[N - 2] = c[5], n[5], r[5]  # duplicate across
    k = np.array([0, 2, 4, 5])[np.arange(B) % 4]
    u = _in_plane(rng, n[k].astype(np.float64))
    target = c[k] + (0.5 * r[k] * rng.uniform(0, 1, B))[:, None] * u
    back = _unit(rng.normal(size=(B, 3)))
    p = (target + 0.05 * back).astype(np.float32)
    d = _unit(target - p).astype(np.float32)
    return (c, n, r), (p, d, np.full(B, 0.1, np.float32))


def _sum_in_order_differs(n):
    """Does summation in index order in ``n``'s dtype, fl(fl(fl(n + n) + n)
    - n), miss 2n exactly in a component of ``n`` [3]?"""
    return bool((((n + n) + n) - n != n.dtype.type(2) * n).any())


def instanced_tie_disks(rng, B, N=600, dtype=np.float32):
    """A canonical table of ``N`` disks (km) at three offsets, ``(0, 0, 0)``,
    ``(delta, 0, 0)`` and ``(-delta, 0, 0)`` with ``delta = 1 / 16``, wider
    than the cloud, with exact ties of the hit
    distance inside an instance and across instances, and ``B`` rays that
    meet them.

    Inside an instance, as :func:`tie_disks` (rows 0-5 and the last two):
    the opposite normal inside chunk 0 and across the chunk boundary, a
    larger copy inside, a duplicate across; and a quad tie, four coincident
    disks (rows 6-9) in chunk 0 with normals n, n, n, -n, whose average is
    n / 2 exactly when summed in float64 and not when summed in float32 in
    index order (n is drawn until fl(fl(3n) - n) != 2n in a component).
    With ``dtype`` float64 (the float64 builds' table, full float64
    coordinates and normals) n is drawn until that holds in float64, so
    that only the reference's order of the sum, index order from zero,
    gives its average.

    Across instances: disks a (rows 10-13) whose normals have an x component
    of exactly 0, each with a copy b = (c_a + delta x, -n_a, r_a) in the
    last chunk (rows N-3 down to N-6). Instance 0's b and instance 1's a
    then cover the same points with ``t`` equal bit for bit (the x terms of
    d.n and p.n vanish and the negated normal flips every product): the
    lower instance wins, from the higher chunk. Instance 0's a and instance
    2's b tie the same way, the lower instance from the lower chunk.

    Rays from 5 cm aim within half the radius at rows 0, 2, 4, 5, the quad,
    the a and the b disks of instance 0, a seventh of the lanes each.
    Returns ``(c, n, r)``, ``offsets`` [3, 3] and ``(p, d, t_max)`` in
    ``dtype``."""
    delta = 2.0**-4
    c = rng.uniform(-0.02, 0.02, (N, 3))
    n = _unit(rng.normal(size=(N, 3)))
    r = rng.uniform(1e-3, 3e-3, N)
    c, n, r = (np.asarray(a, dtype) for a in (c, n, r))
    c[1], n[1], r[1] = c[0], -n[0], r[0]  # opposite normal, inside chunk 0
    c[N - 1], n[N - 1], r[N - 1] = c[2], -n[2], 2 * r[2]  # opposite, larger, across
    c[3], n[3], r[3] = c[4], n[4], 2 * r[4]  # larger, inside chunk 0
    c[N - 2], n[N - 2], r[N - 2] = c[5], n[5], r[5]  # duplicate across
    while not _sum_in_order_differs(n[6]):
        n[6] = _unit(rng.normal(size=3))
    c[7:10], r[7:10] = c[6], r[6]  # the quad tie
    n[7:9], n[9] = n[6], -n[6]
    a = np.arange(10, 14)
    b = N - 3 - np.arange(4)
    na = n[a].astype(np.float64)
    na[:, 0] = 0.0
    n[a] = _unit(na)
    c[b], n[b], r[b] = c[a] + np.asarray([delta, 0.0, 0.0], dtype), -n[a], r[a]
    offsets = np.array([[0.0, 0.0, 0.0], [delta, 0.0, 0.0], [-delta, 0.0, 0.0]], dtype)

    kind = np.arange(B) % 7
    k = np.array([0, 2, 4, 5, 6, 10, N - 3])[kind]
    pair = rng.integers(0, 4, B)
    k = np.where(kind == 5, a[pair], np.where(kind == 6, b[pair], k))
    u = _in_plane(rng, n[k].astype(np.float64))
    target = c[k] + (0.5 * r[k] * rng.uniform(0, 1, B))[:, None] * u
    back = _unit(rng.normal(size=(B, 3)))
    p = (target + 0.05 * back).astype(dtype)
    d = _unit(target - p).astype(dtype)
    return (c, n, r), offsets, (p, d, np.full(B, 0.1, dtype))
