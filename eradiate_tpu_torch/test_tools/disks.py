"""Leaf-disk tables and rays that stress the leaf sweeps, for the tests and
the smoke script.

:func:`random_disks` makes a Morton-ordered table of random disks;
:func:`rim_rays` aims rays at points on, just inside and just outside their
rims; :func:`axis_rays` does so with direction components that are exactly
+-0, along the planes of the disks' box faces; :func:`grazing_rays` meets
the disks at grazing incidence; :func:`tie_disks` makes exact ties of the
hit distance between disks of one 512-disk chunk and of two;
:func:`zero_normal_disks` gives normals with components exactly +-0.
Every function draws from the generator it is given.
"""

from __future__ import annotations

import numpy as np

from ..ops.canopy import morton_order

__all__ = ["random_disks", "rim_rays", "axis_rays", "grazing_rays", "tie_disks",
           "zero_normal_disks"]


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


def rim_rays(rng, B, c, n, r, offsets=None, distance=1.0):
    """``B`` rays aimed at points of disks drawn at random: on the rim, just
    inside and just outside it (1e-7 and 1e-6 of the radius) and halfway in,
    in one of the instance frames ``offsets`` [I, 3] if given. Origins lie
    ``distance`` x (0.5..3) back along a random direction; the caps are
    twice, exactly, just above and just below the distance to the target.
    Returns float32 ``(p, d, t_max)``."""
    offsets = np.zeros((1, 3)) if offsets is None else np.asarray(offsets)
    leaf = rng.integers(0, c.shape[0], B)
    u = _in_plane(rng, n[leaf])
    scale = 1 + rng.choice([0.0, 1e-7, -1e-7, 1e-6, -1e-6, -0.5], B)
    rim = c[leaf] + (r[leaf] * scale)[:, None] * u + offsets[rng.integers(0, len(offsets), B)]
    back = _unit(rng.normal(size=(B, 3)))
    dist = rng.uniform(0.5, 3.0, B) * distance
    t_max = _caps(rng, dist)
    return tuple(np.asarray(a, np.float32) for a in (rim + back * dist[:, None], -back, t_max))


def axis_rays(rng, B, c, n, r, distance=1.0):
    """``B`` rays with direction components that are exactly +0 or -0 (the
    sun and the views of an hplane at azimuth 0 have d_y = 0): two thirds
    travel in the x-z plane, a third along an axis. Half aim at the point of
    a disk's rim that is extreme along a zero axis, and start on that axis at
    the disk's box face (the float32 of the rim point's coordinate); the
    rest at interior points, starting on the target's own coordinates.
    Origins lie ``distance`` x (0.5..3) back. Returns float32 ``(p, d,
    t_max)``."""
    leaf = rng.integers(0, c.shape[0], B)
    angle = rng.uniform(0.0, 2.0 * np.pi, B)
    d = np.stack([np.cos(angle), np.zeros(B), np.sin(angle)], axis=1)
    along = np.eye(3)[rng.integers(0, 3, B)] * rng.choice([-1.0, 1.0], (B, 1))
    d = np.where((rng.integers(0, 3, B) == 2)[:, None], along, d).astype(np.float32)
    zero = d == 0.0
    d = np.where(zero, np.copysign(np.float32(0.0), rng.choice([-1.0, 1.0], (B, 3))), d)
    # a zero axis of each ray, and the rim point extreme along it
    axis = np.argmax(zero, axis=1)
    e = np.eye(3)[axis] * rng.choice([-1.0, 1.0], (B, 1))
    nl = n[leaf]
    w = e - (e * nl).sum(1, keepdims=True) * nl
    extreme = c[leaf] + r[leaf, None] * _unit(np.where(np.abs(w).sum(1, keepdims=True) > 0,
                                                        w, _in_plane(rng, nl)))
    inner = c[leaf] + (0.8 * r[leaf] * rng.uniform(0, 1, B))[:, None] * _in_plane(rng, nl)
    target = np.where((rng.integers(0, 2, B) == 0)[:, None], extreme, inner)
    dist = rng.uniform(0.5, 3.0, B) * distance
    p = (target - d * dist[:, None]).astype(np.float32)
    p = np.where(zero, target.astype(np.float32), p)
    return p, d.astype(np.float32), _caps(rng, dist).astype(np.float32)


def grazing_rays(rng, B, c, n, r, distance=1.0):
    """``B`` rays that meet a disk drawn at random at grazing incidence: an
    in-plane direction tilted toward the normal by 1e-2 to 1e-5 (either
    side), aimed at interior and rim points. Origins lie ``distance`` x
    (0.5..3) back. Returns float32 ``(p, d, t_max)``."""
    leaf = rng.integers(0, c.shape[0], B)
    nl = n[leaf]
    tilt = rng.choice([1e-2, 1e-3, 1e-4, 1e-5], B) * rng.choice([-1.0, 1.0], B)
    d = _unit(_in_plane(rng, nl) + tilt[:, None] * nl)
    s = rng.choice([0.0, 0.5, 1.0 - 1e-6, 1.0, 1.0 + 1e-6], B)
    target = c[leaf] + (r[leaf] * s)[:, None] * _in_plane(rng, nl)
    dist = rng.uniform(0.5, 3.0, B) * distance
    p = target - d * dist[:, None]
    return tuple(np.asarray(a, np.float32) for a in (p, d, _caps(rng, dist)))


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
