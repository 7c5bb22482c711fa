"""Digital elevation model (heightfield) terrain.

Port of ``eradiate_tpu/ops/dem.py``: the terrain is a bilinear heightfield
h(x, y) on a regular grid, continued at the edge elevation outside it
(clamped lookup), intersected by a fixed-step march with bisection
refinement; :func:`mesh_from_dem` triangulates the same grid for the
triangle sweeps. Heights and coordinates in km.

The reference's march is a ``fori_loop`` of single steps. Here it runs in
blocks of ``block`` steps as ``[b, block]`` tensors (:func:`_march`): the
distances ``dt * (step + 1)`` are those of the single steps, element by
element, the first sign change of a block is taken with an argmax, and the
march stops once every lane has found its crossing, so the result is the
step loop's bit for bit whatever the block size. A block is evaluated only
on the lanes whose points in it may reach the heights' range from their
start's side: a ray from the top of the atmosphere marches the last block
or two of its descent. Shadow rays read only whether a crossing exists
(:func:`dem_occluded`) and skip the bisection.

Rounding follows the jitted reference, which XLA:CPU contracts: the march
point ``p + d t`` is one fused multiply-add a component, so is the step's
``t_max * 1.02 + 1e-4``, and the bilinear sum is three fused multiply-adds
(:func:`dem_height`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.dual import refuse_tangents
from ..kernels.leaf_intersect import dot3, fma
from .fastmath import sqrt_rn
from ..kernels.tri_intersect import _sqrt_rn
from .mesh import TriangleMeshArrays, mesh_from_vertices

__all__ = [
    "DemArrays",
    "MARCH_BLOCK",
    "dem_height",
    "dem_normal",
    "dem_intersect",
    "dem_occluded",
    "mesh_from_dem",
]

#: March steps evaluated together as one ``[b, block]`` tensor.
MARCH_BLOCK = 32


@dataclasses.dataclass
class DemArrays:
    heights: Any  # [Ny, Nx]
    x0: Any  # scalar: west edge
    y0: Any  # scalar: south edge
    dx: Any  # scalar: grid spacing x
    dy: Any  # scalar: grid spacing y


def dem_height(dem, x, y, addend=1):
    """Bilinear height lookup h(x, y) with edge clamping (any shape).

    XLA:CPU contracts the reference's four-term sum into three fused
    multiply-adds, the first of which adds term ``addend`` (0 or 1) to the
    product of the other of the first two terms; which one it takes
    depends on the graph (:func:`dem_normal`)."""
    h = dem.heights
    ny, nx = h.shape
    u = (x - dem.x0) / dem.dx
    v = (y - dem.y0) / dem.dy
    # clamping the floor before the integer cast equals the reference's
    # saturating cast then clip for every finite value
    i = torch.clamp(torch.floor(u), 0, nx - 2)
    j = torch.clamp(torch.floor(v), 0, ny - 2)
    fu = torch.clamp(u - i, 0.0, 1.0)
    fv = torch.clamp(v - j, 0.0, 1.0)
    # the four posts of the cell in one gather
    flat = (j * nx + i).long()[..., None] + torch.tensor([0, 1, nx, nx + 1], device=h.device)
    h00, h01, h10, h11 = h.reshape(-1)[flat].unbind(-1)
    gu = 1 - fu
    gv = 1 - fv
    if addend == 1:
        s = fma(h00 * gu, gv, h01 * fu * gv)
    else:
        s = fma(h01 * fu, gv, h00 * gu * gv)
    s = fma(h10 * gu, fv, s)
    return fma(h11 * fu, fv, s)


def dem_normal(dem, x, y):
    """Upward surface normal [..., 3] from central differences of the
    heightfield. In the jitted reference XLA:CPU contracts the lookups of
    the x difference with term 0 as the first addend, those of the y
    difference with term 1 (:func:`dem_height`)."""
    eps_x = dem.dx * 0.5
    eps_y = dem.dy * 0.5
    dhdx = (dem_height(dem, x + eps_x, y, 0) - dem_height(dem, x - eps_x, y, 0)) / (2.0 * eps_x)
    dhdy = (dem_height(dem, x, y + eps_y) - dem_height(dem, x, y - eps_y)) / (2.0 * eps_y)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    # the norm as XLA:CPU evaluates jnp.linalg.norm: two fused
    # multiply-adds, then a correctly rounded root
    s = dot3(n, n)
    norm = _sqrt_rn(s) if s.dtype == torch.float64 else sqrt_rn(s)
    return n / norm[..., None]


def _sdf(dem, p, d, t):
    """Height of the points ``p + d t`` above the terrain: ``p``, ``d``
    [b, 3], ``t`` [b, k] -> [b, k]."""
    shape = (*t.shape, 3)
    q = fma(d[:, None, :].expand(shape), t[..., None].expand(shape), p[:, None, :].expand(shape))
    return q[..., 2] - dem_height(dem, q[..., 0], q[..., 1])


def _step(t_max, n_march):
    """The march step ``(t_max * 1.02 + 1e-4) / n_march``: the segment is
    overshot slightly, as in the reference."""
    return fma(t_max, torch.full_like(t_max, 1.02), torch.full_like(t_max, 1e-4)) / n_march


def _march(dem, p, d, dt, s0, n_march, block):
    """The fixed-step march of lanes ``p``, ``d`` [b, 3] with steps ``dt``
    [b] from the start heights ``s0`` [b]: returns ``(found, t_lo, t_hi)``,
    the first step ``k`` whose point has another sign than the start (0
    counts as a sign of its own) bracketed by ``t_hi = dt (k + 1)`` and
    ``t_lo = t_hi - dt``; ``(False, 0, 0)`` where none does or where ``s0 ==
    0``.

    A block is evaluated only on the lanes still searching whose points in
    it may reach the heights' range: a block wholly above the highest post
    (below the lowest) from a start above (below) the terrain holds no
    sign change. The margin is far above the rounding of ``p + d t`` and of
    the bilinear sum."""
    b = p.shape[0]
    dev = p.device
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    t_lo = torch.zeros_like(dt)
    t_hi = torch.zeros_like(dt)
    sign0 = torch.sign(s0)
    searching = s0 != 0.0
    h_lo, h_hi = dem.heights.min(), dem.heights.max()
    pz, dz = p[:, 2], d[:, 2]
    margin = 1e-4 * (1.0 + torch.abs(pz) + torch.abs(dz) * (dt * n_march)
                     + torch.maximum(torch.abs(h_lo), torch.abs(h_hi)))
    for k0 in range(0, n_march, block):
        k1 = min(k0 + block, n_march)
        z_a = pz + dz * (dt * (k0 + 1))
        z_b = pz + dz * (dt * k1)
        above = torch.minimum(z_a, z_b) - margin > h_hi
        below = torch.maximum(z_a, z_b) + margin < h_lo
        idx = torch.nonzero(searching & ~((s0 > 0) & above) & ~((s0 < 0) & below)).squeeze(1)
        if idx.numel():
            steps = torch.arange(k0 + 1, k1 + 1, device=dev).to(dt.dtype)
            t = dt[idx, None] * steps[None, :]
            cross = torch.sign(_sdf(dem, p[idx], d[idx], t)) != sign0[idx, None]
            hit = cross.any(dim=1)
            first = torch.argmax(cross.to(torch.uint8), dim=1, keepdim=True)
            t_first = torch.gather(t, 1, first).squeeze(1)[hit]
            lanes = idx[hit]
            t_hi[lanes] = t_first
            t_lo[lanes] = t_first - dt[lanes]
            found[lanes] = True
            searching[lanes] = False
        if not bool(searching.any()):
            break
    return found, t_lo, t_hi


def _setup(dem, p, d, t_max, n_march, lanes):
    """``(idx, p, d, dt, s0)`` of the marched lanes (those of ``lanes``,
    all if None): their indices, rays, steps and start heights."""
    dt = _step(t_max, n_march)
    if lanes is not None:
        idx = torch.nonzero(lanes).squeeze(1)
        p, d, dt = p[idx], d[idx], dt[idx]
    else:
        idx = None
    t0 = torch.full((p.shape[0], 1), 1e-6, dtype=p.dtype, device=p.device)
    s0 = _sdf(dem, p, d, t0).squeeze(1)
    return idx, p, d, dt, s0


def _scatter(idx, values, fill):
    """``values`` of the marched lanes at their indices ``idx`` in a copy of
    ``fill`` (all lanes where ``idx`` is None)."""
    if idx is None:
        return values
    out = fill.clone()
    out[idx] = values
    return out


def dem_intersect(dem, p, d, t_max, n_march=128, n_bisect=16, lanes=None,
                  block=MARCH_BLOCK):
    """First crossing of z = h(x, y) along ``p + t d``, t in (0, t_max]:
    a march of ``n_march`` steps over the (overshot) segment and
    ``n_bisect`` bisections of the crossed step. Returns ``(t_hit, hit)``
    [B]; misses keep ``t_max``. ``lanes`` [B] bool, if given, marches only
    those lanes (the others miss); ``block`` changes nothing but the
    speed. No forward-mode tangent may reach the march (the terrain and
    the rays are geometry, which the sensitivity renders detach): one
    raises."""
    refuse_tangents("dem_intersect", p=p, d=d, t_max=t_max, heights=dem.heights)
    t_max = t_max.to(p.dtype)
    idx, p_c, d_c, dt_c, s0 = _setup(dem, p, d, t_max, n_march, lanes)
    found, t_lo, t_hi = _march(dem, p_c, d_c, dt_c, s0, n_march, block)
    f_idx = torch.nonzero(found).squeeze(1)
    p_f, d_f, sign0 = p_c[f_idx], d_c[f_idx], torch.sign(s0[f_idx])
    lo, hi = t_lo[f_idx], t_hi[f_idx]
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        same = torch.sign(_sdf(dem, p_f, d_f, mid[:, None]).squeeze(1)) == sign0
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    t_c = (t_max if idx is None else t_max[idx]).clone()
    t_c[f_idx] = 0.5 * (lo + hi)
    no_hit = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    return _scatter(idx, t_c, t_max), _scatter(idx, found, no_hit)


def dem_occluded(dem, p, d, t_max, n_march=128, lanes=None, block=MARCH_BLOCK):
    """Whether ``p + t d`` crosses the terrain within the march of
    :func:`dem_intersect` (its ``hit``, without the bisection): the
    shadow-ray form. Returns bool [B]; a forward-mode tangent raises, as in
    :func:`dem_intersect`."""
    refuse_tangents("dem_occluded", p=p, d=d, t_max=t_max, heights=dem.heights)
    t_max = t_max.to(p.dtype)
    idx, p_c, d_c, dt_c, s0 = _setup(dem, p, d, t_max, n_march, lanes)
    found, _, _ = _march(dem, p_c, d_c, dt_c, s0, n_march, block)
    return _scatter(idx, found, torch.zeros(p.shape[0], dtype=torch.bool, device=p.device))


def mesh_from_dem(heights, x0, y0, dx, dy, dtype=np.float32, device="cpu"):
    """The heightfield as a triangle soup (two triangles a grid cell,
    diagonal from post (j, i + 1) to post (j + 1, i); the cells' first
    triangles, then their second ones), in the reference's order: a
    :class:`~.mesh.TriangleMeshArrays` of ``dtype`` tensors on ``device``,
    the vertices cast before the edges are differenced."""
    h = np.asarray(heights, dtype=np.float64)
    ny, nx = h.shape
    xs = np.asarray(x0, dtype=np.float64) + np.arange(nx) * float(dx)
    ys = np.asarray(y0, dtype=np.float64) + np.arange(ny) * float(dy)
    X, Y = np.meshgrid(xs, ys)
    verts = np.stack([X.ravel(), Y.ravel(), h.ravel()], axis=-1)
    idx = np.arange(ny * nx).reshape(ny, nx)
    a = idx[:-1, :-1].ravel()  # (j, i)
    b = idx[:-1, 1:].ravel()  # (j, i + 1)
    c = idx[1:, :-1].ravel()  # (j + 1, i)
    e = idx[1:, 1:].ravel()  # (j + 1, i + 1)
    faces = np.concatenate([np.stack([a, b, c], axis=-1), np.stack([e, c, b], axis=-1)])
    m = mesh_from_vertices(np.asarray(verts, dtype=dtype), faces)
    return TriangleMeshArrays(
        *(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (m.v0, m.e1, m.e2))
    )
