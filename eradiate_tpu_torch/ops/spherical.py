"""Spherical-shell geometry: ray/sphere distances, exact shell free flight
and slant optical depth, and the sun slant-tau table.

Port of ``eradiate_tpu/ops/spherical.py``. The atmosphere is a set of
concentric shells (radii in km from the planet centre) with
piecewise-constant extinction, so both the optical depth along a straight
ray and its inverse are closed form.

:func:`shell_flight_plain` and :func:`shell_event_plain` compute what the
reference's XLA functions (``_shell_flight_xla`` and the XLA branch of
``shell_event``) compute; they are the plain twins of the CUDA kernels in
``csrc/shell_flight.cu`` (wrappers in :mod:`..kernels.shell_flight`) and fix
every rounding the kernels reproduce:

- per-lane scalars are formed from the vectors, ``x0 = p.d`` and
  ``b^2 = |p x d|^2``, with the fused multiply-adds XLA:CPU uses for them
  (:func:`dot3`, :func:`cross_norm2`), so that they equal the reference's
  bit for bit;
- so are the radicands of the slant segments (:func:`_seg`) and the step
  to the event point in :func:`shell_event_plain`;
- square roots are correctly rounded (:func:`sqrt_rn`);
- shell quantities are level-major ``[L+1, B]`` (one row per level);
- the prefix of per-shell slant depths and the slant optical depth are sums
  over the levels in level order, accumulated in float64 (rounded to
  float32 at each level for the prefix, once at the end for the slant).

The reference builds its prefix with a hi/lo-bf16 triangular matmul
(~2^-17 relative); in float32 a lane's collide bit and layer differ from it
only where its query lies within that error of a level.

Float64 tensors (the double modes) take the same steps in float64: the
reference's XLA forms under x64 run on them, so there is no float32
rounding to reproduce. Its prefix is the hi/lo-bf16 matmul all the same,
and the float64 twin forms it as the reference does (:func:`bf16_split`);
``fma`` is then ``a * b + c`` rounded twice, where XLA:CPU forms a float64
fused multiply-add (an ulp apart at most).

The sun-tau table (:func:`sun_tau_table_grid`) is built on the host at scene
compile time; the tracer fetches it per event with
:func:`sun_tau_fetch_fast`, an exact float32 bilinear interpolation.
"""

from __future__ import annotations

import numpy as np
import torch

from .fastmath import fma32, sqrt_rn

__all__ = [
    "TAU_BLOCKED",
    "sqrt_rn",
    "fma",
    "bf16_split",
    "dot3",
    "cross_norm2",
    "ray_sphere_intersect",
    "slant_tau_exact",
    "shell_flight_plain",
    "shell_event_plain",
    "shell_depths_plain",
    "slant_path_matrix",
    "sun_mu_grid_warped",
    "sun_tau_table_grid",
    "sun_tau_fetch_fast",
]

#: Optical depth treated as total blockage (ground shadow).
TAU_BLOCKED = 1e10


def fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add does
    (evaluated in float64, where the product is exact). Float64 operands
    take ``a * b + c`` as it stands: torch has no fused multiply-add, and
    XLA's differs from it by an ulp at most."""
    if torch.float64 in (a.dtype, b.dtype, c.dtype):
        return a * b + c
    return fma32(a, b, c)


def dot3(a, b):
    """Dot product over the last axis of [..., 3] vectors (``b``
    broadcasts), as XLA:CPU evaluates ``sum(a * b, axis=-1)``: the first
    product, then two fused multiply-adds."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def cross_norm2(a, b):
    """``|a x b|^2`` over the last axis, as XLA:CPU evaluates
    ``sum(cross(a, b) ** 2, axis=-1)`` (each component ``fma(x, y, -(z w))``,
    then the :func:`dot3` chain). Cancellation-free at planet-scale radii,
    where ``|a|^2 - (a.b)^2`` loses every digit for near-radial rays."""
    c = torch.stack(
        [
            fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )
    return dot3(c, c)


def ray_sphere_intersect(p, d, radius, fused=False):
    """Distances to the sphere ``|x| = radius`` along ``x = p + t d``.

    Returns ``(t_near, t_far, hit)``; ``hit`` is False where there is no real
    intersection. ``|p|^2 - radius^2`` is rounded twice, as XLA:CPU rounds
    it in the reference's event loop, or with ``fused`` once (``radius^2``
    folded into a fused multiply-add), as it rounds it where the reference's
    renders start their rays at the top of the atmosphere. The difference
    decides, at view zeniths of 60 degrees, whether a ray's ground hit rounds
    onto the ground or one ulp inside it, where the surface offset (1e-4
    km, below half an ulp at 6378 km) cannot lift it out.
    """
    b = dot3(p, d)
    pp = dot3(p, p)
    c = fma(-radius, radius, pp) if fused else pp - radius * radius
    disc = fma(b, b, -c)
    sq = sqrt_rn(torch.clamp(disc, min=0.0))
    return -b - sq, -b + sq, disc >= 0.0


def _seg(b2, ra, rb):
    """Path length between radii ``ra <= rb`` at squared impact parameter
    ``b2``, in the cancellation-stable form
    ``(rb - ra)(rb + ra) / (sqrt(ra^2 - b2) + sqrt(rb^2 - b2))``. The
    radicands are fused multiply-adds, as XLA:CPU contracts them: near the
    tangent (``ra ~ b``) a separately rounded ``ra * ra`` moves the result
    by up to 1% relative."""
    fa = sqrt_rn(torch.clamp(fma(ra, ra, -b2), min=0.0))
    fb = sqrt_rn(torch.clamp(fma(rb, rb, -b2), min=0.0))
    num = torch.clamp(rb - ra, min=0.0) * (rb + ra)
    den = fa + fb
    return torch.where(den > 0.0, num / torch.clamp(den, min=1e-30), 0.0)


def _shell_paths(b2, b, r, lo, hi, descending):
    """Path length inside each shell ``[lo, hi]`` from radius ``r`` to the
    top of the shells, at squared impact parameter ``b2`` (``b`` its
    root); all broadcast together. Ascending rays cross the shells in
    ``[max(r, b), r_top]``; descending ones cross ``[b, r]`` down to the
    tangent, then ``[b, r_top]`` up."""
    asc_lo = torch.maximum(lo, torch.maximum(r, b))
    up = _seg(b2, torch.minimum(asc_lo, hi), hi)
    des_lo = torch.maximum(lo, b)
    des_hi = torch.minimum(hi, r)
    down = _seg(b2, torch.minimum(des_lo, des_hi), des_hi)
    up_tan = _seg(b2, torch.minimum(des_lo, hi), hi)
    return torch.where(descending, down + up_tan, up)


def _sum_levels(x):
    """Sum of ``x`` [L, B] over the levels in level order, in float64,
    rounded once to ``x``'s dtype."""
    acc = torch.zeros(x.shape[1:], dtype=torch.float64, device=x.device)
    for row in x:
        acc = acc + row.double()
    return acc.to(x.dtype)


def bf16_split(c):
    """``(hi, lo)`` of float64 ``c``: ``hi`` rounded to bfloat16, ``lo`` the
    remainder rounded to bfloat16, both as float64; each rounds through
    float32 first, as XLA converts float64 to bfloat16."""
    hi = c.to(torch.bfloat16).double()
    return hi, (c - hi).to(torch.bfloat16).double()


def _prefix_levels(c):
    """Exclusive prefix ``G[k] = sum_{j<k} c[j]`` of ``c`` [L, B] over the
    levels; returns ``G`` [L+1, B] with ``G[0] = 0``.

    Float32: accumulated in float64 in level order and rounded to float32 at
    each level. Float64 (the double modes): the reference's own prefix under
    x64, a triangular matrix product of the bfloat16 halves of ``c``
    (:func:`bf16_split`, ~2^-17 of ``c``) with float64 sums, which is the
    two running float64 sums of the halves added at each level. Those sums
    are exact (8-bit terms within 2^45 of each other), so the order of
    either sum does not change them."""
    if c.dtype == torch.float64:
        hi_sum = torch.zeros(c.shape[1:], dtype=torch.float64, device=c.device)
        lo_sum = torch.zeros_like(hi_sum)
        rows = [hi_sum + lo_sum]
        for row in c:
            hi, lo = bf16_split(row)
            hi_sum = hi_sum + hi
            lo_sum = lo_sum + lo
            rows.append(hi_sum + lo_sum)
        return torch.stack(rows)
    acc = torch.zeros(c.shape[1:], dtype=torch.float64, device=c.device)
    rows = [acc.float()]
    for row in c:
        acc = acc + row.double()
        rows.append(acc.float())
    return torch.stack(rows)


def slant_tau_exact(p, w, radii, sigma):
    """Exact slant optical depth from points ``p`` [B, 3] toward the unit
    direction ``w`` [3] through the shells (reference
    ``_slant_tau_exact_xla`` with ``r_ground = radii[0]``).

    Rays that descend (``p.w < 0``) with a tangent radius strictly below the
    ground return :data:`TAU_BLOCKED`.
    """
    r_ground = radii[0]
    r = sqrt_rn(dot3(p, p))
    mu = dot3(p, w) / torch.clamp(r, min=1e-12)
    b2 = cross_norm2(p, w)
    b = sqrt_rn(b2)
    descending = mu < 0.0
    blocked = descending & (b < r_ground)

    D = _shell_paths(b2, b, r, radii[:-1, None], radii[1:, None], descending)  # [L, B]
    tau = _sum_levels(D * sigma[:, None])
    return torch.where(blocked, TAU_BLOCKED, tau)


def shell_flight_plain(p, d, t_max, radii, sigma, tau_s):
    """Exact free flight through concentric shells (reference
    ``_shell_flight_xla`` without the likelihood-ratio extras).

    Along the ray, with x the signed coordinate from the point of closest
    approach to the planet centre, shell k spans ``|x|`` in
    ``[X(r_k), X(r_{k+1})]`` with ``X(r) = sqrt(max(r^2 - b^2, 0))``; the
    optical depth from the tangent point ``G(|x|)`` is piecewise linear, so
    the sampled depth ``tau_s`` inverts it exactly.

    ``p``/``d`` [B, 3] (``d`` unit), ``t_max`` [B] flight cap, ``radii``
    [L+1], ``sigma`` [L], ``tau_s`` [B]. Returns ``(collide [B] bool,
    t_col [B], layer [B] int32)`` with ``t_col <= t_max``.
    """
    L = sigma.shape[0]
    x0 = dot3(p, d)
    b2 = cross_norm2(p, d)
    X = sqrt_rn(torch.clamp((radii * radii)[:, None] - b2, min=0.0))  # [L+1, B]
    G = _prefix_levels(sigma[:, None] * (X[1:] - X[:-1]))  # [L+1, B]

    def at(table, k):
        return table.gather(0, k[None])[0]

    def bracket(table, y):
        # last level <= y (ties to the last equal level), clipped to a shell
        return torch.clamp((table <= y).sum(0) - 1, 0, L - 1)

    def G_at(y):
        k = bracket(X, y)
        return at(G, k) + sigma[k] * torch.clamp(y - at(X, k), min=0.0)

    def G_inv(v):
        k = bracket(G, v)
        return at(X, k) + (v - at(G, k)) / torch.clamp(sigma[k], min=1e-30), k

    desc = x0 < 0.0
    A = G_at(torch.abs(x0))  # depth from the tangent point to the start
    x_max = x0 + t_max
    Gm = G_at(torch.abs(x_max))
    tau_max = torch.where(desc, torch.where(x_max < 0.0, A - Gm, A + Gm), Gm - A)
    collide = tau_s < torch.clamp(tau_max, min=0.0)

    # descending lanes spend up to A before the tangent, then continue on
    # the ascending leg; ascending lanes invert directly
    on_desc = desc & (tau_s < A)
    v = torch.where(on_desc, A - tau_s, torch.where(desc, tau_s - A, A + tau_s))
    y, layer = G_inv(v)
    x_col = torch.where(on_desc, -y, y)
    t_col = torch.minimum(torch.clamp(x_col - x0, min=0.0), t_max)
    return collide, t_col, layer.to(torch.int32)


def shell_event_plain(p, d, t_max, radii, sigma, tau_s, w_sun):
    """Free flight, then the exact slant optical depth toward ``w_sun`` [3]
    from the event point ``p + d t`` (``t = t_col`` on a collision, else
    ``t_max``; one fused multiply-add per component, as XLA:CPU forms it):
    the XLA branch of the reference's ``shell_event``.

    Returns ``(collide, t_col, layer, tau_sun)``.
    """
    collide, t_col, layer = shell_flight_plain(p, d, t_max, radii, sigma, tau_s)
    t_step = torch.where(collide, t_col, t_max)
    p_new = fma(d, t_step[:, None], p)
    return collide, t_col, layer, slant_tau_exact(p_new, w_sun, radii, sigma)


def shell_depths_plain(p, d, t_col, layer, t_max, radii, v):
    """Path integrals of a per-shell quantity ``v`` [L] along ``p + s d``
    over ``s`` in ``[0, t_col]`` and in ``[0, t_max]``: the plain version of
    the shell-depth kernel (``csrc/shell_flight.cu`` ``shell_depths``).

    Launched on an extinction ``sigma`` these are optical depths; they are
    linear in ``v``, so launched on a tangent of ``sigma`` they are the
    tangents of the attached path depths of the likelihood-ratio flight
    (reference ``_shell_flight_xla`` with ``sigma_attached``: ``tau_path_att``
    and ``tau_max_att``), at the geometry the detached flight sampled:
    ``t_col`` and ``layer`` [B] int32 are that flight's. The prefix ``G`` of
    ``v`` over the levels and its evaluation at ``|x|`` are
    :func:`shell_flight_plain`'s (the coordinate x from the ray's closest
    approach to the centre; float32 sums in float64 rounded at each level,
    float64 the reference's bfloat16 halves). The collision's end is
    evaluated in the flight's ``layer``, as the reference evaluates it at
    the flight's own coordinate: ``|x0 + t_col|`` may round an ulp into the
    shell below, where the bracket would read the prefix of the level
    (the halves' sum, ~2^-17 of a shell's depth off in float64) for the
    shell's exact depth. Returns ``(depth_col [B], depth_max [B])``.
    """
    L = v.shape[0]
    x0 = dot3(p, d)
    b2 = cross_norm2(p, d)
    X = sqrt_rn(torch.clamp((radii * radii)[:, None] - b2, min=0.0))  # [L+1, B]
    G = _prefix_levels(v[:, None] * (X[1:] - X[:-1]))  # [L+1, B]

    def G_at(y, k=None):
        if k is None:
            k = torch.clamp((X <= y).sum(0) - 1, 0, L - 1)
        Xk = X.gather(0, k[None])[0]
        return G.gather(0, k[None])[0] + v[k] * torch.clamp(y - Xk, min=0.0)

    desc = x0 < 0.0
    A = G_at(torch.abs(x0))

    def depth(t, k=None):
        x1 = x0 + t
        G1 = G_at(torch.abs(x1), k)
        return torch.where(desc, torch.where(x1 < 0.0, A - G1, A + G1), G1 - A)

    return depth(t_col, torch.clamp(layer.long(), 0, L - 1)), depth(t_max)


# -- sun slant-tau table ------------------------------------------------------


def slant_path_matrix(radii, r0_grid, mu_grid, r_ground=None):
    """Path-length matrix ``D[i, j, k]`` inside shell k from radius
    ``r0_grid[i]`` at local cosine ``mu_grid[j]`` to the top of the shells
    (reference ``slant_path_matrix``, float32 tensors).

    Returns ``(D [I, J, L], blocked [I, J])``: descending rays whose tangent
    radius lies strictly below ``r_ground`` (default ``radii[0]``) are
    blocked.
    """
    r_ground = radii[0] if r_ground is None else r_ground
    r0 = r0_grid[:, None]  # [I, 1]
    mu = mu_grid[None, :]  # [1, J]
    sin2 = torch.clamp(1.0 - mu * mu, 0.0, 1.0)
    b2 = (r0 * r0) * sin2  # [I, J]
    b = sqrt_rn(b2)
    descending = mu < 0.0
    blocked = descending & (b < r_ground)

    D = _shell_paths(
        b2[..., None], b[..., None], r0[..., None], radii[:-1], radii[1:],
        descending[..., None],
    )
    return D, blocked


def sun_mu_grid_warped(M: int = 128, mu_c: float = -0.12, s: float = 0.08):
    """Horizon-concentrated local-cosine grid with a closed-form inverse
    (reference ``sun_mu_grid_warped``): ``mu(t) = mu_c + s sinh(a + t(b-a))``
    with ``a = asinh((-1-mu_c)/s)``, ``b = asinh((1-mu_c)/s)``.

    Returns ``(mu_grid [M] float64, (mu_c, s, a, b))``.
    """
    a = float(np.arcsinh((-1.0 - mu_c) / s))
    b = float(np.arcsinh((1.0 - mu_c) / s))
    t = np.linspace(0.0, 1.0, M)
    mu = mu_c + s * np.sinh(a + t * (b - a))
    mu[0], mu[-1] = -1.0, 1.0
    return mu, (mu_c, s, a, b)


def sun_tau_table_grid(sigma_t, radii, r0_grid, mu_grid, r_ground=None):
    """Slant optical depth ``tau[s, i, j]`` from radius ``r0_grid[i]`` toward
    the sun at local cosine ``mu_grid[j]`` (reference
    ``sun_tau_table_grid``). Float32 tensors in, float32 out; the
    contraction over shells is taken in float64. Blocked entries hold
    :data:`TAU_BLOCKED`."""
    D, blocked = slant_path_matrix(radii, r0_grid, mu_grid, r_ground)
    tau = torch.einsum("ijl,sl->sij", D.double(), sigma_t.double()).float()
    return torch.where(blocked[None], TAU_BLOCKED, tau)


def sun_tau_fetch_fast(table, r_grid, mu_warp, r, mu):
    """Bilinear sun-tau fetch with arithmetic cell location (reference
    ``sun_tau_fetch_fast``).

    ``table`` [Nr, M] on the uniform radius grid ``r_grid`` [Nr] and the
    :func:`sun_mu_grid_warped` cosine grid with constants ``mu_warp``;
    ``r``, ``mu`` [B]. The radius side is interpolated first, then the
    cosine side, in float32 with exact weights (the reference rounds the
    radius weights to bf16). Ground blockage is not in the table: callers
    apply it.
    """
    Nr, M = table.shape
    mu_c, s, a, b = mu_warp
    r0 = r_grid[0]
    inv_dr = (Nr - 1.0) / (r_grid[-1] - r0)
    fz = torch.clamp((r - r0) * inv_dr, 0.0, Nr - 1.0)
    ir = torch.clamp(fz.to(torch.int64), 0, Nr - 2)
    fr = fz - ir.to(fz.dtype)

    x = (mu - mu_c) * (1.0 / s)
    t = (torch.asinh(x) - a) * (1.0 / (b - a))
    ft = torch.clamp(t * (M - 1.0), 0.0, M - 1.0)
    im = torch.clamp(ft.to(torch.int64), 0, M - 2)
    fm = ft - im.to(ft.dtype)

    flat = table.reshape(-1)
    i00 = ir * M + im

    def rows(i):  # radius-interpolated table value at column offset i
        return (1.0 - fr) * flat[i] + fr * flat[i + M]

    return (1.0 - fm) * rows(i00) + fm * rows(i00 + 1)
