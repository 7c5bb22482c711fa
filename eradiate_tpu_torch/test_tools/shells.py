"""The slant-depth sum as the CUDA kernel orders it, and points that stress
it, for the tests and the smoke script.

:func:`slant_tau_shared` emulates the device function ``slant_tau`` of
``csrc/shell_flight.cu`` in PyTorch, in the kernel's order: each lane starts
at the first shell its path crosses (:func:`first_shells`), a warp of 32
lanes loops from the least start of its lanes, the root at a shell's upper
radius is carried to the next shell as the root at its lower one (its
radicand clamped to 2^-100, which changes no root a term reads), a root is reused only where the endpoint compares equal to the
radius it was taken of, and each shell's term is one up segment plus the down one (the same
segment below the point's shell, the twin's partial segment in it, nothing
above), summed in float64 in level order. It must equal
:func:`~eradiate_tpu_torch.ops.spherical.slant_tau_exact` bit for bit. (The
kernel divides with the IEEE division's fast path, ``div_rn``; the card's
checks hold it to the IEEE division on :func:`division_operands`.)

:func:`stress_points` places points where that equality is hardest to keep
(on shell radii, with tangent radii on shell radii and at the ground, with
``b`` above ``r`` by rounding, ``p.w = +-0``, above the top radius).
:func:`crossed_segments` counts the distinct segments of each lane's path,
the work any implementation of the sum has to do. Radii are ascending.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spherical import TAU_BLOCKED, _seg, cross_norm2, dot3, sqrt_rn

__all__ = [
    "WARP",
    "AXIS_W",
    "first_shells",
    "loop_starts",
    "slant_tau_shared",
    "crossed_segments",
    "stress_points",
    "stress_columns",
    "division_operands",
]

#: Lanes that loop in step on the card.
WARP = 32

#: A direction along the x axis: tangent radii and ``p.w`` come out exact.
AXIS_W = np.array([1.0, 0.0, 0.0], np.float32)


def _geometry(p, w):
    """The kernel's per-lane scalars ``(r, descending, b2, b)``."""
    r = sqrt_rn(dot3(p, p))
    mu = dot3(p, w) / torch.clamp(r, min=1e-12)
    b2 = cross_norm2(p, w)
    return r, mu < 0.0, b2, sqrt_rn(b2)


def _first_shell_above(radii, x):
    """The first shell whose upper radius exceeds ``x`` (L if none)."""
    return torch.searchsorted(radii[1:].contiguous(), x.contiguous(), right=True)


def first_shells(p, w, radii):
    """Per lane: ``(l0, l_r, blocked)``. ``l0`` is the first shell the path
    crosses (the first upper radius above ``b`` descending, above
    ``max(r, b)`` ascending; L for a path that crosses none), ``l_r`` the
    shell holding a descending lane's point (-1 ascending) and ``blocked``
    the lanes in the ground's shadow."""
    r, descending, _, b = _geometry(p, w)
    c = torch.where(descending, b, torch.maximum(r, b))
    l0 = _first_shell_above(radii, c)
    l_r = torch.where(descending, _first_shell_above(radii, r), -1)
    return l0, l_r, descending & (b < radii[0])


def loop_starts(l0, loops, L, warp=WARP):
    """The shell each lane's warp starts its loop at: the least ``l0`` of the
    warp's lanes that loop (``loops``), ``L`` where none of them does."""
    B = l0.shape[0]
    pad = (-B) % warp
    big = torch.iinfo(torch.int64).max
    x = torch.where(loops, l0, big)
    x = torch.cat([x, x.new_full((pad,), big)]).view(-1, warp)
    start = x.min(dim=1).values.repeat_interleave(warp)[:B]
    return torch.where(start == big, L, start)


def _square(x):
    """``x^2`` in float64, exact for float32 ``x``."""
    return x.double() * x.double()


def _root(x2, b2):
    """``sqrt(max(x^2 - b2, 0))`` from ``x^2`` in float64, rounded once."""
    return sqrt_rn(torch.clamp((x2 - b2.double()).float(), min=0.0))


def _loop_root(x2, b2):
    """:func:`_root` with the radicand clamped to 2^-100, as the kernel's
    loop takes it: the same value on a lane's own shells."""
    return sqrt_rn(torch.clamp((x2 - b2.double()).float(), min=2.0**-100))


def slant_tau_shared(p, w, radii, sigma, same=torch.eq):
    """The kernel's slant optical depth from ``p`` [B, 3] toward ``w`` [3]
    (module docstring). ``same(x, y)`` decides where the root at ``y`` stands
    for the root at ``x``; the kernel's rule is equality."""
    L = sigma.shape[0]
    r, descending, b2, b = _geometry(p, w)
    l0, l_r, blocked = first_shells(p, w, radii)
    loops = ~blocked & (l0 < L)
    start = loop_starts(l0, loops, L)
    c = torch.where(descending, b, torch.maximum(r, b))
    f_c = _root(_square(c), b2)
    # the twin's partial down segment in the point's shell
    k = torch.clamp(l_r, 0, L - 1)
    des_hi = torch.minimum(radii[k + 1], r)
    down_r = _seg(b2, torch.minimum(torch.maximum(radii[k], b), des_hi), des_hi)

    r2 = _square(radii)
    acc = torch.zeros(p.shape[0], dtype=torch.float64)
    f_lo = torch.zeros_like(b)
    for l in range(L):
        lo, hi = radii[l], radii[l + 1]
        f_lo = torch.where(start == l, _loop_root(r2[l], b2), f_lo)
        f_hi = _loop_root(r2[l + 1], b2)
        a = torch.minimum(torch.maximum(lo, c), hi)
        f_a = torch.where(same(a, c), f_c, torch.where(same(a, lo), f_lo, f_hi))
        empty = a == hi  # below the lane's first shell: the term is +0
        q = torch.where(empty, 1.0, (hi - a) * (hi + a)) / torch.where(empty, 1.0, f_a + f_hi)
        up = torch.where(empty, 0.0, q)
        down = torch.where(l < l_r, up, torch.where(l == l_r, down_r, 0.0))
        term = ((down + up) * sigma[l]).double()
        acc = torch.where(loops & (l >= start), acc + term, acc)
        f_lo = f_hi
    tau = torch.where(loops, acc.float(), 0.0)
    return torch.where(blocked, TAU_BLOCKED, tau)


def crossed_segments(p, w, radii):
    """Distinct segments of each lane's path: the shells from ``l0`` to the
    top, plus one where a descending lane's point lies strictly inside a
    shell above its tangent (the partial segment down to the tangent); 0 in
    the ground's shadow. What any implementation of the sum has to form."""
    L = radii.shape[0] - 1
    r, descending, _, b = _geometry(p, w)
    l0, l_r, blocked = first_shells(p, w, radii)
    k = torch.clamp(l_r, 0, L - 1)
    partial = descending & (l_r < L) & (radii[k] < r) & (b < r)
    n = (L - l0) + partial.long()
    return torch.where(blocked, 0, n)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def stress_points(rng, radii, w, n):
    """``n`` points [n, 3] float32 for the direction ``w`` [3], in equal
    parts:

    - on shell radii along the coordinate axes (``r`` exact), and on random
      directions at the radii (``r`` within an ulp of them);
    - tangent radii on shell radii, exactly at the ground and one ulp either
      side of it (exact with :data:`AXIS_W`; within an ulp otherwise),
      ascending and descending;
    - points at right angles to ``w`` and a metre either side (``b`` at or a
      hair above ``r``), and near-radial rays, up and down;
    - ``p.w`` exactly +0 and -0 (with :data:`AXIS_W`: points in the y-z
      plane, the -0 ones with every component negative or -0);
    - above the top radius, by an ulp to 10 km, ascending and descending.
    """
    radii = np.asarray(radii, np.float32)
    w = np.asarray(w, np.float32)
    L = radii.size - 1
    top = float(radii[-1])
    m = -(-n // 5)
    wd = _unit(w.astype(np.float64))
    u = _unit(np.cross(wd, [0.0, 0.0, 1.0]) if abs(wd[2]) < 0.9 else np.cross(wd, [1.0, 0.0, 0.0]))
    v = np.cross(wd, u)

    # on radii
    k = rng.integers(0, L + 1, m)
    axes = np.eye(3)[rng.integers(0, 3, m)] * rng.choice([-1.0, 1.0], (m, 1))
    on_axes = axes * radii[k][:, None]
    on_rand = _unit(rng.normal(size=(m, 3))) * radii[k][:, None]
    on = np.where((np.arange(m) % 2 == 0)[:, None], on_axes, on_rand)

    # tangents on radii: p = s w + t u, b = t
    t = radii[rng.integers(0, L + 1, m)].astype(np.float64)
    ground = np.array([np.nextafter(radii[0], np.float32(0)), radii[0],
                       np.nextafter(radii[0], np.float32(np.inf))], np.float32)
    t[: m // 4] = ground[np.arange(m // 4) % 3]
    t = t.astype(np.float32)
    reach = np.sqrt(np.maximum(top**2 - t.astype(np.float64) ** 2, 0.0))
    s = rng.uniform(-1.0, 1.0, m) * reach
    s[::5] = 0.0  # at the tangent point itself
    tan = s[:, None] * wd + t[:, None].astype(np.float64) * u

    # at right angles to w, and near-radial
    rr = rng.uniform(radii[0], top, m)
    ang = rng.uniform(0, 2 * np.pi, m)
    perp = (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v) * rr[:, None]
    perp += rng.choice([-1e-3, 0.0, 1e-3], m)[:, None] * wd  # p.w a hair either side of 0
    sign = rng.choice([-1.0, 1.0], (m, 1))
    radial = _unit(sign * wd + 1e-4 * rng.normal(size=(m, 3))) * rr[:, None]
    right = np.where((np.arange(m) % 3 == 2)[:, None], radial, perp)

    # p.w = +-0 (exact with AXIS_W)
    yz = np.stack([np.zeros(m), *(_unit(rng.normal(size=(m, 2))).T)], 1) * rr[:, None]
    neg = np.arange(m) % 2 == 1
    yz[neg] = -np.abs(yz[neg])
    yz[neg, 0] = -0.0

    # above the top
    above = _unit(rng.normal(size=(m, 3))) * (top + rng.uniform(0.0, 10.0, m))[:, None]
    above[::4] = np.eye(3)[rng.integers(0, 3, len(above[::4]))] * np.nextafter(
        np.float32(top), np.float32(np.inf))

    out = np.concatenate([on, tan, right, yz, above])[:n].astype(np.float32)
    return np.ascontiguousarray(out)


def stress_columns(rng):
    """Three columns ``(radii, sigma)`` float32, names as keys: 232 shells of
    uneven widths (20 m to 0.9 km, an exponential profile), the same with
    vacuum shells (every third and a run of ten), and 1200 shells of 0.1 km
    (the unmerged column's count)."""
    widths = rng.uniform(0.02, 0.9, 232)
    radii = (6378.1 + np.concatenate([[0.0], np.cumsum(widths)])).astype(np.float32)
    z = radii[:-1] - radii[0]
    sigma = (np.exp(-z / 8.0) * 1e-2 * rng.uniform(0.5, 1.5, 232)).astype(np.float32)
    vac = sigma.copy()
    vac[::3] = 0.0
    vac[100:110] = 0.0
    radii_u = (6378.1 + 0.1 * np.arange(1201)).astype(np.float32)
    sigma_u = (np.exp(-(radii_u[:-1] - radii_u[0]) / 8.0) * 1e-2).astype(np.float32)
    return {
        "232 shells": (radii, sigma),
        "232 shells, vacuum": (radii, vac),
        "1200 shells": (radii_u, sigma_u),
    }


def division_operands(rng, n_random=2**22):
    """Operand pairs ``(n, d)`` float32 for the slant loop's division: every
    divisor significand in [1, 2) against four numerators drawn in [1, 2)
    (the fast path's errors do not depend on the exponents inside its
    range); ``n_random`` pairs with exponents drawn in [-60, 60], inside the
    range [2^-50, 2^50] and beyond it; and the range's edges."""
    d_all = (np.arange(2**23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32)
    n_all = rng.uniform(1.0, 2.0, 4).astype(np.float32)
    sig = rng.uniform(1.0, 2.0, (2, n_random))
    exp = rng.integers(-60, 61, (2, n_random))
    n_rand, d_rand = (sig * np.exp2(exp)).astype(np.float32)
    edge = np.float32([2.0**-50, 2.0**50, np.nextafter(np.float32(2.0**-50), np.float32(0)),
                       np.nextafter(np.float32(2.0**50), np.float32(np.inf)), 1.0, 3.0])
    n_edge, d_edge = (a.ravel() for a in np.meshgrid(edge, edge))
    n = np.concatenate([np.repeat(n_all, d_all.size), n_rand, n_edge])
    d = np.concatenate([np.tile(d_all, n_all.size), d_rand, d_edge])
    return n, d
