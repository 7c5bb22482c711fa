"""The slant-depth sum as the CUDA kernel orders it, and points that stress
it, for the tests and the smoke script.

:func:`slant_tau_shared` emulates the device functions ``slant_tau`` and
``slant_tau64`` (its float64 build) of ``csrc/shell_flight.cu`` in PyTorch,
in the dtype of the points and in the kernels' order: each lane starts at
the first shell its path crosses (:func:`first_shells`), a warp of 32 lanes
loops from the least start of its lanes, the root at a shell's upper radius
is carried to the next shell as the root at its lower one (its radicand
clamped to 2^-100 in float32, which changes no root a term reads; exact in
float64), a root is reused only where the endpoint compares equal to the
radius it was taken of, and each shell's term is one up segment plus the
down one (the same segment below the point's shell, the twin's partial
segment in it, nothing above), summed in float64 in level order. It must
equal :func:`~eradiate_tpu_torch.ops.spherical.slant_tau_exact` bit for bit.
(The kernel divides with the IEEE division's fast path, ``div_rn``; the
card's checks hold it to the IEEE division on :func:`division_operands`.)

:func:`stress_points` places points where that equality is hardest to keep
(on shell radii, with tangent radii on shell radii and at the ground, with
``b`` above ``r`` by rounding, ``p.w = +-0``, above the top radius).
:func:`crossed_segments` counts the distinct segments of each lane's path,
the work any implementation of the sum has to do. Radii are ascending.

:func:`shell_flight_checkpointed` emulates the device functions
``shell_flight_lane`` and ``shell_flight_lane64`` the same way (a float64
checkpoint holds the two running sums of the bfloat16 halves): one sweep
from level 0 to the bracket of the larger of ``|x0|`` and ``|x_max|``,
taking the smaller one's bracket on its way and keeping the float64 prefix
of every ``stride``-th level, then the inversion of G resumed from the
sweep's stop or from the last checkpoint with G <= v (the kernel's binary
search), and a walk forward. It must equal
:func:`~eradiate_tpu_torch.ops.spherical.shell_flight_plain` bit for bit
whatever the stride, and returns a trace of what each lane did, from which
:func:`flight_levels` (the levels any implementation has to read) and
:func:`parent_visits` (what the two sweeps before it visited) are read.
:func:`flight_columns` and :func:`flight_stress_inputs` make the flight's
stresses (the stress generators also in float64, each tie and ulp then a
float64 one). :func:`planet_inputs` makes float64 lanes on a planet of 1e6
km, for the float64 builds: there float32 cannot tell 0.1 km shells apart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spherical import (TAU_BLOCKED, _prefix_levels, _seg, bf16_split, cross_norm2,
                             dot3, sqrt_rn)

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
    "shell_flight_checkpointed",
    "flight_levels",
    "parent_visits",
    "warp_max",
    "flight_columns",
    "flight_stress_inputs",
    "planet_inputs",
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
    """``x^2`` in float64: exact for float32 ``x``, ``fl(x * x)`` for float64
    ``x`` (as the twin rounds ``r * r``)."""
    return x.double() * x.double()


def _root(x2, b2):
    """``sqrt(max(x^2 - b2, 0))`` from ``x^2`` in float64, the radicand
    rounded once to ``b2``'s dtype."""
    return sqrt_rn(torch.clamp((x2 - b2.double()).to(b2.dtype), min=0.0))


def _loop_root(x2, b2):
    """:func:`_root` as the kernel's loop takes it: in float32 with the
    radicand clamped to 2^-100, which changes no root of a lane's own shells;
    in float64 exact (the kernel's ``root64``)."""
    if b2.dtype == torch.float64:
        return _root(x2, b2)
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
        # below the lane's first shell (a == hi) the term is +0; so is it
        # where the twin's quotient has no denominator (never in float32,
        # whose loop roots are at least 2^-50)
        den = f_a + f_hi
        term = (a != hi) & (den > 0.0)
        q = torch.where(term, (hi - a) * (hi + a), 1.0) / torch.where(
            term, torch.clamp(den, min=1e-30), 1.0)
        up = torch.where(term, q, 0.0)
        down = torch.where(l < l_r, up, torch.where(l == l_r, down_r, 0.0))
        acc = torch.where(loops & (l >= start), acc + ((down + up) * sigma[l]).double(), acc)
        f_lo = f_hi
    tau = torch.where(loops, acc.to(p.dtype), 0.0)
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


def stress_points(rng, radii, w, n, dtype=np.float32):
    """``n`` points [n, 3] of ``dtype`` (float32, or float64 for the float64
    builds, each ulp then a float64 one) for the direction ``w`` [3], in
    equal parts:

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
    dtype = np.dtype(dtype).type
    radii = np.asarray(radii, dtype)
    w = np.asarray(w, dtype)
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
    ground = np.array([np.nextafter(radii[0], dtype(0)), radii[0],
                       np.nextafter(radii[0], dtype(np.inf))], dtype)
    t[: m // 4] = ground[np.arange(m // 4) % 3]
    t = t.astype(dtype)
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
        dtype(top), dtype(np.inf))

    out = np.concatenate([on, tan, right, yz, above])[:n].astype(dtype)
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



# -- the shell free flight ------------------------------------------------


def _flight_root(r2, b2):
    """The kernels' ``flight_root`` (float32) and ``root64`` (float64):
    ``sqrt(max(r2 - b2, 0))``, +0 selected where the radicand is <= 0; in
    float32 the root is taken of the radicand clamped to 2^-100."""
    rad = r2 - b2
    floor = 2.0**-100 if rad.dtype == torch.float32 else 0.0
    return torch.where(rad > 0.0, sqrt_rn(torch.clamp(rad, min=floor)), 0.0)


def _prefix_add(acc, c):
    """The flight's prefix ``acc`` [n, B] float64 after adding ``c`` [B]:
    float32 ``c`` to one running sum (n = 1); float64 ``c`` split into its
    bfloat16 halves, each added to its own running sum (n = 2), the
    reference's x64 prefix (``ops.spherical._prefix_levels``)."""
    if c.dtype == torch.float64:
        return acc + torch.stack(bf16_split(c))
    return acc + c.double()[None]


def _prefix_value(acc, dtype):
    """G of the prefix ``acc`` [n, B]: the running sum rounded to float32,
    or the two float64 sums added."""
    return acc[0] + acc[1] if dtype == torch.float64 else acc[0].float()


def _tangent_levels(r2, b2, L):
    """The last level k <= L - 1 with ``fl(r_k^2) <= b2``, 0 if none."""
    return torch.clamp(torch.searchsorted(r2[:L].contiguous(), b2.contiguous(), right=True) - 1,
                       min=0)


def warp_max(x, warp=WARP):
    """The largest value of ``x`` [B] in each warp of ``warp`` consecutive
    lanes (the last warp ragged): [ceil(B / warp)]."""
    pad = (-x.shape[0]) % warp
    low = torch.iinfo(x.dtype).min if not x.is_floating_point() else -torch.inf
    return torch.cat([x, x.new_full((pad,), low)]).view(-1, warp).amax(1)


def shell_flight_checkpointed(p, d, t_max, radii, sigma, tau_s, stride, overshoot=0):
    """The kernels' shell free flight in their order (module docstring), in
    the dtype of the lanes, with a checkpoint of the prefix every ``stride``
    levels: float32 lanes (``shell_flight_lane``) keep one float64 running
    sum, float64 lanes (``shell_flight_lane64``) the two float64 running sums
    of the bfloat16 halves. ``overshoot`` > 0 is a mutation: the resume from
    a checkpoint then starts that many levels above it (with their exact
    prefix), as a kernel that skipped the first test of its walk would.
    Returns ``(collide, t_col, layer, trace)``; ``trace`` holds per lane
    (int64 unless said): ``tangent`` (the lane's tangent level: the last
    level with X = 0, else 0), ``ka``, ``km``, ``kv`` (the brackets of |x0|,
    |x_max| and the inversion), ``end`` (the level the sweep stopped at: the
    larger query's bracket), ``resume`` (where the inversion resumed),
    ``at_end`` (bool: it resumed from the sweep's stop), ``sweep`` and
    ``walk`` (the passes of each loop's body, each reading one level), and,
    in the lanes' dtype, ``A`` (the depth from the tangent point to the
    start), ``tau_max`` and ``v`` (the depth the inversion looks up)."""
    L = sigma.shape[0]
    B = p.shape[0]
    dtype = p.dtype
    lanes = torch.arange(B, device=p.device)
    x0 = dot3(p, d)
    b2 = cross_norm2(p, d)
    ya = torch.abs(x0)
    x_max = x0 + t_max
    ym = torch.abs(x_max)
    r2 = radii * radii

    def G(acc):
        return _prefix_value(acc, dtype)

    def step(acc, k, X, Xn):
        return _prefix_add(acc, sigma[k] * (Xn - X))

    # the sweep, to the last level <= the larger query (its bracket), taking
    # the smaller query's bracket on its way
    a_lo = ya <= ym
    y_lo, y_hi = torch.where(a_lo, ya, ym), torch.where(a_lo, ym, ya)
    k = torch.zeros(B, dtype=torch.int64, device=p.device)
    X = _flight_root(r2[k], b2)
    acc = torch.zeros(2 if dtype == torch.float64 else 1, B, dtype=torch.float64,
                      device=p.device)
    k_lo = torch.zeros_like(k)
    acc_lo, X_lo = acc.clone(), X.clone()
    n_ck = -(-L // stride)
    ck = torch.full((n_ck, *acc.shape), torch.nan, dtype=torch.float64, device=p.device)
    ck[0] = 0.0
    sweep = torch.zeros_like(k)
    alive = X <= y_hi
    while bool(alive.any()):
        store = alive & (k % stride == 0) & (k > 0)
        ck[(k // stride)[store], :, lanes[store]] = acc[:, store].T
        alive = alive & (k + 1 < L)
        up = alive & (X <= y_lo)
        k_lo, acc_lo, X_lo = (torch.where(up, k, k_lo), torch.where(up, acc, acc_lo),
                              torch.where(up, X, X_lo))
        sweep += alive
        kn = torch.clamp(k + 1, max=L - 1)
        Xn = _flight_root(r2[kn], b2)
        alive = alive & (Xn <= y_hi)
        acc = torch.where(alive, step(acc, k, X, Xn), acc)
        X, k = torch.where(alive, Xn, X), torch.where(alive, kn, k)
    up = X <= y_lo
    k_lo, acc_lo, X_lo = torch.where(up, k, k_lo), torch.where(up, acc, acc_lo), torch.where(up, X, X_lo)
    end, acc_end = k.clone(), acc.clone()
    ka, km = torch.where(a_lo, k_lo, k), torch.where(a_lo, k, k_lo)
    acc_a, acc_m = torch.where(a_lo, acc_lo, acc), torch.where(a_lo, acc, acc_lo)
    Xa, Xm = torch.where(a_lo, X_lo, X), torch.where(a_lo, X, X_lo)
    A = G(acc_a) + sigma[ka] * torch.clamp(ya - Xa, min=0.0)
    Gm = G(acc_m) + sigma[km] * torch.clamp(ym - Xm, min=0.0)
    desc = x0 < 0.0
    tau_max = torch.where(desc, torch.where(x_max < 0.0, A - Gm, A + Gm), Gm - A)
    collide = tau_s < torch.clamp(tau_max, min=0.0)
    on_desc = desc & (tau_s < A)
    v = torch.where(on_desc, A - tau_s, torch.where(desc, tau_s - A, A + tau_s))

    # the resume: the sweep's stop where G <= v there, else the last
    # checkpoint below it with G <= v (the kernel's binary search; checkpoint
    # 0 is level 0, where also v < 0 or NaN resume)
    at_end = G(acc_end) <= v
    c_lo = torch.ones_like(end)
    lo, hi = c_lo.clone(), torch.div(end - 1, stride, rounding_mode="trunc") + 1
    while True:
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) // 2
        up = act & (G(ck[torch.clamp(mid, 0, n_ck - 1), :, lanes].T) <= v)
        lo, hi = torch.where(up, mid + 1, lo), torch.where(act & ~up, mid, hi)
    c = lo - 1
    k = c * stride
    acc = ck[c, :, lanes].T
    for _ in range(overshoot):
        over = (c > 0) & ~at_end & (k + 1 < L)
        kn = torch.clamp(k + 1, max=L - 1)
        nxt = step(acc, k, _flight_root(r2[k], b2), _flight_root(r2[kn], b2))
        acc, k = torch.where(over, nxt, acc), torch.where(over, kn, k)
    k = torch.where(at_end, end, k)
    acc = torch.where(at_end, acc_end, acc)
    resume = k.clone()

    # the walk: forward while the next level's G <= v
    X = _flight_root(r2[k], b2)
    walk = torch.zeros_like(k)
    alive = k + 1 < L
    while bool(alive.any()):
        walk += alive
        kn = torch.clamp(k + 1, max=L - 1)
        Xn = _flight_root(r2[kn], b2)
        nxt = step(acc, k, X, Xn)
        ok = alive & (G(nxt) <= v)
        acc, X, k = torch.where(ok, nxt, acc), torch.where(ok, Xn, X), torch.where(ok, kn, k)
        alive = ok & (k + 1 < L)
    y = X + (v - G(acc)) / torch.clamp(sigma[k], min=1e-30)
    x_col = torch.where(on_desc, -y, y)
    t_col = torch.minimum(torch.clamp(x_col - x0, min=0.0), t_max)
    trace = dict(tangent=_tangent_levels(r2, b2, L), ka=ka, km=km, kv=k, end=end, resume=resume,
                 at_end=at_end, sweep=sweep, walk=walk, A=A, tau_max=tau_max, v=v)
    return collide, t_col, k.to(torch.int32), trace


def flight_levels(trace):
    """The levels a lane's flight has to read, whatever implements it: from
    its tangent level (below it X = 0 and G = 0) to the highest of its
    brackets ``ka``, ``km`` and ``kv`` (``trace`` of
    :func:`shell_flight_checkpointed`)."""
    top = torch.maximum(torch.maximum(trace["ka"], trace["km"]), trace["kv"])
    return top - trace["tangent"] + 1


def parent_visits(trace, L):
    """The levels the flight visited before this design, in two sweeps from
    level 0: the first up to the level above both brackets of |x0| and
    |x_max|, the second up to the level above ``kv`` (each capped at L)."""
    top = torch.maximum(trace["ka"], trace["km"])
    return torch.clamp(top + 2, max=L) + torch.clamp(trace["kv"] + 2, max=L)



def flight_columns(rng):
    """The flight's stress columns ``(radii, sigma)`` float32, names as
    keys: the three of :func:`stress_columns`; 229 shells (a prime count:
    no stride but 1 and 229 divides it) with runs of vacuum shells across
    levels 15, 30, 104, 105 and 225 (multiples of the strides 15, 8 and 7)
    and up to the top; its lowest 17 shells with one run of vacuum shells
    across levels 3 to 9 (the kernels' stride there is 2); and one shell
    (stride 1)."""
    cols = dict(stress_columns(rng))
    widths = rng.uniform(0.02, 0.9, 229)
    radii = (6378.1 + np.concatenate([[0.0], np.cumsum(widths)])).astype(np.float32)
    z = radii[:-1] - radii[0]
    sigma = (np.exp(-z / 8.0) * 1e-2 * rng.uniform(0.5, 1.5, 229)).astype(np.float32)
    low = sigma[:17].copy()
    low[3:9] = 0.0
    for a, b in ((12, 19), (27, 33), (100, 112), (140, 152), (220, 229)):
        sigma[a:b] = 0.0
    cols["229 shells, vacuum runs"] = (radii, sigma)
    cols["17 shells, vacuum run"] = (radii[:18].copy(), low)
    cols["1 shell"] = (np.float32([6378.1, 6478.1]), np.float32([1e-2]))
    return cols


def _prefix_table(b2, radii, sigma):
    """The twin's ``G`` [L+1, B] at squared impact parameters ``b2`` [B]: in
    float32 the float64 prefix in level order, float32 at each level; in
    float64 the reference's prefix of bfloat16 halves."""
    X = sqrt_rn(torch.clamp((radii * radii)[:, None] - b2, min=0.0))
    return _prefix_levels(sigma[:, None] * (X[1:] - X[:-1]))


def _nudge(x, ok, want, got):
    """``x`` moved one ulp toward ``want`` where ``got`` missed it (not
    ``ok``)."""
    step = torch.where(got < want, torch.inf, -torch.inf).to(x.dtype)
    return torch.where(ok, x, torch.nextafter(x, step))


def flight_stress_inputs(rng, radii, sigma, n, device="cpu", dtype=np.float32):
    """``(p [n, 3], d [n, 3], t_max [n], tau_s [n])`` of ``dtype`` (float32,
    or float64 for the float64 builds: each tie and ulp then a float64 one)
    on ``device`` for the column ``radii``, ``sigma`` (taken into
    ``dtype``), in six equal parts. Most lanes fly
    along +y from ``p = (a, s, c)``, where ``x0 = s`` and ``b2 =
    fma(a, a, c^2)`` come out exact:

    - ``v`` equal to ``G`` at a level, inside runs of vacuum shells where
      the column has them (flat ``G``, ties to the last equal level) for
      half of them, at a checkpoint level of the strides 7, 8 and the
      kernels' (ceil(L / 16), in float64 ceil(L / 8)) for the others, from
      the tangent point up (``v = tau_s``)
      and on descent (``v = A - tau_s``);
    - random lanes with ``tau_s = 0`` and ``tau_s`` one ulp either side of
      ``tau_max``;
    - ``x0`` exactly +0 and -0, half of them with ``t_max = 0``, and random
      lanes with ``t_max = 0``;
    - ``b2`` equal to ``fl(r_k^2)`` and one ulp either side of it, at the
      tangent point and along the chord, up and down;
    - grazing lanes, tangent in the top shell, half of them turned to a
      random direction;
    - random lanes through the shells (steep, grazing and isotropic), a
      third with the flight cut short (``v`` beyond the sweep's stop).

    ``t_max`` is the tracer's flight cap (``flight_bounds``) unless said."""
    from ..ops.tracer_spherical import flight_bounds

    radii_t = torch.as_tensor(np.asarray(radii, dtype), device=device)
    sigma_t = torch.as_tensor(np.asarray(sigma, dtype), device=device)
    r64 = np.asarray(radii, np.float64)
    L = sigma_t.shape[0]
    m = -(-n // 6)
    y_axis = np.array([0.0, 1.0, 0.0])

    def axis_lanes(a, s, c, sign=1.0):
        p = np.stack([sign * a, s, sign * c], 1)
        return p, np.tile(y_axis, (len(a), 1))

    def chord(a):
        return np.sqrt(np.maximum(r64[-1] ** 2 - np.asarray(a, np.float64) ** 2, 0.0))

    def random_lanes(k):
        r = rng.uniform(r64[0] + 1e-3, r64[-1] - 1e-3, k)
        up = _unit(rng.normal(size=(k, 3)))
        iso = _unit(rng.normal(size=(k, 3)))
        tangent = _unit(np.cross(up, iso))
        kind = np.arange(k) % 3
        d = np.where((kind == 0)[:, None], -up + 0.05 * iso,
                     np.where((kind == 1)[:, None], tangent + 1e-3 * iso, iso))
        return up * r[:, None], _unit(d)

    # 1. v at a level's G: p = (a, 0, 0) up from the tangent point, and
    # p = (a, s, 0) with s < 0 on descent; targets inside vacuum runs first
    a = rng.uniform(r64[0] * 0.999, r64[-1], m)
    s = np.where(np.arange(m) % 2 == 0, 0.0, -rng.uniform(0.1, 1.0, m) * chord(a))
    p1, d1 = axis_lanes(a, s, np.zeros(m))
    # 2. tau_s at 0 and one ulp either side of tau_max
    p2, d2 = random_lanes(m)
    # 3. x0 = +0 and -0 (every component of p <= 0 for -0)
    a = rng.uniform(r64[0], r64[-1], m)
    c = rng.uniform(0.0, 0.2, m) * a
    sign = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
    p3, d3 = axis_lanes(a, np.where(sign > 0, 0.0, -0.0), c, sign)
    p3r, d3r = random_lanes(m)
    third = np.arange(m) % 3 == 2
    p3, d3 = np.where(third[:, None], p3r, p3), np.where(third[:, None], d3r, d3)
    # 4. b2 at fl(r_k^2) and one ulp either side
    k = rng.integers(0, L + 1, m)
    rk = np.asarray(radii, dtype)[k]
    s = np.where(np.arange(m) % 3 == 0, 0.0, rng.uniform(-1.0, 1.0, m) * chord(rk))
    p4, d4 = axis_lanes(rk.astype(np.float64), s, np.zeros(m))
    # 5. grazing in the top shell, half turned
    a = rng.uniform(r64[-2], r64[-1], m)
    s = rng.uniform(-1.0, 1.0, m) * chord(a)
    p5, d5 = axis_lanes(a, s, np.zeros(m))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    turn = np.arange(m) % 2 == 1
    p5[turn], d5[turn] = p5[turn] @ q.T, d5[turn] @ q.T
    # 6. random, a third cut short
    p6, d6 = random_lanes(m)

    p = np.concatenate([p1, p2, p3, p4, p5, p6])[:n]
    d = np.concatenate([d1, d2, d3, d4, d5, d6])[:n]
    kind = np.repeat(np.arange(6), m)[:n]
    p = torch.tensor(p.astype(dtype), device=device)
    d = torch.tensor(d.astype(dtype), device=device)
    kind = torch.tensor(kind, device=device)

    # part 4: move c until b2 = fl(r_k^2) + 0, +1 or -1 ulp
    four = torch.nonzero(kind == 3).flatten()
    if len(four):
        target = (radii_t * radii_t)[torch.tensor(k[: len(four)], device=device)]
        ulp = np.arange(len(four)) % 3 - 1
        target = torch.where(torch.tensor(ulp == 1, device=device),
                             torch.nextafter(target, torch.full_like(target, torch.inf)), target)
        target = torch.where(torch.tensor(ulp == -1, device=device),
                             torch.nextafter(target, torch.zeros_like(target)), target)
        a = p[four, 0].clone()
        a = torch.where(target < a * a, torch.nextafter(a, torch.zeros_like(a)), a)
        c = torch.sqrt(torch.clamp(target.double() - a.double() ** 2, min=0.0)).to(p.dtype)
        for _ in range(8):
            pk = torch.stack([a, p[four, 1], c], 1)
            got = cross_norm2(pk, d[four])
            c = torch.clamp(_nudge(c, got == target, target, got), min=0.0)
        p[four, 0], p[four, 2] = a, c

    t_ground, t_exit = flight_bounds(p, d, radii_t)
    t_max = torch.minimum(t_ground, t_exit)
    t_max = torch.where((kind == 2) & (torch.arange(len(kind), device=device) % 2 == 1),
                        0.0, t_max)
    short = (kind == 5) & (torch.arange(len(kind), device=device) % 3 == 0)
    t_max = torch.where(short, t_max * torch.tensor(rng.uniform(0.05, 0.6, len(kind)).astype(dtype),
                                                     device=device), t_max)
    tau_s = torch.tensor(rng.exponential(0.5, len(kind)).astype(dtype), device=device)

    # part 1: tau_s so that v = G at a target level; part 2: tau_s edges
    _, _, _, tr = shell_flight_checkpointed(p, d, t_max, radii_t, sigma_t, tau_s, L)
    one = torch.nonzero(kind == 0).flatten()
    if len(one):
        G = _prefix_table(cross_norm2(p[one], d[one]), radii_t, sigma_t)  # [L+1, m]
        flat = torch.zeros(L + 1, dtype=torch.bool, device=device)
        flat[1:] = sigma_t == 0.0
        flat[:-1] |= sigma_t == 0.0
        # checkpoint levels of the strides 7, 8 and the kernels'
        level = torch.arange(L + 1, device=device)
        S = -(-L // (8 if dtype == np.float64 else 16))
        ckpt = (level % 7 == 0) | (level % 8 == 0) | (level % S == 0)
        u = torch.tensor(rng.uniform(size=(L + 1, len(one))).astype(dtype), device=device)
        # vacuum levels first for half the lanes, checkpoint levels for the others
        prefer = torch.where((torch.arange(len(one), device=device) % 4 < 2)[None, :],
                             flat[:, None], ckpt[:, None])
        score = torch.where(prefer, u + 1.0, u)
        down = p[one, 1] < 0.0
        # on descent the target must lie in [A / 2, A]: A - G_j is then exact
        A = tr["A"][one]
        reach = (G <= A) & (G >= 0.5 * A) & (G > 0.0)
        score = torch.where(down[None, :] & ~reach, -1.0, score)
        j = score.argmax(0)
        Gj = G.gather(0, j[None])[0]
        tau_s[one] = torch.where(down, A - Gj, Gj)
        for _ in range(4):
            _, _, _, tr = shell_flight_checkpointed(p, d, t_max, radii_t, sigma_t, tau_s, L)
            v = tr["v"][one]
            tau_s[one] = torch.where(down, _nudge(tau_s[one], v == Gj, -Gj, -v),
                                     _nudge(tau_s[one], v == Gj, Gj, v))
    two = torch.nonzero(kind == 1).flatten()
    if len(two):
        tm = tr["tau_max"][two]
        pick = torch.arange(len(two), device=device) % 3
        tau_s[two] = torch.where(pick == 0, 0.0, torch.where(
            pick == 1, torch.nextafter(tm, torch.full_like(tm, torch.inf)),
            torch.nextafter(tm, torch.full_like(tm, -torch.inf))))
    return p.contiguous(), d.contiguous(), t_max.contiguous(), tau_s.contiguous()


def planet_inputs(rng, n, radius=1e6, device="cpu"):
    """Float64 lanes ``(p, d, t_max, tau_s)`` and the column ``(radii,
    sigma)`` of 1200 shells of 0.1 km (an exponential profile with a run of
    vacuum shells) on a planet of ``radius`` km, where float32 resolves no
    shell (its ulp there is 0.06 km): points spread through the shells,
    steep, grazing and isotropic directions, ``t_max`` the tracer's flight
    cap, ``tau_s`` exponential. Returns ``(p, d, t_max, tau_s, radii,
    sigma)`` on ``device``."""
    from ..ops.tracer_spherical import flight_bounds

    radii = radius + 0.1 * np.arange(1201, dtype=np.float64)
    sigma = np.exp(-(radii[:-1] - radius) / 8.0) * 1e-2
    sigma[400:420] = 0.0
    r = rng.uniform(radii[0] + 1e-3, radii[-1] - 1e-3, n)
    up = _unit(rng.normal(size=(n, 3)))
    iso = _unit(rng.normal(size=(n, 3)))
    tangent = _unit(np.cross(up, iso))
    kind = np.arange(n) % 3
    d = np.where((kind == 0)[:, None], -up + 0.05 * iso,
                 np.where((kind == 1)[:, None], tangent + 1e-4 * iso, iso))
    p = torch.tensor(up * r[:, None], device=device)
    d = torch.tensor(_unit(d), device=device)
    radii_t, sigma_t = (torch.tensor(a, device=device) for a in (radii, sigma))
    t_ground, t_exit = flight_bounds(p, d, radii_t)
    tau_s = torch.tensor(rng.exponential(size=n), device=device)
    return p, d, torch.minimum(t_ground, t_exit), tau_s, radii_t, sigma_t
