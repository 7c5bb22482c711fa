"""``cos(2*pi*u)`` and ``sin(2*pi*u)`` by quadrant reduction, and the
float32 arithmetic on the uniforms as the jitted reference rounds it.

Port of ``eradiate_tpu/ops/fastmath.py``: the same degree-4 polynomials,
evaluated in the same Horner order, with the same quadrant selects, so
sampled directions agree with the reference to the last few ulps. Works on
torch tensors (the tracers) and numpy arrays (the host code's warps);
float64 input keeps libm accuracy, as in the reference.

The uniforms are float32 in every mode, and the reference keeps float32
arithmetic on them wherever it does not cast them first. In a double mode
those float32 values enter float64 path state, so their last ulp shows at
1e-8 relative in a path's weight. The ``*_xla`` functions and
``cos_sin_2pi(fused=True)`` round them as XLA:CPU does under ``jax.jit``:
a product feeding one sum is a fused multiply-add (:func:`fma32`), square
roots are correctly rounded (:func:`sqrt_rn`), ``log1p`` is XLA's own
float32 expansion (:func:`log1p_neg_xla`) and ``cbrt`` the host libm's
``powf`` that XLA calls for it (:func:`cbrt_xla`). They are built from IEEE
basic operations only, so a CUDA and a CPU tensor give the same bits. The
double modes' tracers call them; the single modes keep the plain forms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "cos_sin_2pi",
    "fma32",
    "sqrt_rn",
    "log1p_neg_xla",
    "cbrt_xla",
    "depth_sample",
    "uniform_cone_xla",
    "cosine_hemisphere_xla",
    "sin_from_cos_xla",
]

_COS_Y = (2.31883391e-05, -1.38555251e-03, 4.16638976e-02,
          -4.99999242e-01, 9.99999979e-01)
_SIN_Y = (2.60838923e-06, -1.98107494e-04, 8.33307983e-03,
          -1.66666597e-01, 9.99999998e-01)

_HALF_PI = math.pi / 2.0


def fma32(a, b, c):
    """``a * b + c`` of float32 tensors (or float32 scalars ``b``, ``c``)
    rounded once to float32, as a fused multiply-add (evaluated in float64,
    where the product is exact)."""

    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (a.double() * wide(b) + wide(c)).float()


def sqrt_rn(x):
    """Correctly rounded float32 square root on every device, as XLA's and
    CUDA's ``sqrtf`` are. torch's vectorised CPU square root is off by one
    ulp for about 0.7% of float32 inputs; the float64 root rounded to
    float32 is correctly rounded (double rounding is innocuous for a square
    root); float64 input keeps its own root."""
    return torch.sqrt(x.double()).to(x.dtype)


def cos_sin_2pi(u, fused=False):
    """(cos(2*pi*u), sin(2*pi*u)) for ``u`` in turns. With ``fused`` each
    Horner step of a float32 tensor is one :func:`fma32`, as XLA:CPU
    contracts the reference's steps."""
    if isinstance(u, torch.Tensor):
        xp = torch
    else:
        xp, u = np, np.asarray(u)
    if u.dtype in (torch.float64, np.float64):
        phi = (2.0 * math.pi) * u
        return xp.cos(phi), xp.sin(phi)
    w = u * 4.0
    q = xp.floor(w)
    x = (w - q) * _HALF_PI
    y = x * x
    if fused:
        c = torch.full_like(y, _COS_Y[0])
        for a in _COS_Y[1:]:
            c = fma32(c, y, np.float32(a))
        s = torch.full_like(y, _SIN_Y[0])
        for a in _SIN_Y[1:]:
            s = fma32(s, y, np.float32(a))
    else:
        c = _COS_Y[0]
        for a in _COS_Y[1:]:
            c = c * y + a
        s = _SIN_Y[0]
        for a in _SIN_Y[1:]:
            s = s * y + a
    s = s * x
    qi = q - 4.0 * xp.floor(q * 0.25)  # q mod 4, exact for f32
    swap = (qi == 1.0) | (qi == 3.0)
    cos_out = xp.where(swap, s, c)
    sin_out = xp.where(swap, c, s)
    neg_c = (qi == 1.0) | (qi == 2.0)
    neg_s = qi >= 2.0
    return (
        xp.where(neg_c, -cos_out, cos_out),
        xp.where(neg_s, -sin_out, sin_out),
    )


# XLA:CPU's float32 log1p (jaxlib 0.9): a Cephes rational for |x| < sqrt(2) - 1,
# Cephes' logf of 1 + x elsewhere; constants as float32, in evaluation order.
_L1P_DEN = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
_L1P_NUM = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.949669, 57.112964,
            20.039553)
_LOGF_P = (0.070376836, -0.1151461, 0.1167699874, -0.12420141, 0.14249323,
           -0.16668057, 0.20000714, -0.24999994, 0.33333331)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106769
_L1P_SMALL = 0.41421356


def log1p_neg_xla(u):
    """``log1p(-u)`` of float32 ``u`` in [0, 1], bit for bit as the jitted
    reference computes ``jnp.log1p(-u)`` (held on every uniform of the
    2^-24 grid by the tests)."""
    f = np.float32
    # small |x|: x + (-x^2 / 2 + x^3 P(x) / Q(x)) with x = -u; both
    # polynomials in Horner form on -u, each step one fused multiply-add
    den = torch.ones_like(u)
    for c in _L1P_DEN:
        den = fma32(-u, den, f(c))
    num = torch.full_like(u, f(_L1P_NUM[0]))
    for c in _L1P_NUM[1:]:
        num = fma32(-u, num, f(c))
    u2 = u * u
    small = (u2 * f(-0.5) + (u2 * -u) * (num / den)) - u
    # elsewhere: Cephes logf(1 - u), mantissa in [sqrt(1/2), sqrt(2))
    a = 1.0 - u
    bits = torch.clamp(a, min=f(1.1754944e-38)).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < f(_SQRTHF)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - low.to(torch.float32)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    z = x * x
    x3 = z * x
    p = [f(c) for c in _LOGF_P]
    q0 = fma32(fma32(x, p[0], p[1]), x, p[2])
    q1 = fma32(fma32(x, p[3], p[4]), x, p[5])
    q2 = fma32(fma32(x, p[6], p[7]), x, p[8])
    poly = fma32(fma32(fma32(q0, x3, q1), x3, q2), x3, e * f(_LOGF_Q1))
    large = fma32(e, f(_LOGF_Q2), (x - z * 0.5) + poly)
    large = torch.where(a > 0.0, large, torch.where(a == 0.0, -math.inf, math.nan))
    return torch.where(u < f(_L1P_SMALL), small, large)


# glibc's powf (the libm XLA:CPU calls for float32 cbrt): log2 of x from a
# 16-entry table of (1/c, log2 c) and a degree-5 polynomial, times y, then
# 2^(y log2 x) from a 32-entry table of 2^(j/32) and a cubic, in float64
_POWF_INVC = tuple(float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0000000000000p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
_POWF_LOGC = tuple(float.fromhex(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
_POWF_A = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2F_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F, 0x3FEF9301D0125B51,
    0x3FEF72B83C7D517B, 0x3FEF54873168B9AA, 0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1,
    0x3FEF06FE0A31B715, 0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429, 0x3FEEA47EB03A5585,
    0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74, 0x3FEEA11473EB0187, 0x3FEEA589994CCE13,
    0x3FEEACE5422AA0DB, 0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C, 0x3FEF3720DCEF9069,
    0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F, 0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2F_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")  # 1.5 * 2^52 / 32
_EXP2F_SHIFT_BITS = 0x42E8000000000000


#: The tables of :func:`_powf_pos` by device, made once (a tensor made from
#: a list on the card is a synchronous copy).
_POWF_TABLES = {}


def _powf_tables(device):
    if device not in _POWF_TABLES:
        _POWF_TABLES[device] = tuple(
            torch.tensor(v, dtype=dt, device=device)
            for v, dt in ((_POWF_INVC, torch.float64), (_POWF_LOGC, torch.float64),
                          (_EXP2F_TAB, torch.int64))
        )
    return _POWF_TABLES[device]


def _powf_pos(x, y):
    """glibc ``powf(x, y)`` for normal float32 ``x > 0`` and a float32
    scalar ``y`` with ``y log2 x`` in range, bit for bit: every step is a
    float64 or an integer operation."""
    invc, logc, exp2_tab = _powf_tables(x.device)

    ix = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = top >> 23  # glibc's (int32_t) top >> 23: bits 23-31, signed
    k = torch.where(k >= 256, k - 512, k)
    z = (ix - top).to(torch.int32).view(torch.float32).double()
    r = z * invc[i] - 1.0
    y0 = logc[i] + k.double()
    a = _POWF_A
    r2 = r * r
    q = (a[2] * r + a[3]) * r2 + (a[4] * r + y0)
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    xd = float(y) * logx
    kd = xd + _EXP2F_SHIFT
    kk = kd.view(torch.int64) - _EXP2F_SHIFT_BITS  # round(32 xd)
    rr = xd - (kd - _EXP2F_SHIFT)
    s = (exp2_tab[kk & 31] + (kk << 47)).view(torch.float64)
    c = _EXP2F_C
    return (((c[0] * rr + c[1]) * (rr * rr) + (c[2] * rr + 1.0)) * s).float()


def cbrt_xla(t):
    """``jnp.cbrt`` of float32 ``t`` as XLA:CPU computes it,
    ``copysign(powf(|t|, float32(1/3)), t)``, for ``|t|`` zero or in
    [2^-126, 1] (held on every ``2u - 1`` of the uniforms' grid by the
    tests)."""
    a = torch.abs(t)
    zero = a == 0.0
    root = _powf_pos(torch.where(zero, 1.0, a), np.float32(1.0 / 3.0))
    return torch.copysign(torch.where(zero, 0.0, root), t)


def depth_sample(u, exact=False):
    """The sampled optical depth ``-log1p(-u)`` of uniforms ``u``: with
    ``exact`` and float32 ``u``, XLA's rounding (:func:`log1p_neg_xla`)."""
    if exact and u.dtype == torch.float32:
        return -log1p_neg_xla(u)
    return -torch.log1p(-u)


def sin_from_cos_xla(c):
    """``sqrt(clip(1 - c * c, 0, 1))`` of float32 ``c``, as XLA:CPU rounds
    it (one fused multiply-add, a correctly rounded root)."""
    return sqrt_rn(torch.clamp(fma32(-c, c, 1.0), 0.0, 1.0))


def _disk_concentric_xla(sample):
    """Shirley-Chiu concentric disk point of float32 ``sample`` [..., 2]
    (``core.warp.square_to_uniform_disk_concentric``; its other float32
    steps are exact or correctly rounded as they stand)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = torch.abs(x) > torch.abs(y)
    r = torch.where(quadrant_x, x, y)
    ratio = torch.where(
        quadrant_x,
        torch.where(x != 0.0, y / torch.where(x == 0.0, 1.0, x), 0.0),
        torch.where(y != 0.0, x / torch.where(y == 0.0, 1.0, y), 0.0),
    )
    u_phi = torch.where(quadrant_x, 0.125 * ratio, 0.25 - 0.125 * ratio)
    r = torch.where(is_zero, 0.0, r)
    cp, sp = cos_sin_2pi(u_phi, fused=True)
    return r * cp, r * sp


def cosine_hemisphere_xla(sample):
    """Cosine-weighted hemisphere directions of float32 ``sample`` [..., 2]
    (``core.warp.square_to_cosine_hemisphere``) as the jitted reference
    rounds them."""
    p0, p1 = _disk_concentric_xla(sample)
    z = sqrt_rn(torch.clamp(fma32(-p1, p1, fma32(-p0, p0, 1.0)), 0.0, 1.0))
    return torch.stack([p0, p1, z], dim=-1)


def uniform_cone_xla(sample, cos_cutoff):
    """Uniform directions in the cone ``cos_cutoff`` around +z
    (``core.warp.square_to_uniform_cone``) for float32 ``sample`` [..., 2]
    and a float64 ``cos_cutoff``: the azimuth's polynomials fused as the
    jitted reference's."""
    u0 = sample[..., 0]
    # a 0-d float64 tensor does not promote a float32 one in torch, as a
    # float64 array does in JAX: cast first
    cos_theta = (1.0 - u0).to(cos_cutoff.dtype) + u0.to(cos_cutoff.dtype) * cos_cutoff
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    cp, sp = cos_sin_2pi(sample[..., 1], fused=True)
    return torch.stack([sin_theta * cp, sin_theta * sp, cos_theta], dim=-1)
