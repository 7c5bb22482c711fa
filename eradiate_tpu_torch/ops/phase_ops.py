"""Phase function evaluation and sampling, batched over lanes.

Port of ``eradiate_tpu/ops/phase_ops.py`` for the kinds ``rayleigh``,
``hg``, ``isotropic``, ``tab`` and ``tab_polarized`` (the aerosols'
tabulated phase matrix, which only a polarized mode compiles to: its
``values``, ``cdf``, ``tg0`` and ``itg`` are a ``tab`` component's, its
``m12`` .. ``m44`` rows enter :func:`phase_mueller_at`). The reference ``vmap``s its
per-path functions; here every function takes a leading lane axis: blend
weights are ``[B, C]``, fetched layer parameters ``[B]``. A component's own
parameters (one spectral row: ``hg``'s ``g`` [], ``tab``'s ``mu``,
``values``, ``cdf`` [M] and, on a theta-uniform grid, ``tg0`` and ``itg``
[]) are shared by every lane. :func:`tab_phase_tables` and
:func:`theta_grid_params` are the host side (numpy) of ``tab``, which the
scene elements call when they compile.

Conventions: ``cos_theta`` is the cosine between the incident and the
scattered propagation directions; phase functions integrate to 1 over the
sphere [1/sr]; sampling is exact (importance weight 1).
:func:`phase_mueller_at` is the polarized tracers' blend of phase matrices
(the reference's ``tracer_polarized._phase_mueller``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fastmath import cbrt_xla, cos_sin_2pi, sin_from_cos_xla
from .medium import fetch_pairs_at, interp_fetch
from .mueller import depolarizer, matrix4, rayleigh_mueller
from .spherical import fma

__all__ = [
    "ortho_frame",
    "direction_from_cos_u",
    "rayleigh_eval",
    "rayleigh_sample_cos",
    "hg_eval",
    "hg_sample_cos",
    "iso_eval",
    "tab_phase_tables",
    "theta_grid_params",
    "tab_eval",
    "tab_sample_cos",
    "layer_param_slots",
    "rebuild_fetched",
    "phase_eval_at",
    "phase_sample_at",
    "phase_mueller_at",
    "interp",
    "tab_polarized_mueller",
    "check_phase_kinds",
]

_SCALAR_KINDS = ("rayleigh", "hg", "isotropic", "tab")


def check_phase_kinds(phase_kinds, polarized=False):
    """Raise ``NotImplementedError`` for a component kind the calling tracer
    lacks: ``tab_polarized`` only where ``polarized`` (the plane-parallel and
    spherical polarized tracers), any kind the port lacks everywhere."""
    for kind in phase_kinds:
        if kind == "tab_polarized":
            if polarized:
                continue
            raise NotImplementedError(
                "phase kind 'tab_polarized' (tabulated polarized phase matrices, "
                "aerosols) is not ported for this tracer (render it with "
                "render_polarized or render_spherical_polarized)"
            )
        if kind not in _SCALAR_KINDS:
            raise NotImplementedError(
                f"phase kind {kind!r} is not ported yet (supported: "
                f"{', '.join(_SCALAR_KINDS + ('tab_polarized',))})"
            )


def ortho_frame(d):
    """Branchless orthonormal basis around unit vectors ``d`` [..., 3]
    (Duff et al. 2017); returns (t1, t2) with (t1, t2, d) right-handed."""
    d0, d1, z = d[..., 0], d[..., 1], d[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = torch.full_like(z, -1.0) / (sign + z)
    b = d0 * d1 * a
    t1 = torch.stack([1.0 + sign * (d0 * d0) * a, sign * b, -sign * d0], dim=-1)
    t2 = torch.stack([b, sign + (d1 * d1) * a, -d1], dim=-1)
    return t1, t2


def direction_from_cos_u(d_in, cos_theta, u_phi):
    """Scattered directions at (cos_theta, phi = 2*pi*u_phi) around
    ``d_in`` [B, 3]. In float64 path state the float32 steps on a float32
    ``cos_theta`` and on ``u_phi`` round as the jitted reference's do
    (:mod:`.fastmath`)."""
    t1, t2 = ortho_frame(d_in)
    exact = d_in.dtype == torch.float64
    if exact and cos_theta.dtype == torch.float32:
        sin_theta = sin_from_cos_xla(cos_theta)
    else:
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    cp, sp = cos_sin_2pi(u_phi, fused=exact)
    return (
        t1 * (sin_theta * cp)[..., None]
        + t2 * (sin_theta * sp)[..., None]
        + d_in * cos_theta[..., None]
    )


def _rayleigh_ab(depol):
    """(a, b) of p ∝ a + b cos^2 with gamma = depol / (2 - depol)."""
    gamma = depol / (2.0 - depol)
    return 1.0 + 3.0 * gamma, 1.0 - gamma


def rayleigh_eval(depol, cos_theta):
    a, b = _rayleigh_ab(depol)
    denom = (16.0 * math.pi) * (1.0 + 2.0 * (depol / (2.0 - depol)))
    norm = torch.full_like(denom, 3.0) / denom
    return norm * (a + b * cos_theta * cos_theta)


def _cbrt(t):
    """Real cube root (torch has no ``cbrt``)."""
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


def rayleigh_sample_cos(depol, u):
    """Exact inverse-CDF sample of cos_theta from a + b cos^2: a uniform
    component of mass 2a and a cubic one of mass 2b/3. The cube root of
    the float32 ``2u - 1`` is XLA's (:func:`.fastmath.cbrt_xla`) where
    ``depol`` is float64 path state."""
    a, b = _rayleigh_ab(depol)
    w_uniform = (2.0 * a) / (2.0 * a + 2.0 * b / 3.0)
    t = 2.0 * u[..., 1] - 1.0
    exact = depol.dtype == torch.float64 and t.dtype == torch.float32
    cbrt = cbrt_xla if exact else _cbrt
    return torch.where(u[..., 0] < w_uniform, t, cbrt(t))


def _strong(x):
    """A 0-d tensor as a 1-element one. torch lets a 0-d float64 tensor take
    a float32 operand's dtype, where JAX promotes the operand to float64;
    a 1-element tensor promotes as JAX does, and broadcasts the same."""
    return x.reshape(1) if isinstance(x, torch.Tensor) and x.ndim == 0 else x


def hg_eval(g, cos_theta):
    """Henyey-Greenstein phase function of asymmetry ``g``."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi * torch.pow(torch.clamp(denom, min=1e-12), 1.5))


def hg_sample_cos(g, u):
    """Exact inverse-CDF sample of cos_theta; isotropic below |g| = 1e-4."""
    u1 = u[..., 0]
    g = _strong(g)
    small = torch.abs(g) < 1e-4
    g_safe = torch.where(small, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * g_safe)
    return torch.where(small, 2.0 * u1 - 1.0, torch.clamp(cos_hg, -1.0, 1.0))


def iso_eval(cos_theta):
    return torch.full_like(cos_theta, 1.0 / (4.0 * math.pi))


def tab_phase_tables(mu, values):
    """Sampling CDF of a tabulated phase function (host side, numpy).

    ``mu`` ascending [M], ``values`` [..., M] phase values [1/sr]. Returns
    ``(values_normalized, cdf)``: the CDF over mu by the trapezoid rule, and
    the values rescaled so that 2 pi times their integral over mu is 1.
    """
    mu = np.asarray(mu, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    seg = 0.5 * (v[..., 1:] + v[..., :-1]) * np.diff(mu)
    integral = 2.0 * np.pi * np.sum(seg, axis=-1, keepdims=True)
    v = v / integral
    seg = seg / integral
    cdf = np.concatenate(
        [np.zeros(v.shape[:-1] + (1,)), np.cumsum(seg * 2.0 * np.pi, axis=-1)], axis=-1
    )
    # cdf[-1] = 1 exactly
    cdf = cdf / cdf[..., -1:]
    return v, cdf


def theta_grid_params(mu):
    """``(theta0, inv_dtheta)`` when ``mu`` is uniform in theta, else None
    (host side, numpy): :func:`tab_eval` then finds a cosine's cell as
    ``(theta0 - acos(c)) * inv_dtheta``."""
    theta = np.arccos(np.clip(np.asarray(mu, np.float64), -1.0, 1.0))
    d = np.diff(theta)
    if d.size and np.allclose(d, d[0], rtol=1e-6, atol=1e-9) and d[0] < 0:
        return float(theta[0]), float(1.0 / (-d[0]))
    return None


def tab_eval(params, cos_theta):
    """Tabulated phase value, linear in mu: the cell from the arithmetic
    theta index where the grid is theta-uniform (``tg0`` present), else from
    a search of ``mu``."""
    if params.get("tg0") is not None:
        M = params["mu"].shape[-1]
        c = torch.clamp(cos_theta, -1.0, 1.0)
        theta = torch.arccos(c)
        k = torch.clamp(
            ((params["tg0"] - theta) * params["itg"]).to(torch.int32), 0, M - 2
        ).long()
        (v0, dv), (m0, dm) = fetch_pairs_at(k, (params["values"], params["mu"]))
        frac = torch.clamp((c - m0) / torch.where(dm == 0.0, 1.0, dm), 0.0, 1.0)
        return v0 + frac * dv
    _, frac, ((v0, dv),) = interp_fetch(cos_theta, params["mu"], (params["values"],))
    return v0 + frac * dv


def tab_sample_cos(params, u):
    """Inverse-CDF sample of cos_theta, linear inside the CDF's cell."""
    _, frac, ((m0, dm),) = interp_fetch(u[..., 0], params["cdf"], (params["mu"],))
    return m0 + frac * dm


def layer_param_slots(phase_kinds, phase_params):
    """Per-layer parameter tables the components index by layer, and their
    (component, name) slots; the tables ride the collision fetch."""
    tables, slots = [], []
    for c, kind in enumerate(phase_kinds):
        if kind == "rayleigh":
            tables.append(phase_params[c]["depol"])
            slots.append((c, "depol"))
    return tables, slots


def rebuild_fetched(phase_kinds, slots, fetched):
    """Arrange fetched per-lane values into per-component dicts."""
    at = [dict() for _ in phase_kinds]
    for (c, name), val in zip(slots, fetched):
        at[c][name] = val
    return tuple(at)


def _component_eval_at(kind, params, at, cos_theta):
    """One component's phase value from its own parameters ``params`` and
    its fetched layer values ``at``."""
    if kind == "rayleigh":
        return rayleigh_eval(at["depol"], cos_theta)
    if kind == "hg":
        return hg_eval(params["g"], cos_theta)
    if kind == "isotropic":
        return iso_eval(cos_theta)
    if kind in ("tab", "tab_polarized"):
        return tab_eval(params, cos_theta)
    raise NotImplementedError(f"phase kind {kind!r} is not ported yet")


def _component_sample_cos_at(kind, params, at, u):
    if kind == "rayleigh":
        return rayleigh_sample_cos(at["depol"], u)
    if kind == "hg":
        return hg_sample_cos(params["g"], u)
    if kind == "isotropic":
        return 2.0 * u[..., 0] - 1.0
    if kind in ("tab", "tab_polarized"):
        return tab_sample_cos(params, u)
    raise NotImplementedError(f"phase kind {kind!r} is not ported yet")


def phase_eval_at(phase_kinds, phase_params, weights_at, params_at, cos_theta):
    """Blend-weighted phase value; ``weights_at`` [B, C], ``phase_params``
    the components' parameters of one spectral row."""
    total = weights_at[:, 0] * _component_eval_at(
        phase_kinds[0], phase_params[0], params_at[0], cos_theta
    )
    for c in range(1, len(phase_kinds)):
        total = total + weights_at[:, c] * _component_eval_at(
            phase_kinds[c], phase_params[c], params_at[c], cos_theta
        )
    return total


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` as the reference's jitted code computes it:
    the bracket ``i`` from ``searchsorted(side="right")`` clipped to [1, M -
    1], ``fp[i - 1] + (delta / dx) * df`` rounded once (XLA:CPU contracts it
    into a fused multiply-add), ``fp[i - 1]`` where ``|dx|`` is below
    ``np.spacing(eps)`` of ``xp``'s dtype, and ``fp`` at either end outside ``xp``. ``fp`` is
    a sequence of tables [M] on the grid ``xp`` [M]; returns one [B]
    tensor for each."""
    M = xp.shape[-1]
    x = x.to(xp.dtype)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, M - 1)
    x0 = xp[i - 1]
    dx = xp[i] - x0
    eps = np.finfo(np.float64 if xp.dtype == torch.float64 else np.float32).eps
    dx0 = torch.abs(dx) <= float(np.spacing(eps))
    q = (x - x0) / torch.where(dx0, 1.0, dx)
    below, above = x < xp[0], x > xp[-1]
    out = []
    for table in fp:
        f0 = table[i - 1]
        f = torch.where(dx0, f0, fma(q, table[i] - f0, f0))
        out.append(torch.where(above, table[-1], torch.where(below, table[0], f)))
    return out


def tab_polarized_mueller(params, cos_theta):
    """Tabulated polarized phase matrix ``[B, 4, 4]`` (reference
    ``tracer_polarized._tab_polarized_mueller``): m11 (``values``, the
    scalar phase), m12, m22, m33, m34 and m44 interpolated in mu by
    :func:`interp`, in the block layout [[m11, m12], [m12, m22]] and [[m33,
    m34], [-m34, m44]]."""
    m11, m12, m22, m33, m34, m44 = interp(
        cos_theta, params["mu"],
        [params[k] for k in ("values", "m12", "m22", "m33", "m34", "m44")],
    )
    z = torch.zeros_like(m11)
    return matrix4(
        [[m11, m12, z, z], [m12, m22, z, z], [z, z, m33, m34], [z, z, -m34, m44]]
    )


def phase_mueller_at(phase_kinds, phase_params, weights_at, params_at, cos_theta):
    """Blend-weighted Mueller phase matrix ``[B, 4, 4]`` in scattering-plane
    frames: Rayleigh and ``tab_polarized`` components contribute their full
    matrices, scalar components ideal depolarizers of their phase value (no
    polarization memory)."""
    total = None
    for c, kind in enumerate(phase_kinds):
        if kind == "rayleigh":
            m = rayleigh_mueller(cos_theta, params_at[c]["depol"])
        elif kind == "tab_polarized":
            m = tab_polarized_mueller(phase_params[c], cos_theta)
        else:
            m = depolarizer(
                _component_eval_at(kind, phase_params[c], params_at[c], cos_theta)
            )
        term = weights_at[:, c, None, None] * m
        total = term if total is None else total + term
    return total


def phase_sample_at(
    phase_kinds, phase_params, weights_at, params_at, d_in, u_sel, u_cos, u_phi
):
    """Sample scattered directions from the blend: pick a component by
    weight, sample its cosine exactly, then the azimuth."""
    total = weights_at[:, 0]
    for c in range(1, len(phase_kinds)):
        total = total + weights_at[:, c]
    total = torch.clamp(total, min=1e-30)
    cos_theta = torch.zeros_like(u_sel)
    cdf = torch.zeros_like(u_sel)
    prev_hit = torch.zeros_like(u_sel, dtype=torch.bool)
    for c, kind in enumerate(phase_kinds):
        cdf = cdf + weights_at[:, c] / total
        cos_c = _component_sample_cos_at(kind, phase_params[c], params_at[c], u_cos)
        hit = u_sel < cdf
        cos_theta = torch.where(hit & ~prev_hit, cos_c, cos_theta)
        prev_hit = hit
    return direction_from_cos_u(d_in, cos_theta, u_phi)
