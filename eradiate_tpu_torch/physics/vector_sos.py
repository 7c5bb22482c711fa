# Host-code copy of eradiate_tpu/physics/vector_sos.py; regenerate with tools/copy_host_code.py, do not edit.
"""Successive-orders-of-scattering (SOS) vector Rayleigh solver.

A SECOND deterministic oracle for polarized plane-parallel Rayleigh
transport, algorithmically disjoint from both the Monte-Carlo tracer and
the doubling–adding solver (:mod:`eradiate_tpu.physics.vector_doubling`):

- no Fourier azimuth decomposition — the radiance field lives on a full
  (mu, phi) direction grid and the scattering integral is a direct
  quadrature (uniform trapezoid in azimuth is *exact* for the Rayleigh
  phase matrix, a trig polynomial of degree 2; Gauss–Legendre in zenith);
- no operator doubling — transport integrates the source function in
  optical depth, layer by layer, with the in-layer source linear in tau
  and the exponential integrals in closed form;
- an independently-derived phase matrix: the Hansen & Travis (1974)
  depolarization parameterization (Delta = (1-d)/(1+d/2),
  Delta' = (1-2d)/(1-d)) with explicit geometric basis rotations, where
  the doubling solver uses the Chandrasekhar gamma = d/(2-d) kernels.

The three methods (MC, doubling, SOS) share only the documented Stokes
conventions (meridian basis ``normalize(z - (z.d) d)``; response to unit
beam-normal irradiance), so mutual agreement pins each against two
independent implementations — the closest available substitute for the
Coulson/Natraj published tables (whose exact transcription is not
possible in this offline environment; the role the reference fills with
stored regression datasets, ``src/eradiate/test_tools/regression.py:801-916``).

Convergence: each scattering order multiplies the field by an operator
of norm <= omega * (1 - T) < 1; orders are summed until the TOA
increment falls below ``tol``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rayleigh_stokes_toa_sos"]


# ---------------------------------------------------------------------------
# Geometry


def _dirs_from(mu, phi):
    """Unit propagation vectors from direction cosines mu (z-component)
    and azimuths phi. mu > 0 propagates upward."""
    s = np.sqrt(np.maximum(1.0 - mu * mu, 0.0))
    return np.stack([s * np.cos(phi), s * np.sin(phi), mu], axis=-1)


def _meridian_basis(d):
    """(e_v, e_h): meridian ('vertical') Stokes basis for propagation d.

    e_v = normalize(z - (z.d) d) — the repo-wide convention; e_h = d x e_v
    completes a right-handed triad looking against the propagation.
    """
    z = np.zeros_like(d)
    z[..., 2] = 1.0
    ev = z - d * d[..., 2:3]
    n = np.linalg.norm(ev, axis=-1, keepdims=True)
    ev = ev / np.where(n > 1e-12, n, 1.0)
    eh = np.cross(d, ev)
    return ev, eh


def _rot_stokes(c2, s2):
    """Stokes (I, Q, U) rotation with cos(2 eta) = c2, sin(2 eta) = s2,
    as a stacked [..., 3, 3] matrix."""
    out = np.zeros(c2.shape + (3, 3))
    out[..., 0, 0] = 1.0
    out[..., 1, 1] = c2
    out[..., 1, 2] = s2
    out[..., 2, 1] = -s2
    out[..., 2, 2] = c2
    return out


def _basis_rotation(d, a_v, a_h, b_v, b_h):
    """Rotation matrix taking Stokes components from basis (a_v, a_h) to
    (b_v, b_h), both orthonormal transverse bases of propagation d."""
    c = np.sum(a_v * b_v, axis=-1)
    # right-handed looking AGAINST the propagation direction (the
    # engine-wide convention, vector_doubling.py docstring): the sine is
    # the component of a_v along -b_h
    s = -np.sum(a_v * b_h, axis=-1)
    c2 = c * c - s * s
    s2 = 2.0 * c * s
    return _rot_stokes(c2, s2)


def _scatter_matrix_rayleigh(cos_t, depol):
    """3x3 (I, Q, U) Rayleigh scattering matrix in the scattering-plane
    basis, Hansen & Travis (1974) eq. (2.15) parameterization,
    normalized so (1/4pi) int F11 dOmega = 1. (The Delta' factor of
    eq. (2.16) multiplies only the circular-polarization row/column,
    absent from this 3x3 block.)"""
    d = depol
    Delta = (1.0 - d) / (1.0 + d / 2.0)
    c = cos_t
    s2 = 1.0 - c * c
    F = np.zeros(np.shape(c) + (3, 3))
    F[..., 0, 0] = Delta * 0.75 * (1.0 + c * c) + (1.0 - Delta)
    F[..., 0, 1] = -Delta * 0.75 * s2
    F[..., 1, 0] = F[..., 0, 1]
    F[..., 1, 1] = Delta * 0.75 * (1.0 + c * c)
    F[..., 2, 2] = Delta * 1.5 * c
    return F


def _phase_matrix(d_in, d_out, depol):
    """Meridian-basis phase matrix P (3x3) for scattering d_in -> d_out.

    Rotates the incoming Stokes vector from the meridian basis of d_in
    into the scattering-plane basis, applies the scattering matrix, and
    rotates into the meridian basis of d_out. Vectorized over leading
    axes of d_in/d_out (broadcast)."""
    d_in = np.asarray(d_in, dtype=np.float64)
    d_out = np.asarray(d_out, dtype=np.float64)
    d_in, d_out = np.broadcast_arrays(d_in, d_out)
    cos_t = np.clip(np.sum(d_in * d_out, axis=-1), -1.0, 1.0)
    F = _scatter_matrix_rayleigh(cos_t, depol)

    # scattering-plane basis: h = normalize(d_in x d_out) shared by both
    # directions; v = h x d completes each triad. Degenerate (collinear)
    # pairs get an arbitrary transverse axis — F is rotation-invariant at
    # cos_t = 1 and the grids are built so exact backscatter never pairs.
    h = np.cross(d_in, d_out)
    hn = np.linalg.norm(h, axis=-1, keepdims=True)
    fallback_v, _ = _meridian_basis(d_in)
    fallback = np.cross(d_in, fallback_v)
    h = np.where(hn > 1e-12, h / np.where(hn > 1e-12, hn, 1.0), fallback)
    v_in = np.cross(h, d_in)
    v_out = np.cross(h, d_out)

    mv_in, mh_in = _meridian_basis(d_in)
    mv_out, mh_out = _meridian_basis(d_out)
    R_in = _basis_rotation(d_in, mv_in, mh_in, v_in, h)
    R_out = _basis_rotation(d_out, v_out, h, mv_out, mh_out)
    return R_out @ F @ R_in


# ---------------------------------------------------------------------------
# Transport: closed-form layer integrals of a linear-in-tau source


def _sweep_up(S, dtau, mu_up, ground_up):
    """Upward radiance at every level from volume source S and a bottom
    boundary field. S: [J+1, N, 3] source at levels (top..bottom);
    dtau: [J]; mu_up: [N]; ground_up: [N, 3] upward radiance at bottom.
    Returns I_up [J+1, N, 3]."""
    J = dtau.size
    out = np.zeros_like(S)
    out[J] = ground_up
    for j in range(J - 1, -1, -1):
        r = dtau[j] / mu_up  # [N]
        E = np.exp(-r)
        one_m_E = -np.expm1(-r)
        w0 = one_m_E - (one_m_E / r - E)  # weight of S at the near level
        w1 = one_m_E / r - E  # weight of S at the far level
        out[j] = (
            out[j + 1] * E[:, None]
            + S[j] * w0[:, None]
            + S[j + 1] * w1[:, None]
        )
    return out


def _sweep_down(S, dtau, mu_dn):
    """Downward radiance at every level (top boundary dark)."""
    J = dtau.size
    out = np.zeros_like(S)
    for j in range(1, J + 1):
        r = dtau[j - 1] / mu_dn
        E = np.exp(-r)
        one_m_E = -np.expm1(-r)
        w0 = one_m_E - (one_m_E / r - E)
        w1 = one_m_E / r - E
        out[j] = (
            out[j - 1] * E[:, None]
            + S[j] * w0[:, None]
            + S[j - 1] * w1[:, None]
        )
    return out


def rayleigh_stokes_toa_sos(
    tau,
    mu0,
    mu_views,
    dphis,
    albedo=0.0,
    omega=1.0,
    depol=0.0,
    n_mu=24,
    n_phi=8,
    n_tau=160,
    tol=1e-7,
    max_orders=200,
):
    """TOA upward Stokes (I, Q, U) above a homogeneous Rayleigh layer.

    Same contract as
    :func:`eradiate_tpu.physics.vector_doubling.rayleigh_stokes_toa`:
    unit beam-normal irradiance, meridian output basis, sun azimuth 0,
    ``dphis`` = view minus sun azimuth. Returns [len(mu_views), 3].
    """
    mu_views = np.atleast_1d(np.asarray(mu_views, dtype=np.float64))
    dphis = np.broadcast_to(
        np.atleast_1d(np.asarray(dphis, dtype=np.float64)), mu_views.shape
    )
    if np.any(mu_views <= 0):
        raise ValueError("mu_views must be upward (positive)")

    # direction grids: Gauss-Legendre zenith nodes per hemisphere x
    # uniform azimuths (exact for Rayleigh's degree-2 trig dependence).
    # The upward azimuth grid is offset by half a step so no upward node
    # is the exact antipode of a downward node (degenerate scattering
    # plane at cos_t = -1).
    x, w = np.polynomial.legendre.leggauss(n_mu)
    mu_q = 0.5 * (x + 1.0)
    w_q = 0.5 * w
    phi_dn = 2.0 * np.pi * np.arange(n_phi) / n_phi
    phi_up = phi_dn + np.pi / n_phi
    w_phi = 2.0 * np.pi / n_phi

    def hemi(mu_nodes, w_nodes, phi, sign):
        mu_g, phi_g = np.meshgrid(mu_nodes, phi, indexing="ij")
        wq_g, _ = np.meshgrid(w_nodes * w_phi, phi, indexing="ij")
        d = _dirs_from(sign * mu_g.ravel(), phi_g.ravel())
        return d, wq_g.ravel(), sign * mu_g.ravel()

    d_dn, w_dn, mu_dn = hemi(mu_q, w_q, phi_dn, -1.0)
    d_up, w_up, mu_up = hemi(mu_q, w_q, phi_up, +1.0)
    # weight-zero exact view nodes (sun azimuth = 0)
    d_v = _dirs_from(mu_views, dphis)
    d_up = np.concatenate([d_up, d_v], axis=0)
    w_up = np.concatenate([w_up, np.zeros(mu_views.size)])
    mu_up = np.concatenate([mu_up, mu_views])

    d_all = np.concatenate([d_dn, d_up], axis=0)
    w_all = np.concatenate([w_dn, w_up])
    mu_all = np.concatenate([mu_dn, mu_up])
    N = d_all.shape[0]
    n_dn = d_dn.shape[0]
    i_views = n_dn + d_up.shape[0] - mu_views.size + np.arange(mu_views.size)

    d_sun = _dirs_from(-mu0, 0.0)

    # scattering operator: K[i, j] (3x3 blocks) maps the field at node j
    # into the source toward node i, including the quadrature weights:
    # S_i = (omega / 4pi) sum_j P(d_j -> d_i) I_j w_j
    P = _phase_matrix(d_all[None, :, :], d_all[:, None, :], depol)
    K = (omega / (4.0 * np.pi)) * P * w_all[None, :, None, None]
    K = K.transpose(0, 2, 1, 3).reshape(3 * N, 3 * N)

    # phase from the sun beam into every node (for the first order)
    P_sun = _phase_matrix(d_sun[None, :], d_all, depol)  # [N, 3, 3]

    levels = np.linspace(0.0, tau, n_tau + 1)
    dtau = np.diff(levels)
    att = np.exp(-levels / mu0)  # direct beam attenuation at levels

    # ---- order 1: single scattering of the direct beam ----------------
    # beam Stokes = (E0, 0, 0) with E0 = 1 (unpolarized sun)
    S = (omega / (4.0 * np.pi)) * P_sun[None, :, :, 0] * att[:, None, None]

    total_view = np.zeros((mu_views.size, 3))
    field = np.zeros((n_tau + 1, N, 3))
    for order in range(1, max_orders + 1):
        # ground boundary: Lambertian reflection (I component only) of the
        # same-order downward field — plus, at order 1, the direct beam
        dn_f = None
        ground_up = np.zeros((mu_up.size, 3))
        if albedo > 0.0:
            dn_f = _sweep_down(S[:, :n_dn], dtau, -mu_dn)
            flux_dn = np.sum(
                dn_f[n_tau, :, 0] * (-mu_dn) * w_dn
            )
            if order == 1:
                flux_dn = flux_dn + mu0 * att[n_tau]
            ground_up[:, 0] = albedo * flux_dn / np.pi
        else:
            dn_f = _sweep_down(S[:, :n_dn], dtau, -mu_dn)
        up_f = _sweep_up(S[:, n_dn:], dtau, mu_up, ground_up)

        inc = up_f[0, i_views - n_dn]
        total_view = total_view + inc
        if np.max(np.abs(inc)) < tol * max(np.max(np.abs(total_view)), 1e-30):
            break

        field[:, :n_dn] = dn_f
        field[:, n_dn:] = up_f
        # next-order source: scatter the current field
        S = (field.reshape(n_tau + 1, 3 * N) @ K.T).reshape(n_tau + 1, N, 3)

    return total_view
