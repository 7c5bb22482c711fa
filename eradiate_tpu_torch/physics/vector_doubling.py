# Host-code copy of eradiate_tpu/physics/vector_doubling.py; regenerate with tools/copy_host_code.py, do not edit.
"""Deterministic vector (polarized) doubling–adding Rayleigh solver.

External correctness anchor for the polarized Monte-Carlo tracer
(VERDICT r2 task #4): an *independent* deterministic method — matrix
doubling–adding with Gauss quadrature in zenith and exact Fourier
azimuth decomposition — computing TOA Stokes (I, Q, U) reflected by a
plane-parallel Rayleigh layer above a (Lambertian or black) ground.
This fills the role of the reference's stored regression datasets
(``src/eradiate/test_tools/regression.py:219-1011``) and of the
Coulson/Natraj published tables (an exact deterministic solution of the
same standard problem those tables tabulate): any engine-wide bias in
the MC Mueller chain (sign, scale, frame-rotation, phase-matrix
normalization) disagrees with this solver, while a shared-bias
self-comparison cannot catch it.

Method (classic; Hansen & Travis 1974 §5, van de Hulst's adding):

- operators R/T on the half-sphere are discretized on Gauss–Legendre
  zenith nodes (plus weight-zero "exact output" nodes at the sun/view
  angles) and expanded in a complex azimuth Fourier series — Rayleigh
  truncates exactly at m = 2;
- per mode, reflection/transmission of a thin starting layer use the
  exact single-scattering closed form; doubling composes the layer up
  to the target optical depth; Lambertian ground enters through one
  adding step (m = 0 only);
- everything is f64 numpy — no JAX, no shared code with the MC path
  (:mod:`eradiate_tpu.ops.tracer_polarized` /
  :mod:`eradiate_tpu.ops.mueller`), only the same *documented Stokes
  conventions* so outputs are directly comparable: Stokes basis of a
  beam propagating along ``d`` is the meridian ("vertical") basis
  ``normalize(z - (z.d) d)``; rotations are right-handed looking
  against the propagation direction; the scattering-plane reference is
  the in-plane ("parallel") vector.

Operator convention used throughout: ``I_out(mu, dphi) = R(mu, mu0,
dphi) @ S_in * E0`` with ``E0`` the beam irradiance per unit area
*normal to the beam* (the engine's ``illumination.irradiance``), so the
engine BRF is ``pi * I / (E0 * mu0)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rayleigh_stokes_toa", "DoublingResult"]

_N_PHI = 8  # uniform azimuth samples; exact for trig degree <= 3
_MODES = 3  # Rayleigh Fourier series: m = 0, 1, 2


# ---------------------------------------------------------------------------
# Geometry & phase matrix (independent numpy implementation)


def _merid_basis(d):
    """Meridian ('vertical') Stokes basis for propagation direction d."""
    d = np.asarray(d, dtype=np.float64)
    z = np.zeros_like(d)
    z[..., 2] = 1.0
    b = z - d * d[..., 2:3]
    n = np.linalg.norm(b, axis=-1, keepdims=True)
    if np.any(n < 1e-12):
        raise ValueError("meridian basis undefined at the poles")
    return b / n


def _rot_angle(d, b_from, b_to):
    """Signed rotation angle from b_from to b_to around d (right-handed
    looking against the propagation direction)."""
    cosang = np.clip(np.sum(b_from * b_to, axis=-1), -1.0, 1.0)
    sinang = np.sum(np.cross(b_from, b_to) * d, axis=-1)
    return np.arctan2(sinang, cosang)


def _rot3(phi):
    """3x3 (I,Q,U) Stokes rotator for a basis rotation by phi."""
    c = np.cos(2.0 * phi)
    s = np.sin(2.0 * phi)
    out = np.zeros(phi.shape + (3, 3))
    out[..., 0, 0] = 1.0
    out[..., 1, 1] = c
    out[..., 1, 2] = s
    out[..., 2, 1] = -s
    out[..., 2, 2] = c
    return out


def _rayleigh_3x3(cos_t, depol):
    """Rayleigh scattering matrix [1/sr], (I,Q,U), both Stokes frames in
    the scattering plane with the in-plane ('parallel') reference;
    normalized so the (0,0) element integrates to 1 over the sphere.

    Hansen & Travis (1974) eq. (2.15): Delta = (1-d)/(1+d/2) mixes the
    pure-Rayleigh matrix with an isotropic depolarizing part.
    """
    c = np.asarray(cos_t, dtype=np.float64)
    delta = (1.0 - depol) / (1.0 + depol / 2.0)
    s2 = 1.0 - c * c
    k = 3.0 / (16.0 * np.pi)
    P = np.zeros(c.shape + (3, 3))
    P[..., 0, 0] = k * (1.0 + c * c)
    P[..., 0, 1] = -k * s2
    P[..., 1, 0] = -k * s2
    P[..., 1, 1] = k * (1.0 + c * c)
    P[..., 2, 2] = k * 2.0 * c
    P = delta * P
    P[..., 0, 0] += (1.0 - delta) / (4.0 * np.pi)
    return P


def _phase_meridian(d_in, d_out, depol):
    """Phase matrix (3x3) for scattering d_in -> d_out, both Stokes
    vectors in their meridian bases: L(out) P_scat(Theta) L(in)."""
    d_in = np.asarray(d_in, dtype=np.float64)
    d_out = np.asarray(d_out, dtype=np.float64)
    cos_t = np.sum(d_in * d_out, axis=-1)
    n = np.cross(d_in, d_out)
    nn = np.linalg.norm(n, axis=-1, keepdims=True)
    # near-forward/backward: scattering plane degenerate; pick any plane
    # through d_in (the s2 terms vanish there so the choice is harmless)
    fallback = _merid_basis(d_in)
    fallback = np.cross(
        d_in, np.broadcast_to(fallback, d_in.shape)
    )
    n = np.where(nn > 1e-9, n / np.maximum(nn, 1e-30), fallback)
    p_in = np.cross(n, d_in)  # in-plane reference, incoming
    p_out = np.cross(n, d_out)  # in-plane reference, outgoing
    a_in = _rot_angle(d_in, _merid_basis(d_in), p_in)
    a_out = _rot_angle(d_out, p_out, _merid_basis(d_out))
    P = _rayleigh_3x3(cos_t, depol)
    return _rot3(a_out) @ P @ _rot3(a_in)


def _fourier_kernels(mu, depol):
    """Complex Fourier coefficient kernels of the meridian phase matrix.

    Returns (PR, PT): arrays of shape (_MODES, n, n, 3, 3) with
    ``P(dphi) = K[0] + sum_m 2 Re[K[m] exp(+i m dphi)]`` for
    reflection-type (down -> up) and transmission-type (down -> down)
    direction pairs on the zenith-node grid ``mu``.
    """
    mu = np.asarray(mu, dtype=np.float64)
    s = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))
    nphi = _N_PHI
    dphi = 2.0 * np.pi * np.arange(nphi) / nphi
    # incoming: downward at azimuth 0
    d_in = np.stack([s, np.zeros_like(s), -mu], axis=-1)  # (n, 3)
    # outgoing grids over relative azimuth
    cph, sph = np.cos(dphi), np.sin(dphi)
    d_up = np.stack(
        [
            s[:, None] * cph[None, :],
            s[:, None] * sph[None, :],
            np.broadcast_to(mu[:, None], (mu.size, nphi)),
        ],
        axis=-1,
    )  # (n, nphi, 3)
    d_dn = d_up.copy()
    d_dn[..., 2] = -d_dn[..., 2]

    di = np.broadcast_to(d_in[None, :, None, :], (mu.size, mu.size, nphi, 3))
    out = {}
    for key, dgrid in (("R", d_up), ("T", d_dn)):
        do = np.broadcast_to(
            dgrid[:, None, :, :], (mu.size, mu.size, nphi, 3)
        )
        P = _phase_meridian(di, do, depol)  # (n_out, n_in, nphi, 3, 3)
        F = np.fft.fft(P, axis=2) / nphi  # coefficient of exp(-i m dphi)
        out[key] = np.transpose(F[:, :, :_MODES], (2, 0, 1, 3, 4))
    return out["R"], out["T"]


# ---------------------------------------------------------------------------
# Doubling–adding core


def _flat(K):
    """(n, n, 3, 3) block kernel -> (3n, 3n) matrix."""
    n = K.shape[0]
    return np.transpose(K, (0, 2, 1, 3)).reshape(3 * n, 3 * n)


def _unflat(M, n):
    return np.transpose(M.reshape(n, 3, n, 3), (0, 2, 1, 3))


class DoublingResult:
    """Reflection operator of the layer+ground system, queryable at the
    (weight-zero) exact nodes embedded in the quadrature grid."""

    def __init__(self, mu, r_modes):
        self.mu = mu
        self.r_modes = r_modes  # list of (3n, 3n) complex, m = 0..2

    def stokes(self, i_out, i_in, dphi):
        """TOA Stokes (I,Q,U) for unit beam irradiance E0=1, unpolarized
        sun at node index i_in, view node i_out, relative azimuth dphi
        (view azimuth minus sun azimuth)."""
        n = self.mu.size
        S = np.zeros(3)
        s_in = np.array([1.0, 0.0, 0.0])
        for m, Rm in enumerate(self.r_modes):
            blk = _unflat(Rm, n)[i_out, i_in]  # (3, 3) complex
            contrib = blk @ s_in
            if m == 0:
                S += contrib.real
            else:
                # np.fft.fft yields coefficients of exp(+i m dphi)
                S += 2.0 * (contrib * np.exp(1j * m * dphi)).real
        return S


def _build_layer(tau, mu, wts, omega, depol):
    """Doubling of the homogeneous layer: returns per-mode (R, T) flat
    operators and the direct-transmission diagonal ``e``."""
    n = mu.size
    PR, PT = _fourier_kernels(mu, depol)

    n_dbl = max(8, int(np.ceil(np.log2(max(tau, 1e-12) / 1e-5))))
    tau0 = tau / (2.0**n_dbl)

    Wq = np.repeat(2.0 * np.pi * wts, 3)
    inv_mu = 1.0 / mu
    mui = mu[:, None]
    muj = mu[None, :]

    cij = inv_mu[:, None] + inv_mu[None, :]
    r_fac = omega * muj / (mui + muj) * -np.expm1(-tau0 * cij)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_fac = (
            omega
            * muj
            * (np.exp(-tau0 / muj) - np.exp(-tau0 / mui))
            / (muj - mui)
        )
    t_diag = omega * tau0 * np.exp(-tau0 / mu) / mu
    eye_mask = np.isclose(mui, muj)
    t_fac = np.where(eye_mask, t_diag[:, None] * np.ones_like(t_fac), t_fac)

    e = np.exp(-tau0 * inv_mu)
    D3 = np.tile(np.array([1.0, 1.0, -1.0]), n)

    R = [None] * _MODES
    T = [None] * _MODES
    for m in range(_MODES):
        R[m] = _flat(PR[m] * r_fac[:, :, None, None]).astype(complex)
        T[m] = _flat(PT[m] * t_fac[:, :, None, None]).astype(complex)

    eye = np.eye(3 * n)

    def compose(A, B):
        return (A * Wq[None, :]) @ B

    for _ in range(n_dbl):
        e_col = np.repeat(e, 3)
        for m in range(_MODES):
            Rm, Tm = R[m], T[m]
            # illumination-from-below operators: the z-mirror flips the
            # U component only (diag(1,1,-1)); relative azimuth is
            # unchanged, so the Fourier coefficients are NOT conjugated
            # (checked against directly-built flipped-geometry kernels
            # in tests/unit/test_vector_doubling.py)
            R_star = D3[:, None] * Rm * D3[None, :]
            T_star = D3[:, None] * Tm * D3[None, :]
            # Neumann series of inter-reflections: operator powers need
            # the quadrature measure BETWEEN factors, so the resolvent
            # matrix is compose(R, R*) right-weighted by Wq.
            Q = compose(Rm, R_star) * Wq[None, :]
            U = np.linalg.solve(
                eye - Q, compose(Rm, Tm) + Rm * e_col[None, :]
            )
            D = Tm + compose(R_star, U)
            R[m] = Rm + e_col[:, None] * U + compose(T_star, U)
            T[m] = e_col[:, None] * D + compose(Tm, D) + Tm * e_col[None, :]
        e = e * e

    return R, T, e, compose, Wq


def rayleigh_stokes_toa(
    tau,
    mu0,
    mu_views,
    dphis,
    albedo=0.0,
    omega=1.0,
    depol=0.0,
    n_mu=48,
):
    """TOA upward Stokes (I, Q, U) above a homogeneous Rayleigh layer.

    Parameters: total optical depth ``tau``, sun cosine ``mu0``, view
    cosines ``mu_views`` (array, >0), relative azimuths ``dphis`` (view
    minus sun, radians, array same length), Lambertian ground albedo,
    single-scattering albedo ``omega``, Rayleigh depolarization factor.
    Unit beam irradiance (per unit area normal to the beam).

    Returns array (len(mu_views), 3) in the meridian basis of the upward
    view propagation direction.  A purely scattering *inhomogeneous*
    Rayleigh profile with the same total tau yields the same answer
    (plane-parallel transport depends on optical depth only), so this is
    directly comparable to the MC tracer on AFGL-type scenes with
    absorption off.
    """
    mu_views = np.atleast_1d(np.asarray(mu_views, dtype=np.float64))
    dphis = np.broadcast_to(
        np.atleast_1d(np.asarray(dphis, dtype=np.float64)), mu_views.shape
    )
    if np.any(mu_views <= 0):
        raise ValueError("mu_views must be upward (positive)")

    # quadrature nodes + weight-zero exact nodes for sun and views
    x, w = np.polynomial.legendre.leggauss(n_mu)
    mu_q = 0.5 * (x + 1.0)
    w_q = 0.5 * w
    extras = np.concatenate([[mu0], mu_views])
    mu = np.concatenate([mu_q, extras])
    wts = np.concatenate([w_q, np.zeros_like(extras)])
    n = mu.size
    i_sun = n_mu
    i_views = n_mu + 1 + np.arange(mu_views.size)

    R, T, e, compose, Wq = _build_layer(tau, mu, wts, omega, depol)

    # adding the Lambertian ground (m = 0 only; Lambertian reflection is
    # azimuth-independent and fully depolarizing).  In this operator
    # convention (response to beam-normal irradiance) the Lambertian
    # kernel is rho * mu_in / pi into the I component.
    if albedo > 0.0:
        D3 = np.tile(np.array([1.0, 1.0, -1.0]), n)
        eye = np.eye(3 * n)
        Rg = np.zeros((n, n, 3, 3))
        Rg[:, :, 0, 0] = albedo * mu[None, :] / np.pi
        Rg = _flat(Rg).astype(complex)
        e_col = np.repeat(e, 3)
        Rm, Tm = R[0], T[0]
        R_star = D3[:, None] * Rm * D3[None, :]
        T_star = D3[:, None] * Tm * D3[None, :]
        Q = compose(Rg, R_star) * Wq[None, :]
        U = np.linalg.solve(eye - Q, compose(Rg, Tm) + Rg * e_col[None, :])
        R[0] = Rm + e_col[:, None] * U + compose(T_star, U)

    res = DoublingResult(mu, R)
    out = np.zeros((mu_views.size, 3))
    for k, iv in enumerate(i_views):
        out[k] = res.stokes(iv, i_sun, dphis[k])
    return out
