# Host-code copy of eradiate_tpu/physics/mie.py; regenerate with tools/copy_host_code.py, do not edit.
"""Lorenz-Mie scattering for homogeneous spheres (host-side numpy).

Standalone Mie solver used to GENERATE aerosol single-scattering
datasets offline (``data/store/aerosol/make_continental.py``) — the
reference ships precomputed aerosol files through its online data store
(``scenes/atmosphere/_particle_layer.py:51``) and has no Mie capability
of its own; here the classic Bohren & Huffman (1983) recurrence is
implemented directly so polarized phase matrices for documented size
distributions can be computed without network access.

Algorithm: downward continued-fraction-free logarithmic-derivative
recurrence for ``D_n = psi_n'/psi_n`` (the standard numerically-stable
formulation), upward Riccati-Bessel recurrences for ``psi_n``/``chi_n``,
Mie coefficients a_n/b_n, and angle sums S1/S2 over pi_n/tau_n. All
quantities vectorized over the angle grid; sizes loop in Python (the
generator integrates ~60 quadrature radii x ~20 wavelengths, far from
hot-path scale).

Validation (tests/unit/test_mie.py): Rayleigh limit (x << 1) against
the closed form Qsca = (8/3) x^4 |(m^2-1)/(m^2+2)|^2 and its dipole
phase matrix, the extinction paradox Qext -> 2 at large x, energy
conservation (0 <= Qsca <= Qext), phase normalization, and the
polarization identities for spheres (P22 = P11, P44 = P33).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mie_coefficients", "mie_single", "mie_lognormal"]


def _n_terms(x: float) -> int:
    """Wiscombe's series-truncation criterion."""
    return int(np.ceil(x + 4.05 * x ** (1.0 / 3.0) + 2.0)) + 1


def mie_coefficients(x: float, m: complex):
    """Mie coefficients a_n, b_n for size parameter ``x`` and complex
    refractive index ``m`` (convention ``n - i k`` with k >= 0 passed as
    ``complex(n, -k)`` or ``complex(n, +k)``; only |Im| is used, as
    absorption)."""
    m = complex(m.real, -abs(m.imag))  # internal convention: negative Im
    N = _n_terms(x)
    mx = m * x
    # downward recurrence for D_n(mx), started well above N
    n_start = N + max(int(np.ceil(np.abs(mx))), N) + 16
    D = np.zeros(n_start + 1, dtype=complex)
    for n in range(n_start, 0, -1):
        D[n - 1] = n / mx - 1.0 / (D[n] + n / mx)
    D = D[1 : N + 1]

    # upward Riccati-Bessel psi, chi at x
    psi = np.zeros(N + 1)
    chi = np.zeros(N + 1)
    psi_m1, psi_0 = np.cos(x), np.sin(x)  # psi_{-1}, psi_0
    chi_m1, chi_0 = -np.sin(x), np.cos(x)
    for n in range(1, N + 1):
        psi_n = (2 * n - 1) / x * psi_0 - psi_m1
        chi_n = (2 * n - 1) / x * chi_0 - chi_m1
        psi[n], chi[n] = psi_n, chi_n
        psi_m1, psi_0 = psi_0, psi_n
        chi_m1, chi_0 = chi_0, chi_n
    psi_full = np.concatenate([[np.sin(x)], psi[1:]])
    # zeta_n = psi_n + i chi_n  (Hankel of the second kind convention)
    zeta = psi_full + 1j * np.concatenate([[np.cos(x)], chi[1:]])
    psi_nm1 = np.concatenate([[np.cos(x)], psi_full[:-1]])
    zeta_nm1 = np.concatenate(
        [[np.cos(x) - 1j * np.sin(x)], zeta[:-1]]
    )

    n = np.arange(1, N + 1)
    Dn = D
    da = Dn / m + n / x
    db = Dn * m + n / x
    a = (da * psi_full[1:] - psi_nm1[1:]) / (da * zeta[1:] - zeta_nm1[1:])
    b = (db * psi_full[1:] - psi_nm1[1:]) / (db * zeta[1:] - zeta_nm1[1:])
    return a, b


def mie_single(x: float, m: complex, mu: np.ndarray):
    """Single-sphere Mie solution.

    Returns ``(Qext, Qsca, S1, S2)`` with S1/S2 the complex amplitude
    functions on the scattering-angle cosine grid ``mu``.
    """
    a, b = mie_coefficients(x, m)
    N = a.size
    n = np.arange(1, N + 1)
    w2 = 2 * n + 1
    Qext = 2.0 / (x * x) * np.sum(w2 * (a + b).real)
    Qsca = 2.0 / (x * x) * np.sum(w2 * (np.abs(a) ** 2 + np.abs(b) ** 2))

    mu = np.asarray(mu, dtype=np.float64)
    M = mu.size
    # pi_n, tau_n recurrences, vectorized over angles
    S1 = np.zeros(M, dtype=complex)
    S2 = np.zeros(M, dtype=complex)
    pi_nm1 = np.zeros(M)  # pi_0
    pi_n = np.ones(M)  # pi_1
    for k in range(1, N + 1):
        tau_n = k * mu * pi_n - (k + 1) * pi_nm1
        f = (2 * k + 1) / (k * (k + 1))
        S1 += f * (a[k - 1] * pi_n + b[k - 1] * tau_n)
        S2 += f * (a[k - 1] * tau_n + b[k - 1] * pi_n)
        pi_next = ((2 * k + 1) * mu * pi_n - (k + 1) * pi_nm1) / k
        pi_nm1, pi_n = pi_n, pi_next
    return Qext, Qsca, S1, S2


def mie_lognormal(
    wavelength_um: float,
    m: complex,
    r_mod_um: float,
    sigma_g: float,
    mu: np.ndarray,
    n_quad: int = 64,
    r_cut_sigmas: float = 4.0,
):
    """Lognormal-size-distribution Mie averages.

    Number distribution ``dN/dlnr ~ exp(-(ln r - ln r_mod)^2 /
    (2 ln^2 sigma_g))``. Returns a dict with per-particle-averaged
    ``sigma_ext``/``sigma_sca`` [um^2] and the normalized phase-matrix
    rows ``P11, P12, P33, P34`` on ``mu`` (4 pi normalization:
    ``integral P11 dOmega / 4 pi = 1``; spheres have P22 = P11,
    P44 = P33).
    """
    ln_s = np.log(sigma_g)
    t = np.linspace(-r_cut_sigmas, r_cut_sigmas, n_quad)
    r = r_mod_um * np.exp(t * ln_s)
    wgt = np.exp(-0.5 * t * t)
    wgt = wgt / np.sum(wgt)

    mu = np.asarray(mu, dtype=np.float64)
    k = 2.0 * np.pi / wavelength_um
    sig_e = 0.0
    sig_s = 0.0
    s11 = np.zeros(mu.size)
    s12 = np.zeros(mu.size)
    s33 = np.zeros(mu.size)
    s34 = np.zeros(mu.size)
    for ri, wi in zip(r, wgt):
        x = k * ri
        if x < 1e-4:
            continue
        _Qext, _Qsca, S1, S2 = mie_single(float(x), m, mu)
        geo = np.pi * ri * ri
        sig_e += wi * _Qext * geo
        sig_s += wi * _Qsca * geo
        # Stokes scattering-matrix elements for spheres (Bohren &
        # Huffman 4.77), in units of 1/k^2, ensemble-averaged by number
        a1 = np.abs(S1) ** 2
        a2 = np.abs(S2) ** 2
        cross = S2 * np.conj(S1)
        s11 += wi * 0.5 * (a1 + a2)
        s12 += wi * 0.5 * (a2 - a1)
        s33 += wi * cross.real
        s34 += wi * cross.imag
    # phase matrix with the 1-normalization: integral over the sphere of
    # P11 / (4 pi) d Omega = 1 — enforced exactly on the supplied grid
    half_int = np.trapezoid(s11, mu) / 2.0
    scale = 1.0 / half_int
    return {
        "sigma_ext": sig_e,
        "sigma_sca": sig_s,
        "P11": s11 * scale,
        "P12": s12 * scale,
        "P33": s33 * scale,
        "P34": s34 * scale,
    }
