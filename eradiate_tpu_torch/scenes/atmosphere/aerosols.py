# Host-code copy of eradiate_tpu/scenes/atmosphere/aerosols.py; regenerate with tools/copy_host_code.py, do not edit.
"""Aerosol single-scattering property datasets.

Replaces the reference's downloaded aerosol datasets (e.g.
``govaerts_2021-continental``, used by ``ParticleLayer``,
``scenes/atmosphere/_particle_layer.py:51``). Native format ``.npz``
(``aerosol/<id>.npz``): arrays ``w`` [nm], ``sigma_t`` (arbitrary
normalization — only the ratio to the reference wavelength matters),
``albedo`` [W], ``mu`` [M] ascending, ``phase`` [W, M] (unpolarized; the
polarized Mueller components ship as ``phase_ij`` arrays).

When a named dataset is not installed, built-in analytic surrogates provide
plausible continental/maritime aerosol optics (Angstrom-law extinction +
double-HG phase) so workloads remain runnable offline; they are clearly
labeled as surrogates and are NOT the reference datasets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ParticleDataset", "load_particle_dataset"]


@dataclass
class ParticleDataset:
    id: str
    w: np.ndarray  # [W] nm
    sigma_t: np.ndarray  # [W] relative extinction
    albedo: np.ndarray  # [W]
    mu: np.ndarray  # [M]
    phase: np.ndarray  # [W, M]
    #: optional polarized Mueller rows (block-diagonal, randomly-oriented
    #: particles); spheres have m22 = m11 and m44 = m33, so Mie datasets
    #: ship only 12/33/34
    phase_12: np.ndarray = None  # [W, M]
    phase_33: np.ndarray = None
    phase_34: np.ndarray = None

    def eval_sigma_t_ratio(self, w_nm, w_ref_nm) -> np.ndarray:
        """sigma_t(w) / sigma_t(w_ref): spectral extinction shape."""
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        s = np.interp(w, self.w, self.sigma_t)
        s_ref = np.interp(float(w_ref_nm), self.w, self.sigma_t)
        return s / s_ref

    def eval_albedo(self, w_nm) -> np.ndarray:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        return np.interp(w, self.w, self.albedo)


def _double_hg(mu, g1, g2, f):
    def hg(g):
        return (1.0 - g * g) / (
            4.0 * np.pi * (1.0 + g * g - 2.0 * g * mu) ** 1.5
        )

    # forward lobe g1 + backward lobe g2 (mu here = cos of scattering angle)
    return f * hg(g1) + (1.0 - f) * hg(g2)


def _surrogate(ident: str) -> ParticleDataset:
    """Analytic surrogate datasets (documented stand-ins, see module doc)."""
    w = np.linspace(250.0, 2500.0, 64)
    mu = np.linspace(-1.0, 1.0, 181)
    if "continental" in ident or ident == "default":
        alpha = 1.3  # Angstrom exponent
        albedo0 = 0.95
        g1, g2, f = 0.70, -0.35, 0.96
    elif "maritime" in ident or "sea" in ident:
        alpha = 0.5
        albedo0 = 0.99
        g1, g2, f = 0.78, -0.3, 0.97
    elif "desert" in ident or "dust" in ident:
        alpha = 0.2
        albedo0 = 0.90
        g1, g2, f = 0.75, -0.4, 0.95
    else:
        alpha = 1.0
        albedo0 = 0.95
        g1, g2, f = 0.7, -0.35, 0.96
    sigma_t = (w / 550.0) ** (-alpha)
    albedo = np.full(w.shape, albedo0) - 0.05 * (w / 2500.0)
    phase = np.broadcast_to(_double_hg(mu, g1, g2, f)[None, :], (w.size, mu.size)).copy()
    return ParticleDataset(
        id=f"surrogate-{ident}", w=w, sigma_t=sigma_t, albedo=albedo, mu=mu, phase=phase
    )


def particle_dataset_from_xarray(ds, ident="from_xarray") -> ParticleDataset:
    """Build a ParticleDataset from an xarray particle dataset
    (``sigma_t`` [w], ``albedo`` [w], ``phase`` [w, mu] or [w, mu, i, j]) —
    the format produced by
    :func:`eradiate_tpu.data.io.load_aerosol_libradtran` and by the
    reference's aerosol files (``data/schemas/particle_dataset_v1.yml``).
    4x4 phase data additionally carries the block-diagonal Mueller rows
    (P12/P33/P34) consumed by polarized modes."""
    phase = np.asarray(ds["phase"].values, dtype=np.float64)
    p12 = p33 = p34 = None
    if phase.ndim == 4:
        p12 = phase[:, :, 0, 1]
        p33 = phase[:, :, 2, 2]
        p34 = phase[:, :, 2, 3]
        phase = phase[:, :, 0, 0]
    mu = np.asarray(ds["mu"].values, dtype=np.float64)
    order = np.argsort(mu)
    return ParticleDataset(
        id=str(ds.attrs.get("id", ident)),
        w=np.asarray(ds["w"].values, dtype=np.float64),
        sigma_t=np.asarray(ds["sigma_t"].values, dtype=np.float64),
        albedo=np.asarray(ds["albedo"].values, dtype=np.float64),
        mu=mu[order],
        phase=phase[:, order],
        phase_12=None if p12 is None else p12[:, order],
        phase_33=None if p33 is None else p33[:, order],
        phase_34=None if p34 is None else p34[:, order],
    )


def load_particle_dataset(identifier: str) -> ParticleDataset:
    """Load an aerosol dataset by id; falls back to analytic surrogates."""
    from ...data import resolve_data

    path = resolve_data(f"aerosol/{identifier}.npz")
    if path is not None:
        d = np.load(path)
        return ParticleDataset(
            id=identifier,
            w=d["w"],
            sigma_t=d["sigma_t"],
            albedo=d["albedo"],
            mu=d["mu"],
            phase=d["phase"],
            phase_12=d["phase_12"] if "phase_12" in d.files else None,
            phase_33=d["phase_33"] if "phase_33" in d.files else None,
            phase_34=d["phase_34"] if "phase_34" in d.files else None,
        )
    return _surrogate(identifier)
