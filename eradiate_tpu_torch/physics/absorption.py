# Host-code copy of eradiate_tpu/physics/absorption.py; regenerate with tools/copy_host_code.py, do not edit.
"""Molecular absorption databases.

Replaces the reference's external ``axsdb`` dependency (see SURVEY §2.3):
chunked absorption-coefficient tables k(w[, g], p, T, x_species) with
multilinear interpolation at the atmospheric state.

Native format: ``.npz`` archives with arrays

- mono: ``w`` (W,) [nm], ``p`` (P,) [Pa], ``t`` (T,) [K], and per-species
  mole-fraction axes ``x_<M>`` (X_M,), plus ``sigma_a`` of shape
  (W, P, T[, X_M...]) in km^-1 *per unit mole fraction* when species axes
  are present, else absolute km^-1.
- ckd: same, with ``w`` replaced by bin axes ``wmin``/``wmax``/``wcenter``
  (B,) and a g axis ``g`` (G,): ``sigma_a`` of shape (B, G, P, T, ...).

Known reference database names (``radprops/_absorption.py:31-58``) are
resolved through the data store when installed; otherwise an informative
error suggests the synthetic test database generator
(:func:`make_synthetic_mono_db` / :func:`make_synthetic_ckd_db`).

Interpolation policy mirrors axsdb's ErrorHandlingConfiguration: per-axis
``bounds`` policy 'raise' | 'clamp' | 'zero' for out-of-range (p, T, x).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "AbsorptionDatabase",
    "MonoAbsorptionDatabase",
    "CKDAbsorptionDatabase",
    "ErrorHandlingConfiguration",
    "make_synthetic_mono_db",
    "make_synthetic_ckd_db",
    "open_database",
    "KNOWN_DATABASES",
]

#: Known reference database ids (mirror of ``radprops/_absorption.py:31-58``)
KNOWN_DATABASES = {
    "gecko": "mono",
    "komodo": "mono",
    "monotropa": "ckd",
    "mycena": "ckd",
    "panellus": "ckd",
    "tuber": "ckd",
}


@dataclass(frozen=True)
class ErrorHandlingConfiguration:
    """Out-of-bounds interpolation policy per coordinate (p, t, x)."""

    p: str = "clamp"  # 'raise' | 'clamp' | 'zero'
    t: str = "clamp"
    x: str = "clamp"

    @classmethod
    def convert(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            def pick(d):
                # accept {'missing': ..., 'scalar': ...} axsdb-style dicts
                if isinstance(d, dict):
                    return d.get("bounds", "clamp")
                return d

            return cls(
                p=pick(value.get("p", "clamp")),
                t=pick(value.get("t", "clamp")),
                x=pick(value.get("x", "clamp")),
            )
        raise ValueError(f"cannot convert {value!r}")


def _axis_indices(axis, values, policy, name):
    """Return (i0, frac, inside) for linear interpolation on a 1D axis."""
    v = np.asarray(values, dtype=np.float64)
    inside = (v >= axis[0]) & (v <= axis[-1])
    if policy == "raise" and not np.all(inside):
        bad = v[~inside]
        raise ValueError(
            f"absorption DB interpolation out of bounds on axis '{name}': "
            f"{bad[:5]} outside [{axis[0]}, {axis[-1]}]"
        )
    vc = np.clip(v, axis[0], axis[-1])
    i0 = np.clip(np.searchsorted(axis, vc, side="right") - 1, 0, axis.size - 2)
    denom = axis[i0 + 1] - axis[i0]
    frac = np.where(denom > 0, (vc - axis[i0]) / np.where(denom > 0, denom, 1.0), 0.0)
    return i0, frac, inside


class AbsorptionDatabase:
    """Common interpolation machinery over (p, T) and optional species axes."""

    def __init__(self, data: dict, error_handling=None):
        self._d = data
        self.error_handling = ErrorHandlingConfiguration.convert(
            error_handling or ErrorHandlingConfiguration()
        )
        self._species = sorted(
            k[2:] for k in data.keys() if k.startswith("x_")
        )

    @property
    def species(self):
        return list(self._species)

    def _interp_pt(self, table, p_pa, t_k, x=None):
        """Interpolate table (..., P, T[, X...]) at per-level states.

        ``table`` leading axes are spectral; trailing axes are (P, T, X...).
        Returns array of shape table.shape[:-n_state] + (Nz,).
        """
        eh = self.error_handling
        p_ax = self._d["p"]
        t_ax = self._d["t"]
        ip, fp, in_p = _axis_indices(p_ax, p_pa, eh.p, "p")
        it, ft, in_t = _axis_indices(t_ax, t_k, eh.t, "t")

        n_state = 2 + len(self._species)
        spectral_shape = table.shape[:-n_state]
        flat = table.reshape((-1,) + table.shape[-n_state:])

        # Bilinear in (p, T); then linear per species axis if present.
        def gather_pt(a):  # a: (F, P, T, X...)
            c00 = a[:, ip, it]
            c01 = a[:, ip, it + 1]
            c10 = a[:, ip + 1, it]
            c11 = a[:, ip + 1, it + 1]
            # moveaxis: result (F, Nz, X...)
            w00 = (1 - fp) * (1 - ft)
            w01 = (1 - fp) * ft
            w10 = fp * (1 - ft)
            w11 = fp * ft
            bshape = (1, -1) + (1,) * (c00.ndim - 2)
            return (
                c00 * w00.reshape(bshape)
                + c01 * w01.reshape(bshape)
                + c10 * w10.reshape(bshape)
                + c11 * w11.reshape(bshape)
            )

        out = gather_pt(flat)  # (F, Nz, X...)
        for si, sp in enumerate(self._species):
            ax = self._d[f"x_{sp}"]
            xv = (x or {}).get(sp)
            if xv is None:
                xv = np.full(np.asarray(p_pa).shape, ax[0])
            if ax.size == 1:
                out = out[..., 0]
                continue
            ix, fx, _ = _axis_indices(ax, xv, eh.x, f"x_{sp}")
            nz = np.arange(len(ix))
            lo = out[:, nz, ..., ix] if out.ndim > 3 else out[:, nz, ix]
            hi = out[:, nz, ..., ix + 1] if out.ndim > 3 else out[:, nz, ix + 1]
            fxb = fx.reshape((1, -1) + (1,) * (lo.ndim - 2))
            out = lo * (1 - fxb) + hi * fxb
        # zero policy outside bounds
        mask = np.ones_like(np.asarray(p_pa), dtype=bool)
        if eh.p == "zero":
            mask &= in_p
        if eh.t == "zero":
            mask &= in_t
        out = np.where(mask.reshape((1, -1)), out, 0.0)
        return out.reshape(spectral_shape + (len(np.asarray(p_pa)),))


class MonoAbsorptionDatabase(AbsorptionDatabase):
    """Monochromatic absorption DB: sigma_a(w, p, T[, x])."""

    kind = "mono"

    @property
    def wavelengths(self):
        return self._d["w"]

    def spectral_coverage(self):
        return float(self._d["w"][0]), float(self._d["w"][-1])

    def eval_sigma_a(self, w_nm, thermoprofile) -> np.ndarray:
        """sigma_a (S, Nz) [km^-1] at wavelengths w_nm and profile state."""
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        w_ax = self._d["w"]
        iw, fw, _ = _axis_indices(w_ax, w, "clamp", "w")
        table = self._d["sigma_a"]
        # interpolate (p, T, x) first on full spectral table is wasteful for
        # large W; slice the two bracketing spectral rows only.
        rows = np.unique(np.concatenate([iw, iw + 1]))
        sub = table[rows]
        remap = np.searchsorted(rows, iw)
        out_rows = self._interp_pt(
            sub, thermoprofile.p, thermoprofile.t, thermoprofile.x
        )
        lo = out_rows[remap]
        hi = out_rows[np.searchsorted(rows, iw + 1)]
        return lo * (1.0 - fw[:, None]) + hi * fw[:, None]


class CKDAbsorptionDatabase(AbsorptionDatabase):
    """CKD absorption DB: sigma_a(bin, g, p, T[, x])."""

    kind = "ckd"

    @property
    def wcenters(self):
        return self._d["wcenter"]

    def spectral_coverage(self):
        return float(self._d["wmin"][0]), float(self._d["wmax"][-1])

    def spectral_grid(self):
        from ..spectral.grid import CKDSpectralGrid

        return CKDSpectralGrid(self._d["wmin"], self._d["wmax"], self._d["wcenter"])

    def error_data(self, wcenter):
        """Per-bin adaptive-quadrature metadata: {ng: relative band-
        transmittance error} for the bin nearest ``wcenter``, or None when
        the database ships no ``error``/``error_ng`` arrays (mirror of the
        reference's transmittance-error variable consumed by
        ``src/eradiate/spectral/ckd_quad.py:80-183``)."""
        if "error" not in self._d or "error_ng" not in self._d:
            return None
        i = int(np.argmin(np.abs(self._d["wcenter"] - float(wcenter))))
        ngs = np.asarray(self._d["error_ng"], dtype=int)
        errs = np.asarray(self._d["error"])[i]
        return {int(n): float(e) for n, e in zip(ngs, errs)}

    def eval_sigma_a_bin_g(self, wcenter_nm, g, thermoprofile) -> np.ndarray:
        """sigma_a (S, Nz) for paired arrays of bin centers + g values."""
        wc = np.atleast_1d(np.asarray(wcenter_nm, dtype=np.float64))
        gv = np.atleast_1d(np.asarray(g, dtype=np.float64))
        w_ax = self._d["wcenter"]
        ib = np.argmin(np.abs(w_ax[None, :] - wc[:, None]), axis=1)
        g_ax = self._d["g"]
        ig, fg, _ = _axis_indices(g_ax, gv, "clamp", "g")
        table = self._d["sigma_a"]  # (B, G, P, T, X...)
        # gather needed (bin, g) and (bin, g+1) rows
        sub_lo = table[ib, ig]
        sub_hi = table[ib, ig + 1]
        lo = self._interp_pt(sub_lo, thermoprofile.p, thermoprofile.t, thermoprofile.x)
        hi = self._interp_pt(sub_hi, thermoprofile.p, thermoprofile.t, thermoprofile.x)
        return lo * (1.0 - fg[:, None]) + hi * fg[:, None]

    # RadProfile-compatible entry point: treats w as (wcenter, g) pairs set
    # by the spectral loop through eval context arrays.
    def eval_sigma_a(self, w_nm, thermoprofile, g=None):
        if g is None:
            g = np.zeros_like(np.asarray(w_nm))
        return self.eval_sigma_a_bin_g(w_nm, g, thermoprofile)


def open_database(path_or_id, error_handling=None) -> AbsorptionDatabase:
    """Open an absorption DB from a known id, a native ``.npz``, a
    reference-format NetCDF file, or a database directory of NetCDF chunks
    (the reference/AxsDB on-disk layout —
    ``docs/data/absorption_databases.rst:17-24``; see
    :mod:`eradiate_tpu.data.absorption_io`)."""
    import os

    path = str(path_or_id)
    if path in KNOWN_DATABASES:
        from ..data import resolve_data

        # native import first, then a raw reference-layout directory
        resolved = resolve_data(f"absorption/{path}.npz") or resolve_data(
            f"absorption_{KNOWN_DATABASES[path]}/{path}"
        )
        if resolved is None:
            raise FileNotFoundError(
                f"absorption database '{path}' is not installed in the data "
                f"store; install it (native absorption/{path}.npz or the "
                f"reference-layout absorption_{KNOWN_DATABASES[path]}/{path}/ "
                f"NetCDF directory) or use "
                f"make_synthetic_{KNOWN_DATABASES[path]}_db() for testing"
            )
        path = str(resolved)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path) or path.endswith(".nc"):
        from ..data.absorption_io import load_absorption_netcdf

        return load_absorption_netcdf(path, error_handling)
    npz = np.load(path)
    data = {k: npz[k] for k in npz.files}
    if "g" in data:
        return CKDAbsorptionDatabase(data, error_handling)
    return MonoAbsorptionDatabase(data, error_handling)


def absdb_converter(value, error_handling=None):
    """Convert user input to an AbsorptionDatabase (id/path/instance/None)."""
    if value is None or isinstance(value, AbsorptionDatabase):
        return value
    return open_database(value, error_handling)


# ---------------------------------------------------------------------------
# Synthetic databases for tests and benchmarks
# ---------------------------------------------------------------------------


def make_synthetic_mono_db(
    w_nm=None, p_pa=None, t_k=None, base_sigma=1e-3, seed=0,
    species=None, x_axis=None,
) -> MonoAbsorptionDatabase:
    """Small analytic mono DB: smooth sigma_a(w, p, T) for testing.

    ``species``: optional species name; adds a mole-fraction axis
    ``x_<species>`` (default 9 points spanning [0, 0.02]) with sigma_a
    EXACTLY proportional to x (normalized at x = 5e-3), so concentration
    channels have a closed-form behavior: scaling x scales sigma_a, and
    for an absorption-only medium ``gas.<species>`` coincides with
    ``medium.tau_scale``. Used by the per-species sensitivity gates
    (tests/unit/test_sensitivity.py)."""
    w = np.asarray(w_nm if w_nm is not None else np.linspace(340.0, 2510.0, 64))
    p = np.asarray(p_pa if p_pa is not None else np.logspace(-1, 5.02, 24))
    t = np.asarray(t_k if t_k is not None else np.linspace(160.0, 330.0, 12))
    rng = np.random.default_rng(seed)
    lines = rng.uniform(w[0], w[-1], 24)
    widths = rng.uniform(5.0, 60.0, 24)
    amps = rng.uniform(0.2, 1.0, 24)
    spectrum = np.zeros_like(w)
    for c, s, a in zip(lines, widths, amps):
        spectrum += a * np.exp(-0.5 * ((w - c) / s) ** 2)
    # pressure/temperature scaling ~ (p/p0) * sqrt(T0/T)
    sig = (
        base_sigma
        * spectrum[:, None, None]
        * (p[None, :, None] / 101325.0)
        * np.sqrt(296.0 / t[None, None, :])
    )
    data = {"w": w, "p": p, "t": t, "sigma_a": sig}
    if species is not None:
        x = np.asarray(
            x_axis if x_axis is not None else np.linspace(0.0, 0.02, 9)
        )
        data[f"x_{species}"] = x
        data["sigma_a"] = sig[..., None] * (x / 5e-3)
    return MonoAbsorptionDatabase(data)


def _kg_quad_errors(kg_of_g, ngs, tau_scale=2.0):
    """Relative band-transmittance error of GL quadrature vs a fine
    reference: err(ng) = |T_ng - T| / T with T = int exp(-k(g) X) dg at a
    nominal column X putting the band's peak optical depth at
    ``tau_scale``. This is the adaptive-policy metadata the reference's
    databases ship (``spectral/ckd_quad.py:121-183``)."""
    from ..core.quad import Quad

    g_fine = np.linspace(0.0, 1.0, 4001)
    k_fine = kg_of_g(g_fine)
    X = tau_scale / max(float(np.max(k_fine)), 1e-30)
    T_ref = np.trapezoid(np.exp(-k_fine * X), g_fine)
    errs = []
    for n in ngs:
        q = Quad.new("gauss_legendre", int(n))
        nodes = q.eval_nodes((0.0, 1.0))
        T_q = float(np.sum(q.weights / 2.0 * np.exp(-kg_of_g(nodes) * X)))
        errs.append(abs(T_q - T_ref) / max(T_ref, 1e-30))
    return np.asarray(errs)


def make_synthetic_ckd_db(
    wmin_nm=None, wmax_nm=None, ng=16, p_pa=None, t_k=None, base_sigma=1e-3,
    seed=0, with_error_data=False,
) -> CKDAbsorptionDatabase:
    """Small analytic CKD DB: per-bin k-distributions k(g) increasing in g.

    ``with_error_data=True`` attaches per-bin quadrature error estimates
    (``error_ng`` candidates 1..ng, ``error`` [B, len(ngs)]) so the
    adaptive MINIMIZE_ERROR / ERROR_THRESHOLD policies are exercised
    (VERDICT r1, Missing #6)."""
    if wmin_nm is None:
        edges = np.arange(350.0, 2510.0, 10.0)
        wmin_nm, wmax_nm = edges[:-1], edges[1:]
    wmin = np.asarray(wmin_nm, dtype=np.float64)
    wmax = np.asarray(wmax_nm, dtype=np.float64)
    wc = 0.5 * (wmin + wmax)
    g = np.linspace(0.0, 1.0, ng)
    p = np.asarray(p_pa if p_pa is not None else np.logspace(-1, 5.02, 24))
    t = np.asarray(t_k if t_k is not None else np.linspace(160.0, 330.0, 12))
    rng = np.random.default_rng(seed)
    band_amp = base_sigma * rng.uniform(0.05, 1.0, wc.size)
    # k(g) = amp * (exp(a g) - 1) — increasing k-distribution shape;
    # larger a = sharper distribution = harder quadrature
    a = rng.uniform(2.0, 8.0, wc.size)
    kg = band_amp[:, None] * (np.exp(a[:, None] * g[None, :]) - 1.0) / (np.exp(a[:, None]) - 1.0)
    sig = (
        kg[:, :, None, None]
        * (p[None, None, :, None] / 101325.0)
        * np.sqrt(296.0 / t[None, None, None, :])
    )
    data = {
        "wmin": wmin, "wmax": wmax, "wcenter": wc, "g": g, "p": p, "t": t,
        "sigma_a": sig,
    }
    if with_error_data:
        ngs = np.arange(1, ng + 1)
        err = np.stack([
            _kg_quad_errors(
                lambda gv, A=band_amp[b], aa=a[b]: A
                * (np.exp(aa * gv) - 1.0)
                / (np.exp(aa) - 1.0),
                ngs,
            )
            for b in range(wc.size)
        ])
        data["error_ng"] = ngs
        data["error"] = err
    return CKDAbsorptionDatabase(data)
