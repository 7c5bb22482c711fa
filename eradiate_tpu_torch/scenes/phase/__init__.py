# Host-code copy of eradiate_tpu/scenes/phase/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""Phase function scene elements.

Mirror of ``src/eradiate/scenes/phase/`` (factory at ``_core.py:11-41``:
blend_phase, hg, isotropic, rayleigh, tab_phase). Elements compile to
(kind, params) pairs for :mod:`eradiate_tpu.ops.phase_ops`; parameter
leaves carry a leading spectral axis [S, ...] plus a layer axis where the
property varies with altitude.
"""

from __future__ import annotations

import attrs
import numpy as np

from ..core import Factory, SceneElement

__all__ = [
    "PhaseFunction",
    "RayleighPhaseFunction",
    "HenyeyGreensteinPhaseFunction",
    "IsotropicPhaseFunction",
    "TabulatedPhaseFunction",
    "BlendPhaseFunction",
    "phase_function_factory",
]

phase_function_factory = Factory("phase")


@attrs.define(eq=False, slots=False)
class PhaseFunction(SceneElement):
    """Base phase function element."""

    def compile(self, w_nm, n_layers: int) -> tuple:
        """Return (kind, params) with params leaves shaped [S, ...]."""
        raise NotImplementedError


@phase_function_factory.register("rayleigh")
@attrs.define(eq=False, slots=False)
class RayleighPhaseFunction(PhaseFunction):
    """Rayleigh phase function with optional depolarization
    (``scenes/phase/_rayleigh.py:20``).

    ``depolarization``: scalar, array over layers, 'bates'/'bodhaine', or a
    callable (w, n_layers) -> [S, L].
    """

    depolarization: object = 0.0

    def compile(self, w_nm, n_layers: int) -> tuple:
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        S = w.size
        d = self.depolarization
        if callable(d):
            depol = np.asarray(d(w, n_layers))
        elif isinstance(d, str):
            from ...physics.rayleigh import (
                depolarization_bates,
                depolarization_bodhaine,
            )

            fn = {"bates": depolarization_bates, "bodhaine": depolarization_bodhaine}[d]
            depol = np.broadcast_to(fn(w)[:, None], (S, n_layers)).copy()
        else:
            arr = np.atleast_1d(np.asarray(d, dtype=np.float64))
            if arr.size == 1:
                depol = np.full((S, n_layers), float(arr.reshape(())))
            else:
                depol = np.broadcast_to(arr[None, :], (S, n_layers)).copy()
        return "rayleigh", {"depol": depol}


@phase_function_factory.register("hg")
@attrs.define(eq=False, slots=False)
class HenyeyGreensteinPhaseFunction(PhaseFunction):
    """Henyey-Greenstein (``scenes/phase/_hg.py:13``)."""

    g: float = 0.0

    def compile(self, w_nm, n_layers: int) -> tuple:
        w = np.atleast_1d(np.asarray(w_nm))
        return "hg", {"g": np.full(w.shape, float(self.g))}


@phase_function_factory.register("isotropic")
@attrs.define(eq=False, slots=False)
class IsotropicPhaseFunction(PhaseFunction):
    """Isotropic (``scenes/phase/_isotropic.py:6``)."""

    def compile(self, w_nm, n_layers: int) -> tuple:
        w = np.atleast_1d(np.asarray(w_nm))
        return "isotropic", {"_": np.zeros(w.shape)}


@phase_function_factory.register("tab_phase")
@attrs.define(eq=False, slots=False)
class TabulatedPhaseFunction(PhaseFunction):
    """Tabulated phase function over mu = cos(theta)
    (``scenes/phase/_tabulated.py:52``; kernel plugins ``tabphase`` /
    ``tabphase_irregular``).

    ``mu``: [M] ascending; ``data``: values [W, M] (or [M]) on wavelengths
    ``wavelengths`` [W]; linear interpolation in wavelength. Values are
    renormalized so the phase function integrates to 1 over the sphere.
    """

    mu: np.ndarray = attrs.field(default=None)
    data: np.ndarray = attrs.field(default=None)
    wavelengths: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.data = np.atleast_2d(np.asarray(self.data, dtype=np.float64))
        if self.wavelengths is None:
            self.wavelengths = np.array([550.0])
        else:
            self.wavelengths = np.atleast_1d(
                np.asarray(self.wavelengths, dtype=np.float64)
            )

    def compile(self, w_nm, n_layers: int) -> tuple:
        from ...ops.phase_ops import tab_phase_tables, theta_grid_params

        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        S = w.size
        M = self.mu.size
        # interpolate data in wavelength -> [S, M]
        vals = np.empty((S, M))
        for j in range(M):
            vals[:, j] = np.interp(
                w, self.wavelengths, self.data[:, j],
                left=self.data[0, j], right=self.data[-1, j],
            )
        v, cdf = tab_phase_tables(self.mu, vals)
        mu = np.broadcast_to(self.mu[None, :], (S, M)).copy()
        params = {"mu": mu, "values": v, "cdf": cdf}
        tg = theta_grid_params(self.mu)
        if tg is not None:
            # arithmetic eval index on theta-uniform grids (ops/phase_ops
            # .tab_eval); [S]-shaped so the per-row lax.map slices them
            params["tg0"] = np.full(S, tg[0])
            params["itg"] = np.full(S, tg[1])
        return "tab", params


@phase_function_factory.register("tab_phase_polarized")
@attrs.define(eq=False, slots=False)
class TabulatedPolarizedPhaseFunction(PhaseFunction):
    """Tabulated POLARIZED phase matrix over mu = cos(theta)
    (``scenes/phase/_tabulated.py:208-255``; kernel plugin
    ``tabphase_polarized``).

    Rows for a block-diagonal Mueller matrix of randomly-oriented
    particles: ``m11`` (the scalar phase), ``m12``, ``m22``, ``m33``,
    ``m34``, ``m44`` — each [W, M] (or [M]). Spheres (Mie) have
    m22 = m11 and m44 = m33; omit those to default accordingly. All rows
    share the m11 normalization (phase integrates to 1 over the sphere,
    ratios preserved). Scalar modes see the m11 row only; polarized
    tracers consume the full matrix (``ops/tracer_polarized.
    _tab_polarized_mueller``).
    """

    mu: np.ndarray = attrs.field(default=None)
    m11: np.ndarray = attrs.field(default=None)
    m12: np.ndarray = attrs.field(default=None)
    m22: np.ndarray = attrs.field(default=None)
    m33: np.ndarray = attrs.field(default=None)
    m34: np.ndarray = attrs.field(default=None)
    m44: np.ndarray = attrs.field(default=None)
    wavelengths: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        self.mu = np.asarray(self.mu, dtype=np.float64)
        self.m11 = np.atleast_2d(np.asarray(self.m11, dtype=np.float64))
        z = np.zeros_like(self.m11)
        self.m12 = (
            z if self.m12 is None
            else np.atleast_2d(np.asarray(self.m12, dtype=np.float64))
        )
        self.m22 = (
            self.m11 if self.m22 is None
            else np.atleast_2d(np.asarray(self.m22, dtype=np.float64))
        )
        self.m33 = (
            z if self.m33 is None
            else np.atleast_2d(np.asarray(self.m33, dtype=np.float64))
        )
        self.m34 = (
            z if self.m34 is None
            else np.atleast_2d(np.asarray(self.m34, dtype=np.float64))
        )
        self.m44 = (
            self.m33 if self.m44 is None
            else np.atleast_2d(np.asarray(self.m44, dtype=np.float64))
        )
        if self.wavelengths is None:
            self.wavelengths = np.array([550.0])
        else:
            self.wavelengths = np.atleast_1d(
                np.asarray(self.wavelengths, dtype=np.float64)
            )

    def compile(self, w_nm, n_layers: int) -> tuple:
        from ...ops.phase_ops import tab_phase_tables, theta_grid_params

        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        S = w.size
        M = self.mu.size

        def interp_rows(data):
            vals = np.empty((S, M))
            for j in range(M):
                vals[:, j] = np.interp(
                    w, self.wavelengths, data[:, j],
                    left=data[0, j], right=data[-1, j],
                )
            return vals

        m11 = interp_rows(self.m11)
        v, cdf = tab_phase_tables(self.mu, m11)
        # one normalization factor per (row, mu): keep the Mueller ratios
        ratio = np.divide(v, m11, out=np.ones_like(v), where=m11 != 0)
        params = {
            "mu": np.broadcast_to(self.mu[None, :], (S, M)).copy(),
            "values": v,
            "cdf": cdf,
            "m12": interp_rows(self.m12) * ratio,
            "m22": interp_rows(self.m22) * ratio,
            "m33": interp_rows(self.m33) * ratio,
            "m34": interp_rows(self.m34) * ratio,
            "m44": interp_rows(self.m44) * ratio,
        }
        tg = theta_grid_params(self.mu)
        if tg is not None:
            params["tg0"] = np.full(S, tg[0])
            params["itg"] = np.full(S, tg[1])
        return "tab_polarized", params


@phase_function_factory.register("blend_phase")
@attrs.define(eq=False, slots=False)
class BlendPhaseFunction(PhaseFunction):
    """N-component mixture with per-layer weights
    (``scenes/phase/_blend.py:21``; kernel plugin ``blendphase``).

    ``components``: list of phase functions (or dicts); ``weights``: [C, L]
    or [C] arrays (normalized per layer at compile time).
    """

    components: list = attrs.field(factory=list)
    weights: np.ndarray = attrs.field(default=None)

    def __attrs_post_init__(self):
        self.components = [
            phase_function_factory.convert(c, PhaseFunction) for c in self.components
        ]

    def compile_blend(self, w_nm, n_layers: int):
        """Return (kinds, params_list, weights [S, C, L])."""
        w = np.atleast_1d(np.asarray(w_nm, dtype=np.float64))
        S = w.size
        C = len(self.components)
        wt = np.asarray(self.weights, dtype=np.float64)
        if wt.ndim == 1:
            wt = np.broadcast_to(wt[:, None], (C, n_layers)).copy()
        if wt.ndim == 2:
            wt = np.broadcast_to(wt[None, :, :], (S, C, n_layers)).copy()
        norm = np.sum(wt, axis=1, keepdims=True)
        wt = np.divide(wt, norm, out=np.full_like(wt, 1.0 / C), where=norm > 0)
        kinds, params = [], []
        for comp in self.components:
            k, p = comp.compile(w, n_layers)
            kinds.append(k)
            params.append(p)
        return tuple(kinds), tuple(params), wt

    def compile(self, w_nm, n_layers: int):
        raise TypeError(
            "BlendPhaseFunction compiles via compile_blend() at the "
            "atmosphere level"
        )
