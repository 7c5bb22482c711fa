# Host-code copy of eradiate_tpu/scenes/bsdfs/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
"""BSDF scene elements.

Mirror of ``src/eradiate/scenes/bsdfs/`` (factory list at
``_core.py:10-27``): declarative BSDF descriptions whose spectral parameters
compile to per-spectral-index arrays consumed by
:mod:`eradiate_tpu.ops.bsdf_ops`.
"""

from __future__ import annotations

import attrs
import numpy as np

from ..core import Factory, SceneElement
from ..spectra import Spectrum, converter as spectrum_converter

__all__ = [
    "BSDF",
    "LambertianBSDF",
    "BlackBSDF",
    "RPVBSDF",
    "CheckerboardBSDF",
    "HapkeBSDF",
    "RTLSBSDF",
    "BiLambertianBSDF",
    "OceanLegacyBSDF",
    "BitmapBSDF",
    "OpacityMaskBSDF",
    "SelectBSDF",
    "bsdf_factory",
]

bsdf_factory = Factory("bsdf")


def _spec(default, quantity="dimensionless"):
    return attrs.field(
        default=default, converter=spectrum_converter(quantity)
    )


@attrs.define(eq=False, slots=False)
class BSDF(SceneElement):
    """Base BSDF element."""

    #: engine dispatch key (must be supported by ops.bsdf_ops)
    kind: str = attrs.field(default=None, init=False)

    def eval_params(self, w_nm) -> dict:
        """Spectral parameter arrays for the engine: name -> [S]."""
        raise NotImplementedError


@bsdf_factory.register("lambertian")
@attrs.define(eq=False, slots=False)
class LambertianBSDF(BSDF):
    """Lambertian BSDF (reference ``diffuse`` plugin,
    ``scenes/bsdfs/_lambertian.py:44``)."""

    reflectance: Spectrum = _spec(0.5, "reflectance")
    kind: str = attrs.field(default="lambertian", init=False)

    def eval_params(self, w_nm) -> dict:
        return {"reflectance": self.reflectance.eval(w_nm)}


@bsdf_factory.register("black")
@attrs.define(eq=False, slots=False)
class BlackBSDF(BSDF):
    """Perfect absorber (``scenes/bsdfs/_black.py``)."""

    kind: str = attrs.field(default="black", init=False)

    def eval_params(self, w_nm) -> dict:
        return {}


@bsdf_factory.register("rpv")
@attrs.define(eq=False, slots=False)
class RPVBSDF(BSDF):
    """Rahman-Pinty-Verstraete BRDF (``scenes/bsdfs/_rpv.py:15-110``).

    Defaults are the reference's grassland values (Rahman 1993 Table 1).
    """

    rho_0: Spectrum = _spec(0.183)
    k: Spectrum = _spec(0.780)
    g: Spectrum = _spec(-0.1)
    rho_c: Spectrum | None = attrs.field(
        default=None,
        converter=attrs.converters.optional(spectrum_converter("dimensionless")),
    )
    kind: str = attrs.field(default="rpv", init=False)

    def eval_params(self, w_nm) -> dict:
        rho_0 = self.rho_0.eval(w_nm)
        return {
            "rho_0": rho_0,
            "k": self.k.eval(w_nm),
            "g": self.g.eval(w_nm),
            "rho_c": self.rho_c.eval(w_nm) if self.rho_c is not None else rho_0,
        }


@bsdf_factory.register("checkerboard")
@attrs.define(eq=False, slots=False)
class CheckerboardBSDF(BSDF):
    """Checkerboard two-reflectance lambertian
    (``scenes/bsdfs/_checkerboard.py:71``)."""

    reflectance_a: Spectrum = _spec(0.2, "reflectance")
    reflectance_b: Spectrum = _spec(0.8, "reflectance")
    scale_pattern: float = 2.0
    kind: str = attrs.field(default="checkerboard", init=False)

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        return {
            "reflectance_a": self.reflectance_a.eval(w_nm),
            "reflectance_b": self.reflectance_b.eval(w_nm),
            "scale_pattern": np.full(w.shape, self.scale_pattern),
            "extent": np.full(w.shape, 1.0),
        }


@bsdf_factory.register("hapke")
@attrs.define(eq=False, slots=False)
class HapkeBSDF(BSDF):
    """Hapke soil photometric model (``scenes/bsdfs/_hapke.py:141``);
    parameters w, b, c, theta, B_0, h."""

    w: Spectrum = _spec(0.5)
    b: Spectrum = _spec(0.2)
    c: Spectrum = _spec(0.5)
    theta: Spectrum = _spec(np.deg2rad(30.0), "angle")
    B_0: Spectrum = _spec(0.0)
    h: Spectrum = _spec(0.0)
    kind: str = attrs.field(default="hapke", init=False)

    def eval_params(self, w_nm) -> dict:
        return {
            "w": self.w.eval(w_nm),
            "b": self.b.eval(w_nm),
            "c": self.c.eval(w_nm),
            "theta": self.theta.eval(w_nm),
            "B_0": self.B_0.eval(w_nm),
            "h": self.h.eval(w_nm),
        }


@bsdf_factory.register("rtls")
@attrs.define(eq=False, slots=False)
class RTLSBSDF(BSDF):
    """Ross-Thick Li-Sparse kernel BRDF (``scenes/bsdfs/_rtls.py``);
    parameters f_iso, f_vol, f_geo."""

    f_iso: Spectrum = _spec(0.209)
    f_vol: Spectrum = _spec(0.081)
    f_geo: Spectrum = _spec(0.004)
    kind: str = attrs.field(default="rtls", init=False)

    def eval_params(self, w_nm) -> dict:
        return {
            "f_iso": self.f_iso.eval(w_nm),
            "f_vol": self.f_vol.eval(w_nm),
            "f_geo": self.f_geo.eval(w_nm),
        }


@bsdf_factory.register("bilambertian")
@attrs.define(eq=False, slots=False)
class BiLambertianBSDF(BSDF):
    """Two-sided lambertian (leaf optics): reflectance + transmittance
    (reference ``bilambertian`` plugin, doc order ``rst_plugins.py:29-31``)."""

    reflectance: Spectrum = _spec(0.5, "reflectance")
    transmittance: Spectrum = _spec(0.0, "transmittance")
    kind: str = attrs.field(default="bilambertian", init=False)

    def eval_params(self, w_nm) -> dict:
        return {
            "reflectance": self.reflectance.eval(w_nm),
            "transmittance": self.transmittance.eval(w_nm),
        }


@bsdf_factory.register("mqdiffuse")
@attrs.define(eq=False, slots=False)
class MQDiffuseBSDF(BSDF):
    """Measured quasi-diffuse BRDF from gridded (theta_o, phi_d, theta_i)
    data (``scenes/bsdfs/_mqdiffuse.py:127``)."""

    data: np.ndarray = attrs.field(default=None)  # [Nto, Npd, Nti]
    kind: str = attrs.field(default="mqdiffuse", init=False)

    def __attrs_post_init__(self):
        self.data = np.asarray(self.data, dtype=np.float64)
        if self.data.ndim != 3:
            raise ValueError("mqdiffuse data must have shape (Nto, Npd, Nti)")

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        return {
            "data": np.broadcast_to(
                self.data[None, ...], (w.size,) + self.data.shape
            ).copy()
        }


@bsdf_factory.register("bitmap")
@attrs.define(eq=False, slots=False)
class BitmapBSDF(BSDF):
    """Spatially varying lambertian reflectance from a gridded map
    (reference stock ``bitmap`` texture under a ``diffuse`` BSDF). The map
    spans ``[-extent/2, extent/2]^2`` km and repeats outside; an optional
    spectral ``scale`` multiplies the map per wavelength."""

    data: np.ndarray = attrs.field(default=None)  # [H, W] reflectance
    extent: float = 1.0  # km
    scale: Spectrum = _spec(1.0)
    kind: str = attrs.field(default="bitmap", init=False)

    def __attrs_post_init__(self):
        self.data = np.atleast_2d(np.asarray(self.data, dtype=np.float64))

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        scale = np.atleast_1d(self.scale.eval(w_nm))
        return {
            "data": self.data[None, ...] * scale[:, None, None],
            "extent": np.full(w.shape, self.extent),
        }


@bsdf_factory.register("opacity_mask")
@attrs.define(eq=False, slots=False)
class OpacityMaskBSDF(BSDF):
    """Opacity-masked BSDF (reference ``mask`` plugin wrapper,
    ``scenes/bsdfs/_opacity_mask.py:88``): a nested BSDF modulated by a
    gridded opacity map over ``[-extent/2, extent/2]^2`` km. Opacity < 1
    passes light through the surface plane (lost below an opaque ground)."""

    nested_bsdf: BSDF = attrs.field(
        factory=lambda: LambertianBSDF(),
        converter=lambda v: bsdf_factory.convert(v) if isinstance(v, dict) else v,
    )
    opacity: np.ndarray = attrs.field(default=1.0)  # [H, W] map or scalar
    extent: float = 1.0  # km (reference ``uv_trafo`` analog)
    kind: str = attrs.field(default=None, init=False)

    def __attrs_post_init__(self):
        self.opacity = np.atleast_2d(np.asarray(self.opacity, dtype=np.float64))
        self.kind = f"opacity_mask:{self.nested_bsdf.kind}"

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        out = {
            f"nested_{k}": v for k, v in self.nested_bsdf.eval_params(w_nm).items()
        }
        out["opacity_map"] = np.broadcast_to(
            self.opacity[None, ...], (w.size,) + self.opacity.shape
        ).copy()
        out["mask_extent"] = np.full(w.shape, self.extent)
        return out


@bsdf_factory.register("selectbsdf")
@attrs.define(eq=False, slots=False)
class SelectBSDF(BSDF):
    """BSDF switch by gridded integer index (reference ``selectbsdf``
    expert plugin, release notes v0.29.x): ``index_map[j, i]`` selects
    which child BSDF applies at the surface point (nearest lookup over
    ``[-extent/2, extent/2]^2`` km)."""

    bsdfs: list = attrs.field(
        factory=lambda: [LambertianBSDF()],
        converter=lambda vs: [
            bsdf_factory.convert(v) if isinstance(v, dict) else v for v in vs
        ],
    )
    index_map: np.ndarray = attrs.field(default=0)  # [H, W] ints
    extent: float = 1.0  # km
    kind: str = attrs.field(default=None, init=False)

    def __attrs_post_init__(self):
        self.index_map = np.atleast_2d(np.asarray(self.index_map, dtype=np.float64))
        if not self.bsdfs:
            raise ValueError("selectbsdf needs at least one child BSDF")
        self.kind = "select:" + ":".join(b.kind for b in self.bsdfs)

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        out = {}
        for i, b in enumerate(self.bsdfs):
            for k, v in b.eval_params(w_nm).items():
                out[f"c{i}_{k}"] = v
        out["index_map"] = np.broadcast_to(
            self.index_map[None, ...], (w.size,) + self.index_map.shape
        ).copy()
        out["select_extent"] = np.full(w.shape, self.extent)
        return out


@bsdf_factory.register("maignan")
@attrs.define(eq=False, slots=False)
class MaignanBSDF(RPVBSDF):
    """Maignan (2009) polarized BRDF (``scenes/bsdfs/_maignan.py:105``):
    RPV scalar base plus the one-parameter Fresnel specular peak
    (Maignan 2009 Eq. 21; parameters C, ndvi, refr_re, refr_im, ext_ior
    mirror the reference plugin)."""

    C: Spectrum = _spec(5.0)
    ndvi: Spectrum = _spec(0.8)
    refr_re: Spectrum = _spec(1.5)
    refr_im: Spectrum = _spec(0.0)
    ext_ior: Spectrum = _spec(1.000277)
    kind: str = attrs.field(default="maignan", init=False)

    def eval_params(self, w_nm) -> dict:
        out = super().eval_params(w_nm)
        out.update(
            {
                "C": self.C.eval(w_nm),
                "ndvi": self.ndvi.eval(w_nm),
                "refr_re": self.refr_re.eval(w_nm),
                "refr_im": self.refr_im.eval(w_nm),
                "ext_ior": self.ext_ior.eval(w_nm),
            }
        )
        return out


@bsdf_factory.register("ocean_legacy")
@attrs.define(eq=False, slots=False)
class OceanLegacyBSDF(BSDF):
    """6SV-style ocean BRDF (``scenes/bsdfs/_ocean_legacy.py:100``):
    wind-driven glint + whitecaps + underlight."""

    wind_speed: float = 0.01  # m/s
    wind_azimuth: float = 0.0  # deg
    chlorinity: float = 19.0  # g/kg
    pigmentation: float = 0.3  # mg/m^3
    shininess: float = 50.0
    kind: str = attrs.field(default="ocean_legacy", init=False)

    def eval_params(self, w_nm) -> dict:
        from ...physics.ocean_data import case1_water_reflectance, water_ior

        w = np.atleast_1d(np.asarray(w_nm))
        return {
            "wind_speed": np.full(w.shape, self.wind_speed),
            "wind_azimuth": np.full(w.shape, np.deg2rad(self.wind_azimuth)),
            "chlorinity": np.full(w.shape, self.chlorinity),
            "pigmentation": np.full(w.shape, self.pigmentation),
            "wavelength": w.astype(np.float64),
            # 6SV-heritage tables (Hale & Querry IOR; Morel case-1
            # underlight from Pope & Fry + Prieur-Sathyendranath),
            # evaluated host-side per spectral row
            "n_water": water_ior(w, self.chlorinity),
            "r_water": case1_water_reflectance(w, self.pigmentation),
        }


@bsdf_factory.register("ocean_grasp")
@attrs.define(eq=False, slots=False)
class OceanGraspBSDF(BSDF):
    """GRASP-convention ocean BRDF (``scenes/bsdfs/_ocean_grasp.py``):
    Cox-Munk glint with a user-supplied water IOR spectrum plus a
    lambertian water-body reflectance term and whitecaps."""

    wind_speed: float = 0.01  # m/s at mast height
    eta: Spectrum = _spec(1.34)  # water IOR (real part)
    water_body_reflectance: Spectrum = _spec(0.0)
    kind: str = attrs.field(default="ocean_grasp", init=False)

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        return {
            "wind_speed": np.full(w.shape, self.wind_speed),
            "eta": self.eta.eval(w_nm),
            "water_body_reflectance": self.water_body_reflectance.eval(w_nm),
        }


@bsdf_factory.register("ocean_mishchenko")
@attrs.define(eq=False, slots=False)
class OceanMishchenkoBSDF(BSDF):
    """Mishchenko & Travis (1997) polarized sunglint ocean surface
    (``scenes/bsdfs/_ocean_mishchenko.py``): opaque Cox-Munk facet surface
    with a full Fresnel reflection Mueller matrix and bistatic Smith
    shadowing. Parameters mirror the reference plugin."""

    wind_speed: float = 0.01  # m/s
    eta: Spectrum = _spec(1.33)  # water IOR (real)
    k: Spectrum = _spec(0.0)  # water IOR (imaginary)
    ext_ior: Spectrum = _spec(1.000277)
    shadowing: bool = True
    kind: str = attrs.field(default="ocean_mishchenko", init=False)

    def eval_params(self, w_nm) -> dict:
        w = np.atleast_1d(np.asarray(w_nm))
        return {
            "wind_speed": np.full(w.shape, self.wind_speed),
            "eta": self.eta.eval(w_nm),
            "k": self.k.eval(w_nm),
            "ext_ior": self.ext_ior.eval(w_nm),
            "shadowing": np.full(w.shape, 1.0 if self.shadowing else 0.0),
        }
