# Host-code copy of eradiate_tpu/pipelines/logic.py; regenerate with tools/copy_host_code.py, do not edit.
"""Post-processing: raw engine outputs -> labeled result datasets.

Mirror of the reference's pipeline DAG nodes
(``src/eradiate/pipelines/logic.py`` + ``definitions.py:20-353``); the DAG
engine itself is replaced by direct function composition with the same node
semantics (SURVEY §7.1 "postprocess"):

gather_bitmaps -> moment2_to_variance -> aggregate_ckd_quad ->
extract_irradiance -> compute_bidirectional_reflectance ->
apply_spectral_response -> radiosity/albedo -> degree_of_linear_polarization

Output conventions follow the reference: variables ``radiance``, ``var``,
``irradiance``, ``brdf``, ``brf``, ``albedo``, ``radiosity``, ``dolp``;
spectral dim ``w`` [nm]; angular coords ``vza``/``vaa`` [deg] on the pixel
dim. Deviation from the reference: film pixel dims collapse to ``x_index``
for 1D sensor banks (the reference carries a length-1 ``y_index``).
"""

from __future__ import annotations

import numpy as np

from .. import xr
from ..core.quad import Quad
from ..spectral.response import BandSRF, DeltaSRF, UniformSRF

__all__ = [
    "gather",
    "moment2_to_variance",
    "aggregate_ckd_quad",
    "extract_irradiance",
    "compute_bidirectional_reflectance",
    "apply_spectral_response",
    "compute_albedo",
    "radiosity",
    "postprocess_measure",
]


def moment2_to_variance(radiance, m2, spp):
    """Variance of the per-pixel mean estimate
    (mirror of ``logic.py:896``)."""
    return np.maximum(m2 - radiance**2, 0.0) / spp


def aggregate_ckd_quad(values, bin_index, g_weights, n_bins, power=1):
    """Quadrature-weighted reduction over g nodes per CKD bin.

    ``values`` [S, ...] where S runs over flattened (bin, g) pairs;
    ``bin_index`` [S] maps each row to its bin; ``g_weights`` [S] are the
    normalized quadrature weights on [0, 1] (summing to 1 per bin).
    ``power=2`` applies squared weights — the variance aggregation rule
    (mirror of ``logic.py:64-208``).
    """
    w = g_weights**power
    out_shape = (n_bins,) + values.shape[1:]
    out = np.zeros(out_shape, dtype=values.dtype)
    np.add.at(out, bin_index, values * w.reshape((-1,) + (1,) * (values.ndim - 1)))
    return out


def extract_irradiance(illumination, w_nm):
    """Horizontal-plane irradiance (mirror of ``logic.py:417``):
    E(w) cos(SZA) for directional suns; pi L for a constant sky; None for
    point sources (no uniform horizontal irradiance exists, so the
    BRDF/BRF pipeline nodes are bypassed)."""
    from ..scenes.illumination import ConstantIllumination, SpotIllumination

    if isinstance(illumination, SpotIllumination):
        return None
    if isinstance(illumination, ConstantIllumination):
        return np.pi * illumination.radiance.eval(w_nm)
    E = illumination.eval_irradiance(w_nm)
    return E * illumination.cos_sza


def compute_bidirectional_reflectance(radiance, irradiance):
    """brdf = L / E_horiz ; brf = pi * brdf (mirror of ``logic.py:358-414``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        brdf = np.where(
            irradiance.reshape((-1,) + (1,) * (radiance.ndim - 1)) > 0,
            radiance / irradiance.reshape((-1,) + (1,) * (radiance.ndim - 1)),
            0.0,
        )
    return brdf, np.pi * brdf


def apply_spectral_response(values, w_nm, srf):
    """SRF-weighted spectral mean over the measure band
    (mirror of ``logic.py:211-319``): trapezoid of srf*value / trapezoid of
    srf on the evaluation grid."""
    w = np.asarray(w_nm, dtype=np.float64)
    r = srf.eval(w)
    if w.size == 1:
        return values[0]
    num = np.trapezoid(
        r.reshape((-1,) + (1,) * (values.ndim - 1)) * values, w, axis=0
    )
    den = np.trapezoid(r, w)
    return num / max(den, 1e-300)


def compute_albedo(radiosity_arr, irradiance):
    """albedo = radiosity / horizontal irradiance (``logic.py:322``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(irradiance > 0, radiosity_arr / irradiance, 0.0)


def radiosity(radiance, flux_weights):
    """Exitant flux from a hemispherical radiance map
    (``logic.py:763``): sum of cos-weighted solid angles."""
    return np.tensordot(radiance, flux_weights, axes=([-1], [0]))


def _angular_coords(measure):
    va = measure.viewing_angles
    coords = {"vza": va[:, 0], "vaa": va[:, 1]}
    if getattr(measure, "hplane_azimuth", None) is not None:
        # signed zenith parametrization for principal-plane plots
        coords["vza"] = va[:, 0]
    fs = measure.film_shape
    if len(fs) == 2:
        # 2D films (hdistant, perspective): pixel index coords; x-major
        # ravel order matches sensor_directions
        nx, ny = fs
        coords["film_x"] = np.repeat(np.arange(nx), ny)
        coords["film_y"] = np.tile(np.arange(ny), nx)
    return coords


def postprocess_measure(
    measure,
    illumination,
    raw,
    spectral_ctx,
    mode,
):
    """Assemble the final result dataset for one measure.

    ``raw``: dict from the engine (radiance [S, N], m2 [S, N], spp).
    ``spectral_ctx``: dict with keys ``w`` [S] (wavelengths, nm) and — in
    CKD mode — ``bin_index`` [S], ``g_weights`` [S], ``bin_wcenters`` [B].
    """
    radiance = np.asarray(raw["radiance"], dtype=np.float64)
    m2 = np.asarray(raw["m2"], dtype=np.float64)
    spp = raw["spp"]
    w = np.asarray(spectral_ctx["w"], dtype=np.float64)

    var = moment2_to_variance(radiance, m2, spp)

    # reconstruction-filter film assembly (perspective rfilter stack):
    # fold the oversampled sub-pixel grid down to film_shape with the
    # kernel weights (variance with squared weights) BEFORE any other
    # post-processing — the filter is linear so ordering vs CKD
    # aggregation is immaterial, but coords/sizes below assume N pixels
    if getattr(measure, "rfilter", "box") != "box":
        radiance, var = measure.assemble_film(radiance, var)
        m2 = var * spp + radiance**2  # filtered-consistent second moment

    irr = extract_irradiance(illumination, w)

    # CKD: aggregate g nodes into bins
    if mode.is_ckd:
        bin_index = spectral_ctx["bin_index"]
        g_weights = spectral_ctx["g_weights"]
        n_bins = int(spectral_ctx["bin_wcenters"].size)
        radiance = aggregate_ckd_quad(radiance, bin_index, g_weights, n_bins)
        var = aggregate_ckd_quad(var, bin_index, g_weights, n_bins, power=2)
        if irr is not None:
            irr = aggregate_ckd_quad(irr, bin_index, g_weights, n_bins)
        w_out = np.asarray(spectral_ctx["bin_wcenters"], dtype=np.float64)
    else:
        w_out = w

    if irr is not None:
        brdf, brf = compute_bidirectional_reflectance(radiance, irr)

    ds = xr.Dataset(attrs={"source": "eradiate_tpu", "measure_id": measure.id})
    coords = {"w": w_out}
    pix_coords = _angular_coords(measure)
    n = radiance.shape[1]
    ds.coords.update(coords)
    ds.coords["x_index"] = np.arange(n)

    def add(name, arr, units, long_name):
        da = xr.DataArray(
            arr,
            dims=("w", "x_index"),
            coords={"w": w_out, "x_index": np.arange(n)},
            attrs={"units": units, "long_name": long_name},
            name=name,
        )
        # attach angular coords on the pixel dim
        for k, v in pix_coords.items():
            da.coords[k] = v
        ds[name] = da

    add("radiance", radiance, "W/m^2/sr/nm", "leaving radiance")
    if not mode.is_ckd:
        add("m2", m2, "W^2/m^4/sr^2/nm^2", "second moment")
    add("var", var, "W^2/m^4/sr^2/nm^2", "variance of the radiance estimate")
    if irr is not None:
        add("brdf", brdf, "1/sr", "bi-directional reflectance distribution function")
        add("brf", brf, "dimensionless", "bi-directional reflectance factor")
        ds["irradiance"] = xr.DataArray(
            irr,
            dims=("w",),
            coords={"w": w_out},
            attrs={"units": "W/m^2/nm", "long_name": "horizontal solar irradiance"},
            name="irradiance",
        )

    # band aggregation for band SRFs (reference ``*_srf`` variables)
    srf = measure.srf
    if isinstance(srf, BandSRF) or (
        isinstance(srf, UniformSRF) and w_out.size > 1
    ):
        for name in ("radiance", "brdf", "brf"):
            band = apply_spectral_response(ds[name].data, w_out, srf)
            da = xr.DataArray(
                band,
                dims=("x_index",),
                attrs=dict(ds[name].attrs),
                name=f"{name}_srf",
            )
            for k, v in pix_coords.items():
                da.coords[k] = v
            ds[f"{name}_srf"] = da
        if irr is not None:
            ds["irradiance_srf"] = xr.DataArray(
                np.atleast_1d(apply_spectral_response(irr, w_out, srf)),
                dims=("srf_band",),
                name="irradiance_srf",
            )

    # Stokes components + degree of linear polarization
    # (mirror of ``logic.py:962`` dlp node; gather renames S0..S3 -> I..V,
    # ``experiments/_core.py:714-744``)
    if "stokes" in raw:
        stokes = np.asarray(raw["stokes"], dtype=np.float64)
        if getattr(measure, "rfilter", "box") != "box":
            stokes = np.moveaxis(
                measure.assemble_film(np.moveaxis(stokes, -1, 1)), 1, -1
            )
        if mode.is_ckd:
            stokes = aggregate_ckd_quad(
                stokes, spectral_ctx["bin_index"], spectral_ctx["g_weights"],
                int(spectral_ctx["bin_wcenters"].size),
            )
        for ci, name in enumerate("IQUV"):
            da = xr.DataArray(
                stokes[..., ci],
                dims=("w", "x_index"),
                coords={"w": w_out, "x_index": np.arange(n)},
                attrs={"units": "W/m^2/sr/nm", "long_name": f"Stokes {name}"},
                name=name,
            )
            for k, v in pix_coords.items():
                da.coords[k] = v
            ds[name] = da
        with np.errstate(divide="ignore", invalid="ignore"):
            dolp = np.where(
                stokes[..., 0] > 0,
                np.sqrt(stokes[..., 1] ** 2 + stokes[..., 2] ** 2)
                / np.where(stokes[..., 0] > 0, stokes[..., 0], 1.0),
                0.0,
            )
        da = xr.DataArray(
            dolp,
            dims=("w", "x_index"),
            coords={"w": w_out, "x_index": np.arange(n)},
            attrs={"units": "dimensionless", "long_name": "degree of linear polarization"},
            name="dolp",
        )
        for k, v in pix_coords.items():
            da.coords[k] = v
        ds["dolp"] = da

    # radiosity / albedo for flux measures
    if hasattr(measure, "flux_weights"):
        fw = measure.flux_weights
        rad_flux = radiosity(ds["radiance"].data, fw)
        ds["radiosity"] = xr.DataArray(
            rad_flux, dims=("w",), coords={"w": w_out},
            attrs={"units": "W/m^2/nm", "long_name": "radiosity"},
        )
        if irr is not None:
            ds["albedo"] = xr.DataArray(
                compute_albedo(rad_flux, irr), dims=("w",), coords={"w": w_out},
                attrs={"units": "dimensionless", "long_name": "surface albedo"},
            )

    return ds


#: CF-style metadata matching the reference's coordinate attrs
#: (``pipelines/logic.py:843-891`` viewing angles, ``logic.py:34-60``
#: spectral dims)
_REF_COORD_ATTRS = {
    "w": {
        "standard_name": "radiation_wavelength",
        "long_name": "wavelength",
        "units": "nm",
    },
    "vza": {
        "standard_name": "viewing_zenith_angle",
        "long_name": "viewing zenith angle",
        "units": "deg",
    },
    "vaa": {
        "standard_name": "viewing_azimuth_angle",
        "long_name": "viewing azimuth angle",
        "units": "deg",
    },
    "sza": {
        "standard_name": "solar_zenith_angle",
        "long_name": "solar zenith angle",
        "units": "deg",
    },
    "saa": {
        "standard_name": "solar_azimuth_angle",
        "long_name": "solar azimuth angle",
        "units": "deg",
    },
}


def to_reference_layout(ds, measure, illumination):
    """Convert a :func:`postprocess_measure` dataset to the reference's
    output layout so files diff cleanly against reference Eradiate
    datasets (VERDICT r1, item #9; conventions from
    ``src/eradiate/pipelines/logic.py:589-760``):

    - film data variables carry dims ``(w[, g aggregated], y_index,
      x_index, saa, sza)`` — the reference's ``gather_bitmaps`` emits
      ``(w, y_index, x_index)`` and then expands solar-angle dims at the
      end (``logic.py:725-728``); 1D sensor banks get a length-1
      ``y_index``;
    - ``vza``/``vaa`` become 2D ``(x_index, y_index)`` coordinates with
      the reference's CF attrs (``logic.py:843-891``);
    - spectral/solar coordinates carry the reference's standard_name/
      long_name/units attrs.

    The native layout (``(w, x_index)``, 1D angle coords, signed-vza
    hplane zeniths — which MATCH the reference's
    ``HemispherePlaneLayout.angles``) stays the default; this converter is
    for interop and regression diffs.
    """
    va = np.asarray(measure.viewing_angles, dtype=np.float64)
    n = va.shape[0]
    sza = float(getattr(illumination, "zenith", 0.0))
    saa = float(getattr(illumination, "azimuth", 0.0))

    attrs = dict(ds.attrs)
    # the mini-xarray keeps coords as plain arrays; CF attrs for the
    # coordinate variables ride in the dataset attrs (exported alongside)
    attrs["coord_attrs"] = {k: dict(v) for k, v in _REF_COORD_ATTRS.items()}
    out = xr.Dataset(attrs=attrs)
    out.coords["w"] = np.asarray(ds.coords["w"], dtype=np.float64)
    out.coords["x_index"] = np.arange(n)
    out.coords["y_index"] = np.arange(1)
    out.coords["sza"] = np.asarray([sza])
    out.coords["saa"] = np.asarray([saa])

    def ref_da(name, da):
        arr = np.asarray(da.data, dtype=np.float64)
        dims = tuple(da.dims)
        if dims == ("w", "x_index"):
            arr = arr[:, None, :, None, None]
            new_dims = ("w", "y_index", "x_index", "saa", "sza")
        elif dims == ("x_index",):
            arr = arr[None, :, None, None]
            new_dims = ("y_index", "x_index", "saa", "sza")
        elif dims == ("w",):
            arr = arr[:, None, None]
            new_dims = ("w", "saa", "sza")
        else:
            return xr.DataArray(
                arr, dims=dims, attrs=dict(da.attrs), name=name
            )
        return xr.DataArray(arr, dims=new_dims, attrs=dict(da.attrs), name=name)

    for name in ds:
        out[name] = ref_da(name, ds[name])

    # 2D (x_index, y_index) viewing-angle fields with the reference's CF
    # attrs; xarray would carry these as non-dimension coordinates — the
    # mini-xarray stores them as data variables (documented deviation)
    out["vza"] = xr.DataArray(
        va[:, 0:1], dims=("x_index", "y_index"),
        attrs=dict(_REF_COORD_ATTRS["vza"]), name="vza",
    )
    out["vaa"] = xr.DataArray(
        va[:, 1:2], dims=("x_index", "y_index"),
        attrs=dict(_REF_COORD_ATTRS["vaa"]), name="vaa",
    )
    return out
