"""The port's host tools against the JAX package's, on the CPU.

The modules are copies (``tools/copy_host_code.py``), so the same inputs
(those of the reference's unit tests) must give the same outputs in both
packages: the regression metrics (``test_tools/regression.py``), dataset
validation, the NetCDF readers (on h5py files the test writes), the
libRadtran aerosol import, the SRF tools, the labeled-array utilities, the
plotting helpers (where matplotlib is installed), the native helper (its C++
library, built with g++ under ``build/native/``, and its numpy fallbacks)
and the BSDF probe (the port's own, through ``ops/bsdf_ops`` on torch
tensors). The committed golden absorption database
(``tests/regression_references/absorption_golden/``) loads through the
port's ``absorption_io`` and ``open_database`` with the reference's arrays,
and a small ``ckd_single`` render over it matches the reference at the same
seed within 1e-5.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu import native as ref_native
from eradiate_tpu import srf_tools as ref_srf
from eradiate_tpu import test_tools as ref_tt
from eradiate_tpu import xarray_utils as ref_xu
from eradiate_tpu import xr as ref_xr
from eradiate_tpu.data import io as ref_io
from eradiate_tpu.data import validation as ref_validation
from eradiate_tpu_torch import native
from eradiate_tpu_torch import srf_tools
from eradiate_tpu_torch import test_tools as tt
from eradiate_tpu_torch import xarray_utils as xu
from eradiate_tpu_torch import xr
from eradiate_tpu_torch.data import io
from eradiate_tpu_torch.data import validation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "regression_references" / "absorption_golden"


# -- regression metrics ----------------------------------------------------------


def _metric_inputs(name):
    rng = np.random.default_rng(0)
    ref = np.ones(50)
    var = np.full(50, 0.01**2)
    noisy = ref + rng.normal(0, 0.01, 50)
    return {
        "RMSETest": [dict(value=ref[:10] * 1.01, reference=ref[:10], threshold=0.05),
                     dict(value=ref[:10] * 1.2, reference=ref[:10], threshold=0.05)],
        "ZTest": [dict(value=noisy, reference=ref, variance=var),
                  dict(value=ref + 0.1, reference=ref, variance=var)],
        "Chi2Test": [dict(value=noisy, reference=ref, variance=var),
                     dict(value=ref + 0.05, reference=ref, variance=var)],
        "SidakTTest": [dict(value=noisy, reference=ref, variance=var),
                       dict(value=ref + 0.1, reference=ref, variance=var)],
        "PairedStudentTTest": [dict(value=noisy[:30] + rng.normal(0, 1e-3, 30),
                                    reference=noisy[:30]),
                               dict(value=noisy[:30] + 0.01 + rng.normal(0, 1e-3, 30),
                                    reference=noisy[:30])],
        "IndependentStudentTTest": [dict(value=noisy, reference=ref, variance=var),
                                    dict(value=ref + 0.1, reference=ref, variance=var)],
    }[name]


@pytest.mark.parametrize("name", ["RMSETest", "ZTest", "Chi2Test", "SidakTTest",
                                  "PairedStudentTTest", "IndependentStudentTTest"])
def test_regression_metrics_match(name):
    assert getattr(tt, name) is getattr(tt.regression, name)
    verdicts = []
    for kw in _metric_inputs(name):
        got, want = getattr(tt, name)(**kw), getattr(ref_tt, name)(**kw)
        verdict = got.run()
        assert verdict == want.run()
        assert got.metric_value == want.metric_value
        verdicts.append(verdict)
    assert verdicts == [True, False]  # the metrics can pass and fail


def test_regression_archive_on_failure(tmp_path):
    t = tt.RMSETest(value=np.ones(5) * 2, reference=np.ones(5), threshold=0.01,
                    archive_dir=str(tmp_path), name="t")
    assert not t.run()
    assert (tmp_path / "t_failure.npz").exists()


# -- validation ------------------------------------------------------------------


def _srf_dataset(pkg, units="dimensionless", extra=False):
    w = np.linspace(500, 600, 11)
    ds = pkg.Dataset()
    ds["srf"] = pkg.DataArray(np.ones(11), dims=("w",), coords={"w": w},
                              attrs={"units": units})
    if extra:
        ds["bogus"] = pkg.DataArray(np.ones(11), dims=("w",), coords={"w": w})
    return ds


@pytest.mark.parametrize("extra", [False, True])
def test_validation_matches(extra):
    got = validation.validate_dataset(_srf_dataset(xr, extra=extra), "srf_v1",
                                      raise_on_error=False)
    want = ref_validation.validate_dataset(_srf_dataset(ref_xr, extra=extra), "srf_v1",
                                           raise_on_error=False)
    assert got == want
    assert bool(got) == extra
    with pytest.raises(ValueError, match="unknown schema"):
        validation.validate_dataset(_srf_dataset(xr), "nope_v9")


# -- NetCDF (h5py) -----------------------------------------------------------------


def _write_nc(path, variables, attrs=None):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        for name, (data, var_attrs) in variables.items():
            d = f.create_dataset(name, data=data)
            for k, v in (var_attrs or {}).items():
                d.attrs[k] = v
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def _nc_case(kind, tmp_path):
    path = tmp_path / f"{kind}.nc"
    if kind == "srf":
        w_um = np.linspace(0.5, 0.6, 11)
        _write_nc(path, {"w": (w_um, {"units": "micron"}),
                         "srf": (np.exp(-0.5 * ((w_um - 0.55) / 0.02) ** 2), {})})
    elif kind == "solar":
        _write_nc(path, {"w": (np.linspace(300, 2500, 23), {"units": "nm"}),
                         "ssi": (np.linspace(1.0, 2.0, 23), {"units": "W/m^2/nm"})})
    elif kind == "aerosol":
        mu = np.linspace(-1, 1, 21)
        phase = np.broadcast_to((1 + 0.3 * mu)[None, :, None, None] / (4 * np.pi),
                                (5, 21, 1, 1)).copy()
        _write_nc(path, {"w": (np.linspace(400, 800, 5), {"units": "nm"}),
                         "sigma_t": (np.linspace(1.0, 0.5, 5), {}),
                         "albedo": (np.full(5, 0.9), {}), "mu": (mu, {}),
                         "phase": (phase, {})})
    else:
        z = np.linspace(0, 100000.0, 51)
        _write_nc(path, {"z": (z, {"units": "m"}),
                         "p": (101325.0 * np.exp(-z / 8000.0), {"units": "Pa"}),
                         "t": (np.full(51, 250.0), {"units": "K"}),
                         "x_H2O": (np.full(51, 1e-3), {})}, attrs={"title": "profile"})
    return path


def _fields(obj):
    if isinstance(obj, tuple):
        return {str(i): v for i, v in enumerate(obj)}
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


@pytest.mark.parametrize("kind", ["srf", "solar", "aerosol", "thermoprops"])
def test_netcdf_readers_match(tmp_path, kind):
    from eradiate_tpu.data import netcdf as ref_netcdf
    from eradiate_tpu_torch.data import netcdf

    path = _nc_case(kind, tmp_path)
    raw, ref_raw = netcdf.read_netcdf(path), ref_netcdf.read_netcdf(path)
    assert raw["attrs"] == ref_raw["attrs"] and raw["variables"].keys() == ref_raw["variables"].keys()
    fn = f"load_{kind}_netcdf"
    got, want = getattr(netcdf, fn)(path), getattr(ref_netcdf, fn)(path)
    got, want = _fields(got), _fields(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, (np.ndarray, float, int)):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
        elif isinstance(v, dict):
            assert got[k].keys() == v.keys(), k
            for kk in v:
                np.testing.assert_array_equal(np.asarray(got[k][kk]), np.asarray(v[kk]))


# -- libRadtran aerosol import ------------------------------------------------------


def _libradtran(pkg):
    wavelen, hum = np.array([0.4, 0.55, 0.8]), np.array([50.0, 80.0])
    theta_1d = np.linspace(0.0, 180.0, 19)
    mu = np.cos(np.deg2rad(theta_1d))
    p11 = 0.75 * (1.0 + mu**2)
    comps = np.stack([p11, -0.5 * p11, 0.9 * p11, 0.1 * p11], axis=0)
    phase = np.broadcast_to(comps[None, None], (3, 2, 4, 19)) * (
        1.0 + 0.1 * hum[None, :, None, None] / 100.0)
    dims4 = ["nlam", "nhum", "nphamat", "nthetamax"]
    return pkg.Dataset(data_vars={
        "phase": (dims4, phase.copy()),
        "theta": (dims4, np.broadcast_to(theta_1d, (3, 2, 4, 19)).copy(), {"units": "degrees"}),
        "ext": (["nlam", "nhum"], np.outer((wavelen / 0.55) ** -1.3, 1.0 + hum / 100.0),
                {"units": "1/km"}),
        "ssa": (["nlam", "nhum"], np.full((3, 2), 0.95), {"units": ""}),
        "wavelen": (["nlam"], wavelen, {"units": "micrometer"}),
        "hum": (["nhum"], hum, {"units": "per cent"}),
    })


@pytest.mark.parametrize("hum, wbounds", [(50.0, (None, None)), (80.0, (500.0, None))])
def test_libradtran_import_matches(hum, wbounds):
    got = io.load_aerosol_libradtran(_libradtran(xr), hum=hum, wbounds=wbounds)
    want = ref_io.load_aerosol_libradtran(_libradtran(ref_xr), hum=hum, wbounds=wbounds)
    assert set(got.data_vars) == set(want.data_vars) == {"sigma_t", "albedo", "phase"}
    for k in list(want.data_vars) + list(want.coords):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# -- SRF tools -------------------------------------------------------------------------


def _gauss(n=101):
    w = np.linspace(500.0, 600.0, n)
    return w, np.exp(-0.5 * ((w - 550.0) / 10.0) ** 2)


SRF_CALLS = {
    "trim_srf threshold": ("trim_srf", lambda: (*_gauss(), 1e-2)),
    "trim_srf integral": ("trim_srf", lambda: (*_gauss(), None, 0.99)),
    "pad_srf": ("pad_srf", lambda: ([500.0, 510.0], [1.0, 1.0], 2)),
    "spectral_filter": ("spectral_filter", lambda: (np.arange(10.0), np.ones(10), 3, 6)),
    "trim": ("trim", lambda: (np.arange(10.0), np.array([0, 0, 0, .5, 1, .5, 0, 0, 0, 0.]))),
    "threshold_filter": ("threshold_filter", lambda: (*_gauss(), 0.5)),
    "integral_filter walk": ("integral_filter", lambda: (*_gauss(), 95.0, "walk")),
    "integral_filter symmetry": ("integral_filter", lambda: (*_gauss(), 95.0, "symmetry")),
    "mean_wavelength": ("mean_wavelength", _gauss),
    "wavelength_bandwidth": ("wavelength_bandwidth", _gauss),
}


@pytest.mark.parametrize("case", list(SRF_CALLS))
def test_srf_tools_match(case):
    fn, args = SRF_CALLS[case]
    got, want = getattr(srf_tools, fn)(*args()), getattr(ref_srf, fn)(*args())
    for g, w in zip(np.atleast_1d(got) if np.isscalar(got) else got,
                    np.atleast_1d(want) if np.isscalar(want) else want):
        np.testing.assert_array_equal(g, w)


def test_srf_filter_warns_on_disconnection():
    w = np.arange(7.0)
    v = np.array([0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        srf_tools.threshold_filter(w, v, value=0.5)
    assert any("disconnect" in str(r.message) for r in rec)


# -- labeled-array utilities and plotting ------------------------------------------------


def test_film_to_angular_matches():
    from eradiate_tpu_torch.core.warp import square_to_uniform_hemisphere

    u = (np.arange(64) + 0.5) / 64
    uu, vv = np.meshgrid(u, u, indexing="ij")
    film = square_to_uniform_hemisphere(np.stack([uu, vv], axis=-1))[..., 2]
    theta, phi = np.array([0.2, 0.6, 1.0]), [0.7, 2.0]
    got = xu.film_to_angular(film, theta=theta, phi=phi)
    np.testing.assert_array_equal(got, ref_xu.film_to_angular(film, theta=theta, phi=phi))
    np.testing.assert_allclose(got[:, 0], np.cos(theta), atol=0.02)
    np.testing.assert_array_equal(
        xu.film_to_angular(np.arange(64.0), theta=[0.3], phi=[0.1], film_shape=(8, 8)),
        ref_xu.film_to_angular(np.arange(64.0), theta=[0.3], phi=[0.1], film_shape=(8, 8)))


def test_dataarray_to_rgb_matches():
    spectral = np.stack([np.full((4, 4), v) for v in (0.2, 0.4, 0.8)])
    got = xu.dataarray_to_rgb(spectral, channels=(2, 1, 0))
    np.testing.assert_array_equal(got, ref_xu.dataarray_to_rgb(spectral, channels=(2, 1, 0)))
    with pytest.raises(ValueError):
        xu.dataarray_to_rgb(spectral, channels=(0, 1))


def test_plot_helpers():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from eradiate_tpu import plot as ref_plot
    from eradiate_tpu_torch import plot

    steps, labels = plot.make_ticks(3, (0.0, np.pi))
    ref_steps, ref_labels = ref_plot.make_ticks(3, (0.0, np.pi))
    np.testing.assert_array_equal(steps, ref_steps)
    assert labels == ref_labels == ["0°", "90°", "180°"]
    plot.set_style()
    fig, ax = plt.subplots()
    assert plot.detect_axes(fig) == [ax]
    with pytest.raises(TypeError):
        plot.detect_axes(42)
    plt.close(fig)
    eradiate_tpu_torch.set_mode("mono_single")
    try:
        exp = eradiate_tpu_torch.AtmosphereExperiment(
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.linspace(-60, 60, 5), "azimuth": 0.0, "spp": 8, "id": "m"},
            surface={"type": "lambertian", "reflectance": 0.5}, atmosphere=None)
        result = eradiate_tpu_torch.run(exp, device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono")
    ax = plot.plot_brf_hplane(result, "brf")
    assert ax.get_xlabel().startswith("Viewing zenith") and len(ax.lines) >= 1
    np.testing.assert_allclose(ax.lines[0].get_ydata(), 0.5, atol=1e-6)
    plt.close(ax.figure)


# -- native helper -----------------------------------------------------------------------


@pytest.fixture(params=["native", "fallback"])
def backend(request, monkeypatch):
    """The port's native module with its C++ library (built into
    ``build/native/``), or forced onto its numpy fallbacks."""
    if request.param == "native":
        if not native.available():
            pytest.skip("native library unavailable (no g++)")
        assert native._LIB_PATH.parent == REPO / "build" / "native"
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def test_native_vol_roundtrip(tmp_path, backend):
    data = np.random.default_rng(0).random((4, 3, 2, 1)).astype(np.float32)
    path = tmp_path / "grid.vol"
    native.vol_write(path, data, bbox=(0, 0, 0, 1, 1, 1))
    out, bbox = native.vol_read(path)
    np.testing.assert_array_equal(out, data)
    np.testing.assert_allclose(bbox, [0, 0, 0, 1, 1, 1])
    # the file is the reference's format
    ref_out, _ = ref_native.vol_read(path)
    np.testing.assert_array_equal(ref_out, data)


def test_native_absorption_interp(backend):
    rng = np.random.default_rng(0)
    W, P, T, S, L = 16, 8, 6, 32, 10
    table = rng.random((W, P, T)).astype(np.float32)
    args = (table, rng.integers(0, W - 1, S).astype(np.int32), rng.random(S).astype(np.float32),
            rng.integers(0, P - 1, L).astype(np.int32), rng.random(L).astype(np.float32),
            rng.integers(0, T - 1, L).astype(np.int32), rng.random(L).astype(np.float32))
    out = native.absorption_interp(*args)
    assert out.shape == (S, L)
    np.testing.assert_allclose(out, ref_native.absorption_interp(*args), rtol=1e-5)


def test_native_leaf_cloud(backend):
    pos, nrm = native.generate_leaf_cloud(1000, 0.01, 0.001, seed=3)
    assert pos.shape == (1000, 3) and nrm.shape == (1000, 3)
    assert np.all(np.abs(pos[:, 0]) <= 0.005 + 1e-6)
    assert np.all((pos[:, 2] >= 0) & (pos[:, 2] <= 0.001 + 1e-6))
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, rtol=1e-5)


# -- BSDF probe ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind, params", [
    ("lambertian", {"reflectance": 0.6}),
    ("rpv", {"rho_0": 0.1, "k": 0.7, "g": -0.2, "rho_c": 0.1}),
    ("rtls", {"f_iso": 0.2, "f_vol": 0.1, "f_geo": 0.05}),
])
def test_bsdf_probe_matches(kind, params):
    import jax.numpy as jnp

    from eradiate_tpu.test_tools.bsdf_probe import eval_bsdf as ref_eval_bsdf
    from eradiate_tpu_torch.test_tools.bsdf_probe import eval_bsdf

    grids = (np.linspace(0.05, 1.4, 5), np.linspace(0.0, 2 * np.pi, 4, endpoint=False),
             [np.deg2rad(30.0), 0.9], [0.0, 1.0])
    got = eval_bsdf(kind, params, *grids, device="cpu")
    want = ref_eval_bsdf(kind, {k: jnp.asarray(v) for k, v in params.items()}, *grids)
    assert got["bsdf"].dims == want["bsdf"].dims == ("theta_o", "phi_o", "theta_i", "phi_i")
    for k in want.coords:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    # the reference evaluates in float32, the probe in float64
    np.testing.assert_allclose(got["bsdf"].values, want["bsdf"].values, rtol=1e-6,
                               atol=1e-6 * np.abs(want["bsdf"].values).max())
    if kind == "lambertian":
        np.testing.assert_allclose(got["bsdf"].values, 0.6 / np.pi, rtol=1e-12)


def test_bsdf_probe_defaults_to_the_card():
    from eradiate_tpu_torch.test_tools.bsdf_probe import eval_bsdf

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        eval_bsdf("lambertian", {"reflectance": 0.6}, [0.1], [0.0], [0.2], [0.0])


# -- the golden absorption database ---------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    from eradiate_tpu.data.absorption_io import load_absorption_netcdf as ref_load
    from eradiate_tpu_torch.data.absorption_io import load_absorption_netcdf

    return load_absorption_netcdf(GOLDEN), ref_load(GOLDEN)


def test_golden_database_loads_as_the_reference(golden):
    from eradiate_tpu_torch.physics.absorption import CKDAbsorptionDatabase

    db, ref = golden
    assert isinstance(db, CKDAbsorptionDatabase)
    assert db._d.keys() == ref._d.keys()
    for k, v in ref._d.items():
        np.testing.assert_array_equal(np.asarray(db._d[k]), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(db.wcenters, ref.wcenters)
    assert db._d["sigma_a"].shape == (2, 8, 6, 5, 3)


def test_golden_database_through_open_database(golden, tmp_path):
    """``open_database`` reads the NetCDF directory (no longer refused), and
    the importer's ``.npz`` reads back equal."""
    from eradiate_tpu_torch.data.absorption_io import import_absorption_database
    from eradiate_tpu_torch.physics.absorption import open_database

    db = open_database(str(GOLDEN))
    np.testing.assert_array_equal(db._d["sigma_a"], golden[1]._d["sigma_a"])
    dest = tmp_path / "golden.npz"
    import_absorption_database(GOLDEN, dest)
    np.testing.assert_array_equal(open_database(str(dest))._d["sigma_a"], db._d["sigma_a"])
    expected = np.load(GOLDEN / "expected.npz")
    from eradiate_tpu_torch.physics.thermoprops import ThermoProfile

    for (wc, g, p, t, x), want in zip(expected["probes"], expected["sigma_a"]):
        prof = ThermoProfile.from_arrays(z_km=np.array([0.0, 1.0]), p_pa=np.array([p, p]),
                                         t_k=np.array([t, t]), x={"H2O": np.array([x, x])})
        np.testing.assert_allclose(db.eval_sigma_a_bin_g(wc, g, prof), want * 1e3, rtol=1e-5)


def test_ckd_render_over_the_golden_database():
    """``ckd_single`` over the golden database's two bins (650 and 660 nm)
    at the same seed: the port within 1e-5 of the reference."""
    from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment

    kw = dict(
        atmosphere={"type": "molecular", "absorption_data": str(GOLDEN)},
        surface={"type": "lambertian", "reflectance": 0.3},
        illumination={"type": "directional", "zenith": 30.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 0.0, 30.0],
                  "azimuth": 0.0, "srf": {"type": "multi_delta", "wavelengths": [650.0, 660.0]},
                  "spp": 64, "id": "m"},
    )
    eradiate_tpu.set_mode("ckd_single")
    eradiate_tpu_torch.set_mode("ckd_single")
    try:
        ref = eradiate_tpu.run(RefExperiment(**kw), seed_state=eradiate_tpu.SeedState(5),
                               mesh=None)
        exp = eradiate_tpu_torch.AtmosphereExperiment(**kw)
        out = eradiate_tpu_torch.run(exp, seed_state=eradiate_tpu_torch.SeedState(5),
                                     device="cpu")
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    assert exp.measures[0].results["raw"]["radiance"].shape[0] > 2  # g-point rows
    assert np.asarray(out["brf"]).shape == (2, 3)
    for k in ("radiance", "brf"):
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
