"""The port's CKD path (BASELINE c3 in ``ckd_single``) against the JAX package.

c3 (``bench.py`` ``_c3``: a synthetic CKD absorption database, the
Sentinel-2A MSI band 4 response, a Lambertian floor of 0.2, at most 8
g-points a bin) renders 56 spectral rows, one for each (bin, g-point) pair,
and aggregates them by bin. ``bench.py`` names ``ckd``, the double mode; the
port renders ``ckd_single`` and ``ckd_polarized_single`` here, and the
double CKD modes in ``test_torch_double.py``; a canopy in a double CKD mode
raises. Held here: the spectral context and the compiled leaves
bit for bit (each g-point its own extinction), the post-processing on the
same raw arrays bit for bit, every raw row and the aggregated BRF within
1e-5 relative at the same seed (in ``ckd_polarized_single`` every raw row's
Stokes vector and the per-bin Stokes vectors), and c2 and c3 running with
``jax`` and ``eradiate_tpu`` blocked.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.physics.absorption import make_synthetic_ckd_db as ref_ckd_db
from eradiate_tpu.pipelines.logic import postprocess_measure as ref_postprocess
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.physics.absorption import make_synthetic_ckd_db
from eradiate_tpu_torch.pipelines.logic import postprocess_measure

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ROWS = 56  # 7 bins x 8 g-points


def c3_kwargs(db, n_vza=11):
    """BASELINE config 3 (``bench.py`` ``_c3``) at ``n_vza`` view zeniths."""
    return dict(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "srf": "sentinel_2a-msi-4",
            "id": "m",
        },
        surface={"type": "lambertian", "reflectance": 0.2},
        atmosphere={"type": "molecular", "absorption_data": db},
        ckd_quad_config={"ng_max": 8},
    )


def _pair():
    return (RefExperiment(**c3_kwargs(ref_ckd_db(base_sigma=2e-3, ng=8))),
            AtmosphereExperiment(**c3_kwargs(make_synthetic_ckd_db(base_sigma=2e-3, ng=8))))


@pytest.fixture
def ckd_single():
    eradiate_tpu.set_mode("ckd_single")
    eradiate_tpu_torch.set_mode("ckd_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def _leaves(obj, prefix=""):
    """Flatten a compiled scene into {path: numpy array or value}."""
    if hasattr(obj, "__dataclass_fields__"):
        out = {}
        for name in obj.__dataclass_fields__:
            out.update(_leaves(getattr(obj, name), f"{prefix}.{name}"))
        return out
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_leaves(v, f"{prefix}[{k}]"))
        return out
    if isinstance(obj, tuple) and obj and not isinstance(obj[0], str):
        out = {}
        for i, v in enumerate(obj):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    if obj is None or isinstance(obj, (str, bool, int, float, tuple)):
        return {prefix: obj}
    return {prefix: np.asarray(obj)}


def test_spectral_context_bitwise(ckd_single):
    ref_exp, exp = _pair()
    ctx = exp.spectral_context(exp.measures[0])
    ref = ref_exp.spectral_context(ref_exp.measures[0])
    assert ctx.keys() == ref.keys() == {"w", "g", "bin_index", "g_weights", "bin_wcenters"}
    for k, v in ref.items():
        assert np.asarray(ctx[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ctx[k], v, err_msg=k)
    assert ctx["w"].shape == (ROWS,) and np.unique(ctx["bin_index"]).size == 7
    np.testing.assert_allclose(np.bincount(ctx["bin_index"], ctx["g_weights"]), 1.0, rtol=1e-12)


def test_compile_scene_leaves_bitwise(ckd_single):
    """Every leaf of the 56-row scene; the optical depths differ between the
    g-points of a bin (the quadrature point reaches the absorption)."""
    ref_exp, exp = _pair()
    ctx = exp.spectral_context(exp.measures[0])
    ref = _leaves(ref_exp.compile_scene(ref_exp.measures[0], ctx))
    out = _leaves(exp.compile_scene(exp.measures[0], ctx))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k
    tau = out["[0].medium.tau_levels"]
    assert tau.shape[0] == ROWS
    for b in range(7):
        rows = tau[ctx["bin_index"] == b]
        assert np.unique(rows[:, -1]).size == rows.shape[0], b


def test_postprocess_measure_matches(ckd_single):
    """The CKD aggregation (g-point weights, then the band's response) on
    the same raw arrays, bit for bit."""
    ref_exp, exp = _pair()
    ctx = exp.spectral_context(exp.measures[0])
    rng = np.random.default_rng(6)
    radiance = rng.uniform(0.02, 0.3, (ROWS, 11)).astype(np.float32)
    raw = {"radiance": radiance,
           "m2": (radiance**2 * rng.uniform(1.5, 3.0, (ROWS, 11))).astype(np.float32),
           "spp": 64, "iterations": 900}
    ref = ref_postprocess(ref_exp.measures[0], ref_exp.illumination, dict(raw), dict(ctx),
                          eradiate_tpu.mode())
    out = postprocess_measure(exp.measures[0], exp.illumination, dict(raw), ctx,
                              eradiate_tpu_torch.mode())
    assert set(out.data_vars) == set(ref.data_vars)
    for k in list(ref.data_vars) + list(ref.coords):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)


def test_run_matches_reference(ckd_single):
    """c3 at 11 view zeniths and 256 spp, one seed: each of the 56 raw rows
    and the aggregated BRF within 1e-5 relative per pixel."""
    ref_exp, exp = _pair()
    ref = eradiate_tpu.run(ref_exp, spp=256, seed_state=SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(exp, spp=256, seed_state=eradiate_tpu_torch.SeedState(7),
                                 device="cpu")
    ref_raw, raw = ref_exp.measures[0].results["raw"], exp.measures[0].results["raw"]
    for k in ("radiance", "m2"):
        assert raw[k].shape == np.asarray(ref_raw[k]).shape == (ROWS, 11)
        np.testing.assert_allclose(raw[k], np.asarray(ref_raw[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
    assert raw["spp"] == 256 and raw["iterations"] >= ROWS
    assert set(out.data_vars) == set(ref.data_vars)
    assert set(out.coords) == set(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    for k in ("radiance", "brf"):
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=0)


def test_ckd_polarized_single_matches_reference():
    """c3 in ``ckd_polarized_single`` at 2 view zeniths and 64 spp a row,
    one seed: each of the 56 raw rows' I within 1e-5 relative and its Q, U
    and V within 1e-5 of I, then the per-bin Stokes vectors aggregated by
    ``postprocess_measure`` the same way."""
    eradiate_tpu.set_mode("ckd_polarized_single")
    eradiate_tpu_torch.set_mode("ckd_polarized_single")
    try:
        ref_exp = RefExperiment(**c3_kwargs(ref_ckd_db(base_sigma=2e-3, ng=8), n_vza=2))
        exp = AtmosphereExperiment(**c3_kwargs(make_synthetic_ckd_db(base_sigma=2e-3, ng=8),
                                               n_vza=2))
        ref = eradiate_tpu.run(ref_exp, spp=64, seed_state=SeedState(7), mesh=None)
        out = eradiate_tpu_torch.run(exp, spp=64, seed_state=eradiate_tpu_torch.SeedState(7),
                                     device="cpu")
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    raw, ref_raw = exp.measures[0].results["raw"], ref_exp.measures[0].results["raw"]
    for st, ref_st in ((raw["stokes"], np.asarray(ref_raw["stokes"])),
                       (*(np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
                          for ds in (out, ref)),)):
        assert st.shape == ref_st.shape and np.isfinite(st).all()
        I = ref_st[..., 0]
        np.testing.assert_allclose(st[..., 0], I, rtol=1e-5, atol=0)
        assert (np.abs(st[..., 1:] - ref_st[..., 1:]) <= 1e-5 * I[..., None]).all()
    assert raw["stokes"].shape == (ROWS, 2, 4)
    assert np.asarray(out["I"]).shape == (7, 2)  # the band's 7 bins
    assert set(out.data_vars) == set(ref.data_vars) and "dolp" in out.data_vars
    assert (np.asarray(out["dolp"]) >= 0).all()


@pytest.mark.parametrize("mode_id", ["ckd_double", "ckd_polarized_double"])
def test_other_ckd_modes_raise(mode_id):
    """The double CKD modes render c3 (``test_torch_double.py``) and a leaf
    canopy over the same CKD atmosphere, every raw row in float64, and so
    the canopy given a tree's trunks (triangles, through the triangle
    sweeps' float64 builds). (The name is the test's from when the canopy
    with triangles was refused.)"""
    from eradiate_tpu_torch import CanopyAtmosphereExperiment
    from eradiate_tpu_torch.scenes import biosphere as bio
    from eradiate_tpu_torch.test_tools.test_cases import create_het01_brfpp

    eradiate_tpu_torch.set_mode(mode_id)
    try:
        kw = c3_kwargs(make_synthetic_ckd_db(base_sigma=2e-3, ng=2), n_vza=1)
        atmosphere = {"measures": kw["measures"], "atmosphere": kw["atmosphere"],
                      "ckd_quad_config": {"ng_max": 2}}
        exp = CanopyAtmosphereExperiment(
            canopy=create_het01_brfpp(n_vza=1, n_leaves=20).canopy, **atmosphere)
        ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
        raw = exp.measures[0].results["raw"]["radiance"]
        assert raw.dtype == np.float64 and raw.shape[0] == 14  # 7 bins x 2 g-points
        assert np.isfinite(np.asarray(ds["brf"])).all()
        tree = bio.AbstractTree(leaf_cloud=bio.LeafCloud.sphere(n_leaves=20, leaf_radius=0.4,
                                                                 radius=2.0))
        exp = CanopyAtmosphereExperiment(
            canopy=bio.DiscreteCanopy(size=(30.0, 30.0, 15.0), instanced_canopy_elements=[
                {"type": "instanced", "canopy_element": tree,
                 "instance_positions": [[-8e-3, -5e-3, 0.0], [6e-3, -7e-3, 0.0]]}]),
            **atmosphere)
        ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
        raw = exp.measures[0].results["raw"]["radiance"]
        assert raw.dtype == np.float64 and raw.shape[0] == 14
        assert np.isfinite(np.asarray(ds["brf"])).all()
    finally:
        eradiate_tpu_torch.set_mode("mono")


def test_c2_and_c3_run_with_jax_blocked():
    """c2 (``mono_single``) and c3 (``ckd_single``, 56 rows) run with ``jax``
    and ``eradiate_tpu`` both unimportable, and load neither."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["eradiate_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import eradiate_tpu_torch as etp
        from eradiate_tpu_torch.physics.absorption import make_synthetic_ckd_db
        from eradiate_tpu_torch.test_tools.test_cases import (
            create_rpv_afgl1986_continental_brfpp,
        )
        etp.set_mode("mono_single")
        ds = etp.run(create_rpv_afgl1986_continental_brfpp(n_vza=5), spp=32,
                     seed_state=etp.SeedState(7), device="cpu")
        brf = np.asarray(ds["brf"])
        assert brf.shape == (1, 5) and np.isfinite(brf).all(), brf
        etp.set_mode("ckd_single")
        exp = etp.AtmosphereExperiment(
            illumination={"type": "directional", "zenith": 30.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.linspace(-75, 75, 5), "azimuth": 0.0,
                      "srf": "sentinel_2a-msi-4"},
            surface={"type": "lambertian", "reflectance": 0.2},
            atmosphere={"type": "molecular",
                        "absorption_data": make_synthetic_ckd_db(base_sigma=2e-3, ng=8)},
            ckd_quad_config={"ng_max": 8},
        )
        ds3 = etp.run(exp, spp=32, seed_state=etp.SeedState(7), device="cpu")
        assert exp.measures[0].results["raw"]["radiance"].shape == (56, 5)
        brf3 = np.asarray(ds3["brf"])
        assert np.isfinite(brf3).all() and brf3.shape[-1] == 5, brf3
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "eradiate_tpu")]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("OK", float(brf.mean()), float(brf3.mean()))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
