"""The port's experiment path (c1 at 11 view zeniths) against the JAX package.

``compile_scene`` leaves are bitwise the reference's; ``run`` at the same
seed matches ``eradiate_tpu.run`` within 1e-5 relative and returns the same
dataset layout; the port imports and runs c1, c4, a small canopy and a
polarized c1 with ``jax`` and ``eradiate_tpu`` blocked; asking for CUDA
without a card raises.
The two packages share no objects: each has its own mode and seed state.
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
from eradiate_tpu_torch import AtmosphereExperiment

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SPP = 64


def c1_kwargs(n_vza=11):
    """BASELINE config 1 (``bench.py`` ``_c1``) at ``n_vza`` view zeniths."""
    return dict(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-75, 75, n_vza),
            "azimuth": 0.0,
            "id": "m",
        },
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
    )


@pytest.fixture
def mono_single():
    # each package has its own mode registry
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
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


def test_compile_scene_leaves_bitwise(mono_single):
    ref_exp, exp = RefExperiment(**c1_kwargs()), AtmosphereExperiment(**c1_kwargs())
    ctx = exp.spectral_context(exp.measures[0])
    np.testing.assert_array_equal(ctx["w"], ref_exp.spectral_context(ref_exp.measures[0])["w"])
    ref = _leaves(ref_exp.compile_scene(ref_exp.measures[0], ctx))
    out = _leaves(exp.compile_scene(exp.measures[0], ctx))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert out[k].dtype == v.dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert out[k] == v, k
    # the default 1e-3 merge tolerance folds the 1200-layer column
    assert ref["[0].medium.z_levels"].size < 1201


def test_run_matches_reference(mono_single):
    ref = eradiate_tpu.run(
        RefExperiment(**c1_kwargs()), spp=SPP, seed_state=SeedState(7), mesh=None
    )
    out = eradiate_tpu_torch.run(
        AtmosphereExperiment(**c1_kwargs()), spp=SPP,
        seed_state=eradiate_tpu_torch.SeedState(7), device="cpu",
    )
    assert set(out.data_vars) == set(ref.data_vars)
    assert set(out.coords) == set(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    for k in ("radiance", "brf"):
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(
            np.asarray(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=0
        )


def test_runs_with_jax_blocked():
    """c1, c4, the small canopy case and c1 with Stokes output
    (``mono_polarized_single``) run with ``jax`` and ``eradiate_tpu`` both
    unimportable, and load neither."""
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["eradiate_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import eradiate_tpu_torch as etp
        from eradiate_tpu_torch.test_tools.test_cases import create_het01_brfpp
        etp.set_mode("mono_single")
        measures = {{"type": "mdistant", "construct": "hplane",
                    "zeniths": np.linspace(-75, 75, 11), "azimuth": 0.0}}
        c1 = etp.AtmosphereExperiment(
            illumination={{"type": "directional", "zenith": 30.0}},
            measures=measures,
            surface={{"type": "lambertian", "reflectance": 0.5}},
            atmosphere={{"type": "molecular"}},
        )
        c4 = etp.AtmosphereExperiment(
            geometry="spherical_shell",
            illumination={{"type": "directional", "zenith": 75.0}},
            measures={{**measures, "target": [0.0, 0.0, 6378.1]}},
            surface={{"type": "hapke"}},
            atmosphere={{"type": "molecular"}},
        )
        het = create_het01_brfpp(n_vza=11, n_leaves=200)
        canopy = etp.CanopyAtmosphereExperiment(
            canopy=het.canopy,
            atmosphere={{"type": "molecular", "has_absorption": False}},
            illumination={{"type": "directional", "zenith": 20.0}},
            measures=measures,
            surface={{"type": "lambertian", "reflectance": 0.159}},
            integrator={{"type": "volpath"}},
        )
        means = []
        for exp in (c1, c4, canopy):
            ds = etp.run(exp, spp={SPP}, seed_state=etp.SeedState(7), device="cpu")
            brf = np.asarray(ds["brf"])
            assert brf.shape == (1, 11) and np.isfinite(brf).all(), brf
            means.append(float(brf.mean()))
        etp.set_mode("mono_polarized_single")  # c1 with Stokes output
        ds = etp.run(c1, spp={SPP}, seed_state=etp.SeedState(7), device="cpu")
        stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
        assert stokes.shape == (1, 11, 4) and np.isfinite(stokes).all(), stokes
        assert np.asarray(ds["dolp"]).max() > 0.05
        means.append(float(stokes[..., 0].mean()))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "eradiate_tpu")]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print("OK", means)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_cuda_without_card_raises(mono_single, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        eradiate_tpu_torch.run(AtmosphereExperiment(**c1_kwargs()), spp=8, device="cuda")


def test_ckd_polarized_single_renders():
    """c1 in ``ckd_polarized_single``: the band's rows through the polarized
    tracer, aggregated to Stokes vectors per bin."""
    eradiate_tpu_torch.set_mode("ckd_polarized_single")
    try:
        exp = AtmosphereExperiment(**c1_kwargs())
        ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono")
    raw = exp.measures[0].results["raw"]
    assert raw["stokes"].ndim == 3 and raw["stokes"].shape[1:] == (11, 4)
    stokes = np.stack([np.asarray(ds[c]) for c in "IQUV"], -1)
    assert stokes.shape[-2:] == (11, 4) and np.isfinite(stokes).all()
    assert (stokes[..., 0] > 0).all()


@pytest.mark.parametrize("mode_id", ["mono_double", "mono_polarized_double",
                                     "ckd_polarized_double"])
def test_unported_modes_raise(mode_id):
    """The double modes render the atmosphere experiment
    (``test_torch_double.py``), a leaf canopy (``test_torch_canopy_double.py``)
    and a canopy with triangles (``test_torch_tri_double.py``), in float64:
    no double mode is refused any more. (The name is the test's from when
    the canopy with triangles was refused.)"""
    from eradiate_tpu_torch import CanopyAtmosphereExperiment
    from eradiate_tpu_torch.test_tools.test_cases import create_het01_brfpp
    from test_torch_canopy_experiment import _with_tree

    eradiate_tpu_torch.set_mode(mode_id)
    try:
        exp = CanopyAtmosphereExperiment(
            canopy=create_het01_brfpp(n_vza=3, n_leaves=20).canopy,
            measures={"type": "mdistant", "construct": "hplane", "zeniths": [0.0]},
        )
        for exp in (exp, _with_tree()):
            ds = eradiate_tpu_torch.run(exp, spp=8, device="cpu")
            assert exp.measures[0].results["raw"]["radiance"].dtype == np.float64
            assert np.isfinite(np.asarray(ds["brf"])).all()
    finally:
        eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize(
    "override, name",
    [({"illumination": {"type": "spot"}}, "canopy tracer only")],
)
def test_unported_scene_features_raise(mono_single, override, name):
    """A spot seen by a distant sensor bank raises, with the reference's
    words; the constant sky renders (``test_torch_sensors.py``)."""
    exp = AtmosphereExperiment(**{**c1_kwargs(), **override})
    with pytest.raises(NotImplementedError, match=name):
        eradiate_tpu_torch.run(exp, spp=8, device="cpu")
