"""DEM experiments of the port against the JAX package's, on the CPU.

``eradiate_tpu_torch.run(DEMExperiment(...), device="cpu")`` and
``eradiate_tpu.run`` at the same seed, on one scene shape: the 33 x 33
gaussian hill (1 km high, sigma 1 km, 10 km wide) under the Rayleigh
atmosphere, sun at 60 degrees, three view zeniths over a 4 km x 4 km
rectangle target on the hill, with the marched heightfield and with the
triangulated grid (2048 triangles: the triangle sweeps' plain versions).

- ``mono_single``: every pixel within 1e-5 relative, both intersectors.
- ``mono_double`` (the reference under x64): within 1e-10, both.
- ``ckd_single`` (marcher): within 1e-5, every raw row.
- ``mono_polarized_single``: the same data variables and values as the
  reference's (a scalar result: neither tracer has a Mueller step).
- Under the continental aerosol (a forward-peaked tabulated phase function),
  ``mono_single`` marched within 1e-5.

Port only, as ``tests/system/test_dem.py``: a flat DEM reduces to the
Lambertian 0.4 with both intersectors, a tall hill at low sun shadows its
anti-solar flank, ``mesh=`` on the triangulated terrain is refused (by
``process`` and by the sensitivities), the DEM path runs with ``jax``
blocked.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import DEMExperiment as RefDEM
from eradiate_tpu.scenes.surface import DEMSurface as RefSurface
from eradiate_tpu_torch.experiments import DEMExperiment
from eradiate_tpu_torch.scenes.surface import DEMSurface

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 7


#: Rayleigh with the 0-2 km continental aerosol (a tabulated, forward-peaked
#: phase function: the next-event cosine's sign shows).
AEROSOL = {
    "type": "heterogeneous",
    "molecular_atmosphere": {"type": "molecular"},
    "particle_layers": [{"type": "particle_layer", "bottom": 0.0, "top": 2.0, "tau_ref": 0.2,
                         "dataset": "govaerts_2021-continental"}],
}


def hill_kwargs(surface_cls, triangulate, spp, atmosphere=None):
    surface = surface_cls.gaussian_hill(
        height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33,
        bsdf={"type": "lambertian", "reflectance": 0.5},
    )
    surface.triangulate = triangulate
    return dict(
        illumination={"type": "directional", "zenith": 60.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-45.0, 0.0, 45.0],
                  "azimuth": 0.0, "spp": spp, "id": "m",
                  "target": {"type": "rectangle", "xmin": -2.0, "xmax": 2.0,
                             "ymin": -2.0, "ymax": 2.0, "z": 1.1}},
        surface=surface,
        atmosphere=atmosphere or {"type": "molecular"},
    )


@pytest.fixture
def modes():
    """Sets both packages' mode (the reference under x64 in a double mode)
    and restores them and x64 afterwards."""
    old = jax.config.jax_enable_x64

    def set_mode(m):
        jax.config.update("jax_enable_x64", "double" in m)
        eradiate_tpu.set_mode(m)
        eradiate_tpu_torch.set_mode(m)

    try:
        yield set_mode
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")


def both(triangulate, spp, atmosphere=None):
    """``(port dataset, port experiment, reference dataset, reference
    experiment)`` of the hill at the same seed."""
    eradiate_tpu.root_seed_state.reset(SEED)
    ref_exp = RefDEM(**hill_kwargs(RefSurface, triangulate, spp, atmosphere))
    ref = eradiate_tpu.run(ref_exp)
    eradiate_tpu_torch.root_seed_state.reset(SEED)
    exp = DEMExperiment(**hill_kwargs(DEMSurface, triangulate, spp, atmosphere))
    got = eradiate_tpu_torch.run(exp, device="cpu")
    return got, exp, ref, ref_exp


@pytest.mark.parametrize(
    "mode, triangulate, spp, rtol, atmosphere",
    [("mono_single", False, 256, 1e-5, None), ("mono_single", True, 256, 1e-5, None),
     ("mono_double", False, 64, 1e-10, None), ("mono_double", True, 64, 1e-10, None),
     ("ckd_single", False, 64, 1e-5, None), ("mono_single", False, 64, 1e-5, AEROSOL)],
    ids=["mono_single-marched", "mono_single-triangulated", "mono_double-marched",
         "mono_double-triangulated", "ckd_single-marched", "mono_single-marched-aerosol"],
)
def test_hill_matches_reference(modes, mode, triangulate, spp, rtol, atmosphere):
    modes(mode)
    got, exp, ref, ref_exp = both(triangulate, spp, atmosphere)
    raw = exp.measures[0].results["raw"]
    ref_raw = ref_exp.measures[0].results["raw"]
    assert raw["spp"] == ref_raw["spp"] == spp
    for k in ("radiance", "m2"):
        want = np.asarray(ref_raw[k])
        assert raw[k].shape == want.shape
        np.testing.assert_allclose(raw[k], want, rtol=rtol, atol=0)
    np.testing.assert_allclose(got["brf"].values, ref["brf"].values, rtol=rtol, atol=0)
    if mode == "ckd_single":
        assert raw["radiance"].shape[0] > 1  # every (bin, g-point) row
    assert np.all(got["brf"].values > 0.3) and np.all(got["brf"].values < 0.7)


def test_polarized_mode_renders_scalar(modes):
    modes("mono_polarized_single")
    got, _, ref, _ = both(False, 64)
    assert set(got.data_vars) == set(ref.data_vars)
    assert "I" not in got.data_vars
    for k in ref.data_vars:
        np.testing.assert_allclose(got[k].values, ref[k].values, rtol=1e-5, atol=0)


@pytest.mark.parametrize("triangulate", [False, True], ids=["marched", "triangulated"])
def test_flat_dem_reduces_to_lambertian(modes, triangulate):
    modes("mono_single")
    surface = DEMSurface(elevation=np.zeros((17, 17)), x0=-5.0, y0=-5.0, dx=0.625, dy=0.625,
                         bsdf={"type": "lambertian", "reflectance": 0.4},
                         triangulate=triangulate)
    exp = DEMExperiment(
        illumination={"type": "directional", "zenith": 30.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-30.0, 0.0, 30.0],
                  "azimuth": 0.0, "spp": 16, "id": "m"},
        surface=surface,
        atmosphere=None,
    )
    result = eradiate_tpu_torch.run(exp, device="cpu")
    np.testing.assert_allclose(result["brf"].values, 0.4, atol=1e-3)


def test_hill_shadowing(modes):
    """A tall hill at low sun shadows its anti-solar flank: the BRF there is
    below the flat value."""
    modes("mono_single")
    surface = DEMSurface.gaussian_hill(height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33,
                                       bsdf={"type": "lambertian", "reflectance": 0.5})
    exp = DEMExperiment(
        illumination={"type": "directional", "zenith": 70.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [0.0], "azimuth": 0.0,
                  "spp": 256, "id": "m", "target": {"type": "point", "xyz": [-1.0, 0.0, 0.6]}},
        surface=surface,
        atmosphere=None,
    )
    brf = float(eradiate_tpu_torch.run(exp, device="cpu")["brf"].values[0, 0])
    assert 0.0 <= brf < 0.45


def test_sensitivities_and_mesh_are_refused(modes):
    """The triangulated terrain renders on one device, as in the reference:
    ``process`` and the sensitivities refuse a mesh before using it (the
    marched terrain shards, ``tests/test_torch_parallel.py``)."""
    modes("mono_single")
    exp = DEMExperiment(**hill_kwargs(DEMSurface, True, 16))
    mesh = object()  # any mesh: the refusal comes before the process group is read
    with pytest.raises(NotImplementedError, match="single-device only"):
        exp.process(device="cpu", mesh=mesh)
    from eradiate_tpu_torch.sensitivity import sensitivities

    with pytest.raises(NotImplementedError, match="single-device only"):
        sensitivities(exp, ["surface.reflectance"], spp=16, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="plane-parallel"):
        DEMExperiment(**{**hill_kwargs(DEMSurface, False, 16), "geometry": "spherical_shell"})


def test_dem_runs_with_jax_blocked():
    """Both intersectors render with ``jax`` and ``eradiate_tpu`` unimportable,
    and load neither."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["eradiate_tpu"] = None
        import json
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import eradiate_tpu_torch as etp
        from eradiate_tpu_torch.experiments import DEMExperiment
        from eradiate_tpu_torch.scenes.surface import DEMSurface
        etp.set_mode("mono_single")
        out = []
        for triangulate in (False, True):
            surface = DEMSurface.gaussian_hill(
                height_km=1.0, sigma_km=1.0, extent_km=10.0, n=33, triangulate=triangulate)
            exp = DEMExperiment(
                illumination={"type": "directional", "zenith": 30.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": [-45.0, 0.0, 45.0], "spp": 32},
                surface=surface, atmosphere={"type": "molecular"})
            out.append(np.asarray(etp.run(exp, device="cpu")["brf"]).ravel().tolist())
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "eradiate_tpu")
                  and sys.modules[m] is not None]
        print(json.dumps({"brf": out, "loaded": loaded}))
        """
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    brf = np.asarray(out["brf"])
    assert brf.shape == (2, 3) and np.all(np.isfinite(brf)) and np.all(brf > 0.1)


def test_chunked_render_matches_reference(modes):
    """``render_dem`` in chunks (64 samples each, keys ``fold_in(row)`` then
    ``fold_in(chunk)``) against the reference's at the same seed, within
    1e-5; the CPU's default plan is the reference's DEM rule. (Chunks of 16
    samples give the reference's jitted loop 6 lanes, which XLA:CPU rounds
    otherwise than wider batches: a lane of the six leaves the port's path
    there, ``tools/dem_lanes.py --spp 16``.)"""
    from eradiate_tpu.ops.tracer_dem import render_dem as ref_render_dem
    from eradiate_tpu_torch.ops.tracer import MAX_PATHS_PER_DISPATCH
    from eradiate_tpu_torch.ops.tracer_dem import DEM_PATHS_PER_DISPATCH, render_dem

    modes("mono_single")
    assert DEM_PATHS_PER_DISPATCH["cpu"] == MAX_PATHS_PER_DISPATCH // 16
    exp, ref_exp = (cls(**hill_kwargs(surf, False, 256))
                    for cls, surf in ((DEMExperiment, DEMSurface), (RefDEM, RefSurface)))
    m, rm = exp.measures[0], ref_exp.measures[0]
    scene, sensor, config = ref_exp.compile_scene(rm, ref_exp.spectral_context(rm))
    want = ref_render_dem(scene, ref_exp.surface.dem_arrays(), sensor, config, spp=256, seed=SEED,
                          spp_chunk=64)
    scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
    got = render_dem(scene, exp.surface.dem_arrays(), sensor, config, spp=256, seed=SEED,
                     spp_chunk=64, device="cpu")
    whole = render_dem(scene, exp.surface.dem_arrays(), sensor, config, spp=256, seed=SEED,
                       device="cpu")
    assert got["spp"] == want["spp"] == 256
    for k in ("radiance", "m2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=0)
    assert not np.array_equal(got["radiance"].numpy(), whole["radiance"].numpy())
