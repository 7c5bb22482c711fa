"""The port's measures and the constant sky against the JAX package.

Each measure of the reference's ``AtmosphereExperiment`` renders through
``eradiate_tpu_torch.run(..., device="cpu")`` on a c1-class column (the
molecular atmosphere at 550 nm, merged as c1 runs, over a Lambertian floor,
the sun at SZA 30) at 4 x 4 films and 64 to 256 spp, and equals
``eradiate_tpu.run`` at the same seed within 1e-5 a pixel in every variable
of the dataset (radiosity and albedo too): ``distant``, ``hdistant``,
``distant_flux``, ``radiancemeter``, ``mradiancemeter``, ``mdistant`` with a
``ray_offset`` and with a rectangle target, ``perspective`` with its
``box``, ``tent`` and ``gaussian`` filters (rays from the camera's origin,
the film folded by the filter's taps) and ``mpdistant`` (a target subcell a
pixel) over the reference test's ``selectbsdf`` floor; the rectangle target
and ``mpdistant`` also with the ``stratified`` sampler (the one-shot loop's
target jitter). ``perspective`` and
``mpdistant`` also render in ``mono_double`` within 1e-10 of the reference
under x64. Under ``ConstantIllumination`` the plane-parallel tracer
collects the sky on escaping paths (within 1e-5); the spherical, polarized
and canopy tracers never read it, as in the reference, and render what it
renders.
"""

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu.scenes import biosphere as ref_bio
from eradiate_tpu_torch import AtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.scenes import biosphere as bio

from test_torch_canopy_experiment import small_het01

torch.set_num_threads(1)

SEED = 11
RTOL = 1e-5

#: The floor of the reference's mpdistant test
#: (``tests/system/test_mpdistant.py``): reflectance 0.1 on the left half
#: of a 20 km square, 0.9 on the right.
HALF_SURFACE = {
    "type": "selectbsdf",
    "bsdfs": [{"type": "lambertian", "reflectance": 0.1},
              {"type": "lambertian", "reflectance": 0.9}],
    "index_map": [[0, 1]],
    "extent": 20.0,
}


def camera(rfilter):
    """A camera 2 km above the target and 1.15 km south of it, looking down
    at 30 degrees from the vertical."""
    return {"type": "perspective", "origin": [0.0, -1.1547, 2.0], "target": [0.0, 0.0, 0.0],
            "film_resolution": (4, 4), "fov": 40.0, "rfilter": rfilter, "id": "m"}


MEASURES = {
    "distant": ({"type": "distant", "zenith": 30.0, "azimuth": 45.0, "id": "m"}, None),
    "hdistant": ({"type": "hdistant", "film_resolution": (4, 4), "id": "m"}, None),
    "distant_flux": ({"type": "distant_flux", "film_resolution": (4, 4), "id": "m"}, None),
    "radiancemeter": ({"type": "radiancemeter", "origin": [0.5, 0.0, 3.0],
                       "target_point": [0.0, 0.0, 0.0], "id": "m"}, None),
    "mradiancemeter": ({"type": "mradiancemeter", "origins": [[0.0, 0.0, 1.0], [1.0, 0.0, 2.0]],
                        "directions": [[0.0, 0.0, -1.0], [0.5, 0.0, -0.8]], "id": "m"}, None),
    "mdistant_ray_offset": ({"type": "mdistant", "construct": "hplane",
                             "zeniths": [-60.0, -20.0, 10.0, 50.0], "azimuth": 0.0,
                             "ray_offset": 5.0, "id": "m"}, None),
    "mdistant_rectangle": ({"type": "mdistant", "construct": "hplane",
                            "zeniths": [-60.0, -20.0, 10.0, 50.0], "azimuth": 0.0,
                            "target": {"type": "rectangle", "xmin": -4.0, "xmax": 6.0,
                                       "ymin": -1.0, "ymax": 2.0}, "id": "m"},
                           HALF_SURFACE),
    "perspective_box": (camera("box"), None),
    "perspective_tent": (camera("tent"), None),
    "perspective_gaussian": (camera("gaussian"), None),
    "mpdistant": ({"type": "mpdistant", "film_resolution": (4, 4),
                   "direction": [0.3, 0.1, 0.9], "id": "m",
                   "target": {"type": "rectangle", "xmin": -10.0, "xmax": 10.0,
                              "ymin": -10.0, "ymax": 10.0}}, HALF_SURFACE),
}


def scene(measure, surface=None, illumination=None, **kw):
    return dict(
        illumination=illumination or {"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures=dict(measure),
        surface=surface or {"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        **kw,
    )


@pytest.fixture
def mono_single():
    eradiate_tpu.set_mode("mono_single")
    eradiate_tpu_torch.set_mode("mono_single")
    yield
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def run_pair(kw, spp, ref_cls=RefExperiment, port_cls=AtmosphereExperiment, ref_kw=None):
    ref_exp = ref_cls(**(ref_kw or kw))
    ref = eradiate_tpu.run(ref_exp, spp=spp, seed_state=SeedState(SEED), mesh=None)
    port_exp = port_cls(**kw)
    out = eradiate_tpu_torch.run(port_exp, spp=spp, seed_state=eradiate_tpu_torch.SeedState(SEED),
                                 device="cpu")
    return (out, port_exp.measures[0].results["raw"],
            ref, {k: np.asarray(v) for k, v in ref_exp.measures[0].results["raw"].items()})


def same_dataset(out, ref, spp, rtol=RTOL):
    """Every variable and coordinate of the reference's dataset, of the same
    shape, within ``rtol`` a pixel. The variance ``var = (m2 - L^2) / spp``
    is a difference of two float32 terms, so its bound is ``rtol`` of the
    terms it cancels (``m2 / spp``)."""
    assert set(out.data_vars) == set(ref.data_vars)
    assert set(out.coords) == set(ref.coords)
    for k in ref.coords:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]), err_msg=k)
    for k in ref.data_vars:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "var":
            scale = np.asarray(ref["m2"]) / spp
            assert (np.abs(a - b) <= rtol * scale).all(), np.max(np.abs(a - b) / scale)
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("name, sampler", [(name, "independent") for name in MEASURES]
                         + [("mdistant_rectangle", "stratified"), ("mpdistant", "stratified")])
def test_measure_matches_reference(mono_single, name, sampler):
    """A structured sampler renders through the one-shot loop, which jitters
    a rectangle's or a subcell's target once a lane from threefry."""
    measure, surface = MEASURES[name]
    out, raw, ref, ref_raw = run_pair(scene(dict(measure, sampler=sampler), surface), 128)
    same_dataset(out, ref, 128)
    assert np.isfinite(np.asarray(out["radiance"])).all()
    assert (np.asarray(out["radiance"]) > 0).all()
    if name.startswith(("perspective", "mpdistant", "hdistant", "distant_flux")):
        assert np.asarray(out["radiance"]).size == 16
    if name == "perspective_gaussian":
        # 4 x 4 pixels oversampled twice on each axis: 64 rays a row
        assert raw["radiance"].shape == ref_raw["radiance"].shape == (1, 64)
    if name == "distant_flux":
        assert "radiosity" in out.data_vars
    if name == "mpdistant":
        # each pixel images its own subcell: the 0.9 half is brighter than
        # the 0.1 half in every row of the film
        rad = np.asarray(out["radiance"]).reshape(4, 4)
        assert (rad[2:].min(axis=0) > 2.0 * rad[:2].max(axis=0)).all()


@pytest.fixture
def mono_double_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    eradiate_tpu.set_mode("mono_double")
    eradiate_tpu_torch.set_mode("mono_double")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("name", ["perspective_gaussian", "mpdistant"])
def test_double_mode_matches_reference_under_x64(mono_double_x64, name):
    """In ``mono_double`` every raw pixel's radiance and second moment within
    1e-10 of the reference's under x64."""
    measure, surface = MEASURES[name]
    _, raw, _, ref_raw = run_pair(scene(measure, surface), 64)
    for k in ("radiance", "m2"):
        assert raw[k].dtype == ref_raw[k].dtype == np.float64, k
        np.testing.assert_allclose(raw[k], ref_raw[k], rtol=1e-10, atol=0, err_msg=k)


CONSTANT = {"type": "constant", "radiance": 0.7}
MDISTANT = {"type": "mdistant", "construct": "hplane", "zeniths": [-60.0, 0.0, 30.0, 70.0],
            "azimuth": 0.0, "id": "m"}


def test_constant_sky_plane_parallel(mono_single):
    """Escaping paths collect the sky: within 1e-5 of the reference, and
    with a white floor under a thin atmosphere close to the sky itself."""
    out, _, ref, _ = run_pair(scene(MDISTANT, illumination=CONSTANT), 256)
    same_dataset(out, ref, 256)
    rad = np.asarray(out["radiance"])
    assert (rad > 0.2).all() and (rad < 0.7).all()


@pytest.mark.parametrize("geometry", ["plane_parallel_polarized", "spherical_shell"])
def test_constant_sky_unread_elsewhere(geometry):
    """The spherical and polarized tracers carry the sky in their rows and
    never read it, as the reference's: with no sun they render zero, equal
    to the reference."""
    mode = "mono_polarized_single" if geometry.endswith("polarized") else "mono_single"
    eradiate_tpu.set_mode(mode)
    eradiate_tpu_torch.set_mode(mode)
    try:
        kw = scene(MDISTANT, illumination=CONSTANT)
        if geometry == "spherical_shell":
            kw["geometry"] = "spherical_shell"
        else:
            kw["integrator"] = {"type": "volpath", "stokes": True}
        out, raw, ref, ref_raw = run_pair(kw, 64)
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    np.testing.assert_array_equal(raw["radiance"], ref_raw["radiance"])
    assert not raw["radiance"].any()
    assert set(out.data_vars) == set(ref.data_vars)


def test_constant_sky_over_a_canopy(mono_single):
    """The canopy tracer never reads the sky either: zero, as the
    reference's."""
    def kw(pkg):
        return dict(canopy=small_het01(pkg), illumination=CONSTANT, measures=dict(MDISTANT),
                    surface={"type": "lambertian", "reflectance": 0.159})

    out, raw, ref, ref_raw = run_pair(kw(bio), 32, RefCanopy, CanopyExperiment, kw(ref_bio))
    np.testing.assert_array_equal(raw["radiance"], ref_raw["radiance"])
    assert not raw["radiance"].any()
