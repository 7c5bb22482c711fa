"""Every surface kind through ``eradiate_tpu_torch.run`` against the JAX
package, on c1's column (``mono_single``).

c1's scene (AFGL Rayleigh column, sun at SZA 30) at 3 view zeniths: the hot
spot (-30), the specular view (30) and 60, aimed at a target off the origin
so that the surface points of a composite or a texture differ from the
defaults. Each kind of the reference's ``_EVAL`` and each composite renders
at 256 spp and one seed within 1e-5 relative a pixel of ``eradiate_tpu.run``.
The plane-parallel tracers hand the surface point to the BSDF, rounded as
the jitted reference rounds it where the kind reads it (one fused
multiply-add a step). In float32 the scattered directions still differ from
the reference's in the last ulp (torch's and XLA's libm), and a path tens of
km long carries that into its surface point: over a map of 375 m cells (3
km wide, 8 cells) one pixel of the seed here moves by 3e-5. The bitmap case
therefore takes the 20 km map of the reference's system tests; the 3 km
map is held within 1e-10 in ``mono_double``
(``tests/test_torch_surfaces_modes.py``), where the arithmetic is the
reference's.

The oracles of ``tests/system/test_textured_surfaces.py``, on the port
alone: with no atmosphere, the BRF of a distant view equals the local
reflectance at the targeted point.
"""

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu_torch import AtmosphereExperiment

torch.set_num_threads(1)

SPP = 256
ZENITHS = [-30.0, 30.0, 60.0]
TARGET = [0.3, -0.2, 0.0]

_rng = np.random.default_rng(23)
MQ_DATA = _rng.uniform(0.05, 0.5, (6, 9, 5))
MAP = _rng.uniform(0.1, 0.9, (6, 8))

#: one surface of every kind, and the composites of ``central_patch``,
#: ``opacity_mask`` and ``selectbsdf``
SURFACES = {
    "black": {"type": "black"},
    "lambertian": {"type": "lambertian", "reflectance": 0.5},
    "rpv": {"type": "rpv"},
    "hapke": {"type": "hapke"},
    "rtls": {"type": "rtls"},
    "bilambertian": {"type": "bilambertian", "reflectance": 0.3, "transmittance": 0.2},
    "ocean_legacy": {"type": "ocean_legacy"},  # the calm default (0.01 m/s)
    "ocean_grasp": {"type": "ocean_grasp", "wind_speed": 2.0, "water_body_reflectance": 0.02},
    "mqdiffuse": {"type": "mqdiffuse", "data": MQ_DATA},
    # the 20 km map of the reference's system tests: a map of 375 m cells
    # moves a pixel by up to 3e-5 in float32 (see the module's docstring)
    "bitmap": {"type": "bitmap", "data": MAP, "extent": 20.0},
    "checkerboard": {"type": "checkerboard"},
    "maignan": {"type": "maignan"},
    "ocean_mishchenko": {"type": "ocean_mishchenko", "wind_speed": 2.0},
    "central_patch": {"type": "central_patch", "bsdf": {"type": "rtls"},
                      "patch_bsdf": {"type": "lambertian", "reflectance": 0.8},
                      "patch_edges": 1.0},
    "opacity_mask": {"type": "opacity_mask", "nested_bsdf": {"type": "rpv"},
                     "opacity": _rng.uniform(0.2, 1.0, (4, 4)), "extent": 5.0},
    "selectbsdf": {"type": "selectbsdf",
                   "bsdfs": [{"type": "lambertian", "reflectance": 0.1}, {"type": "rtls"},
                             {"type": "black"}],
                   "index_map": [[0, 1], [2, 1]], "extent": 4.0},
}


def c1_kwargs(surface, zeniths=ZENITHS):
    return dict(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": zeniths,
                  "azimuth": 0.0, "target": TARGET, "id": "m"},
        surface=surface,
        atmosphere={"type": "molecular"},
    )


def render_pair(surface, mode, spp=SPP, seed=7):
    """The raw results of the reference and of the port (on the CPU) in
    ``mode``, at one seed."""
    eradiate_tpu.set_mode(mode)
    eradiate_tpu_torch.set_mode(mode)
    try:
        ref = RefExperiment(**c1_kwargs(surface))
        eradiate_tpu.run(ref, spp=spp, seed_state=SeedState(seed), mesh=None)
        out = AtmosphereExperiment(**c1_kwargs(surface))
        eradiate_tpu_torch.run(out, spp=spp, seed_state=eradiate_tpu_torch.SeedState(seed),
                               device="cpu")
    finally:
        eradiate_tpu.set_mode("mono")
        eradiate_tpu_torch.set_mode("mono")
    return ({k: np.asarray(v) for k, v in ref.measures[0].results["raw"].items()},
            out.measures[0].results["raw"])


@pytest.mark.parametrize("name", SURFACES)
def test_every_kind_matches_reference(name):
    ref, raw = render_pair(SURFACES[name], "mono_single")
    rad, ref_rad = np.asarray(raw["radiance"]), ref["radiance"]
    assert rad.dtype == ref_rad.dtype == np.float32 and rad.shape == ref_rad.shape == (1, 3)
    assert np.isfinite(rad).all() and (rad > 0).all()
    np.testing.assert_allclose(rad, ref_rad, rtol=1e-5, atol=0)
    np.testing.assert_allclose(np.asarray(raw["m2"]), ref["m2"], rtol=1e-5, atol=0)


def test_surfaces_change_the_render():
    """The cases differ where they should: the patch is seen at the target,
    a texture's render moves with the target."""
    def radiance(surface, target):
        kw = c1_kwargs(surface, [0.0])
        kw["measures"]["target"] = target
        exp = AtmosphereExperiment(**kw)
        eradiate_tpu_torch.run(exp, spp=64, seed_state=eradiate_tpu_torch.SeedState(3),
                               device="cpu")
        return float(np.asarray(exp.measures[0].results["raw"]["radiance"])[0, 0])

    eradiate_tpu_torch.set_mode("mono_single")
    try:
        patch = SURFACES["central_patch"]
        assert radiance(patch, [0.0, 0.0, 0.0]) > 1.5 * radiance(patch, [5.0, 0.0, 0.0])
        bitmap = {"type": "bitmap", "data": [[0.1, 0.9]], "extent": 20.0}
        assert radiance(bitmap, [5.0, 0.0, 0.0]) > 2.0 * radiance(bitmap, [-5.0, 0.0, 0.0])
    finally:
        eradiate_tpu_torch.set_mode("mono")


def _oracle_brf(surface, target_xyz):
    """The port's BRF of one nadir view of ``surface`` at ``target_xyz`` with
    no atmosphere (``tests/system/test_textured_surfaces.py``)."""
    exp = AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "irradiance": 1.0},
        measures={"type": "mdistant", "construct": "from_angles", "angles": [[0.0, 0.0]],
                  "target": {"type": "point", "xyz": target_xyz}, "spp": 32, "id": "m"},
        surface=surface,
        atmosphere=None,
    )
    return float(np.asarray(eradiate_tpu_torch.run(exp, device="cpu")["brf"]).ravel()[0])


@pytest.mark.parametrize("surface, cases, rtol", [
    ({"type": "central_patch", "bsdf": {"type": "lambertian", "reflectance": 0.2},
      "patch_bsdf": {"type": "lambertian", "reflectance": 0.8}, "patch_edges": 1.0},
     [([0.0, 0.0, 0.0], 0.8), ([5.0, 0.0, 0.0], 0.2)], 1e-4),
    ({"type": "selectbsdf", "bsdfs": [{"type": "lambertian", "reflectance": 0.1},
                                      {"type": "lambertian", "reflectance": 0.9}],
      "index_map": [[0, 1]], "extent": 20.0},
     [([-5.0, 0.0, 0.0], 0.1), ([5.0, 0.0, 0.0], 0.9)], 1e-4),
    ({"type": "bitmap", "data": np.concatenate([np.full((8, 4), 0.25), np.full((8, 4), 0.75)],
                                               axis=1), "extent": 20.0},
     [([-5.0, 0.0, 0.0], 0.25), ([5.0, 0.0, 0.0], 0.75)], 1e-3),
    ({"type": "opacity_mask", "nested_bsdf": {"type": "lambertian", "reflectance": 0.6},
      "opacity": np.full((4, 4), 0.5), "extent": 50.0}, [([0.0, 0.0, 0.0], 0.3)], 1e-3),
    ({"type": "checkerboard"}, [([-0.4, -0.4, 0.0], 0.2), ([0.1, -0.4, 0.0], 0.8)], 1e-4),
], ids=["central_patch", "selectbsdf", "bitmap", "opacity_mask", "checkerboard"])
def test_textured_surface_oracles(surface, cases, rtol):
    eradiate_tpu_torch.set_mode("mono")
    for target, brf in cases:
        np.testing.assert_allclose(_oracle_brf(surface, target), brf, rtol=rtol)
