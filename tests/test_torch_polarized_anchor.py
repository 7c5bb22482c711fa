"""External correctness anchor for the port's polarized tracer: Monte Carlo
Stokes vectors against deterministic vector adding-doubling.

The port's ``render_polarized`` (on the CPU) renders a plane-parallel
Rayleigh slab (optical depth 0.5, single-scattering albedo 1) over a
Lambertian ground of reflectance 0.3, without and with air's
depolarization (0.0279), seen at six geometries on and off the principal
plane; the port's copy of ``physics/vector_doubling.py`` (float64 numpy,
no code shared with the Monte Carlo path) solves the same problem. The
tolerances are those of the JAX package's anchor
(``tests/system/test_doubling_anchor.py``): I within 4 sigma of the Monte
Carlo plus 2e-4 of the solver's first I and 1% relative; Q/I, U/I and V/I
within the larger of 4 sigma/I and 0.006; 65536 samples a pixel. Any
engine-wide error in the Mueller chain (sign, scale, frame rotation, phase
normalization) fails here, which a comparison with the reference alone
could share. Neither ``jax`` nor ``eradiate_tpu`` is imported.
"""

import numpy as np
import pytest
import torch

from eradiate_tpu_torch.core.frame import angles_to_direction
from eradiate_tpu_torch.physics.vector_doubling import rayleigh_stokes_toa
from eradiate_tpu_torch.ops.scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneArrays,
    SceneConfig,
    SensorArrays,
    SurfaceArrays,
)
from eradiate_tpu_torch.ops.tracer_polarized import render_polarized

torch.set_num_threads(1)

TAU = 0.5
SZA = 40.0
MU0 = float(np.cos(np.deg2rad(SZA)))
SPP = 65536
#: (vza, vaa) in degrees; vaa = 0 is the principal plane.
GEOMS = [(15.0, 0.0), (45.0, 0.0), (60.0, 0.0), (30.0, 60.0), (45.0, 120.0), (60.0, 240.0)]


def slab(reflectance, depol, n_layers=10, top=100.0):
    """The Rayleigh slab of the JAX package's anchor (its ``make_scene``),
    as numpy leaves."""
    z_levels = np.linspace(0.0, top, n_layers + 1)
    dtau = np.full(n_layers, TAU / n_layers, np.float32)
    tau_levels = np.concatenate([[0.0], np.cumsum(dtau, dtype=np.float32)])[None]
    medium = MediumArrays(
        z_levels=z_levels,
        tau_levels=tau_levels,
        albedo=np.ones((1, n_layers)),
        phase_weights=np.ones((1, 1, n_layers)),
        phase_params=({"depol": np.full((1, n_layers), depol)},),
    )
    d_sun = -angles_to_direction([np.deg2rad(SZA), 0.0])[0]
    illumination = IlluminationArrays(direction=d_sun, irradiance=np.ones(1),
                                      cos_cutoff=1.0, sky_radiance=np.zeros(1))
    surface = SurfaceArrays(params={"reflectance": np.full(1, reflectance)})
    vza, vaa = np.deg2rad(np.array(GEOMS)).T
    sensor = SensorArrays(directions=angles_to_direction(np.stack([vza, vaa], -1)),
                          target=np.zeros(3), ray_offset=np.nan)
    return SceneArrays(medium, surface, illumination), sensor


@pytest.mark.parametrize("depol", [0.0, 0.0279])
def test_stokes_match_adding_doubling(depol):
    reflectance = 0.3
    scene, sensor = slab(reflectance, depol)
    config = SceneConfig(surface_kind="lambertian", polarized=True, max_depth=24)
    out = render_polarized(scene, sensor, config, SPP, seed=7, device="cpu")
    st = out["stokes"][0].numpy().astype(np.float64)
    sigma_I = np.sqrt(np.maximum(out["m2"][0].numpy() - st[:, 0] ** 2, 0.0) / SPP)

    vza, vaa = np.array(GEOMS).T
    # the sun propagates toward azimuth 180 deg; the solver's azimuth is the
    # view's relative to the sun's horizontal propagation
    S = rayleigh_stokes_toa(TAU, MU0, np.cos(np.deg2rad(vza)), np.deg2rad(vaa) - np.pi,
                            albedo=reflectance, omega=1.0, depol=depol, n_mu=48)
    np.testing.assert_allclose(st[:, 0], S[:, 0], rtol=0.01,
                               atol=np.max(4 * sigma_I) + 2e-4 * S[0, 0])
    ratio_tol = float(np.max(np.maximum(4 * sigma_I / S[:, 0], 0.006)))
    for c in (1, 2):
        np.testing.assert_allclose(st[:, c] / st[:, 0], S[:, c] / S[:, 0], atol=ratio_tol)
    np.testing.assert_allclose(st[:, 3] / st[:, 0], 0.0, atol=ratio_tol)
    # the anchor has teeth: the slab polarizes well beyond the tolerance
    assert np.abs(S[:, 1] / S[:, 0]).max() > 5 * ratio_tol
