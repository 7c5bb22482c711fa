"""The port's spherical-shell path in ``mono_double`` against the JAX package
under x64, and the 1e6 km analog of the reference's cross gate.

c4 (``bench.py`` ``_c4``: Rayleigh AFGL shells over Hapke, 15 view zeniths)
in the double modes takes the exact slant depth at every event: the sun-tau
table is float32 only, in the reference as in the port, so SZA 75 and 85
both run the shell event (K3's twin), and path B (``lr_flight``) the shell
flight then the slant depth (K2's, then K4's twin).

- **The lane gate in float64** (``double_lane_gate``), at one seed, scalar
  and polarized: the reference's partition of the samples into lanes,
  each lane's sum of I against the reference's. A lane that differs by more
  than 1e-10 relative took another rounding: XLA:CPU forms float64 fused
  multiply-adds in the ray-sphere roots and the radicands, where the port
  rounds twice, and along grazing rays an ulp there grows (the ground-hit
  distance ``|b| - sqrt(b^2 - c)`` cancels). At most a few such lanes, none
  of them a branch flip (more than 1e-3) but for at most two; every other
  lane, and the pixels' sums over them, within 1e-10; every pixel within
  |z| <= 5 (Q, U and V with I's variances).
- **The 1e6 km analog** of ``tests/system/test_cross_gates.py``'s
  ``r1e6_f64``: in ``mono_double`` the port's plane-parallel BRF against its
  spherical one at a planet radius of 1e6 km, within 3 sigma + 0.2%, and the
  port's spherical render there against the reference's at the same seed by
  the lane gate. Float32 cannot resolve 0.1 km shells at that radius.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu_torch import AtmosphereExperiment
from test_torch_spherical_experiment import _compile_kwargs, _port_lanes, _ref_lanes, c4_kwargs

torch.set_num_threads(1)

RTOL = 1e-10
SPP = 64


@pytest.fixture
def x64():
    """``mono_double`` in both packages, the reference under x64."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


def _set(mode_id):
    eradiate_tpu.set_mode(mode_id)
    eradiate_tpu_torch.set_mode(mode_id)


def double_lane_gate(out_scene, ref_scene, spp, seed, max_spread, max_flips=2):
    """The lane gate of the module docstring; returns ``(spread, flips)``,
    the lanes beyond 1e-10 and beyond 1e-3 relative."""
    (sums, m2), lp = _port_lanes(*out_scene, spp, seed)
    ref_sums, ref_m2 = _ref_lanes(*ref_scene, spp, seed)
    assert sums.dtype == ref_sums.dtype == np.float64
    n_pix = sums.shape[0] // lp
    I, ref_I = (sums[:, 0], ref_sums[:, 0]) if sums.ndim == 2 else (sums, ref_sums)
    rel = np.abs(I - ref_I) / np.maximum(np.abs(ref_I), 1e-300)
    spread, flip = rel > RTOL, rel > 1e-3
    assert flip.sum() <= max_flips, rel[flip]
    assert spread.sum() <= max_spread, np.sort(rel[spread])
    kept, ref_kept = (np.where(spread, 0.0, x).reshape(n_pix, lp).sum(1) for x in (I, ref_I))
    np.testing.assert_allclose(kept, ref_kept, rtol=RTOL, atol=0)

    def pixels(x):
        return x.reshape(n_pix, lp, -1).sum(1) / spp

    st, ref_st, sq, ref_sq = pixels(sums), pixels(ref_sums), pixels(m2), pixels(ref_m2)
    var = (sq - st[:, :1] ** 2 + ref_sq - ref_st[:, :1] ** 2) / spp
    assert np.isfinite(st).all() and (np.abs(st - ref_st) / np.sqrt(var) <= 5.0).all()
    return int(spread.sum()), int(flip.sum())


def _pair(kwargs, lr_flight=False):
    out, ctx = _compile_kwargs(AtmosphereExperiment, kwargs)
    ref, _ = _compile_kwargs(RefExperiment, kwargs, ctx)
    assert out[0].medium.sun_tau is None and ref[0].medium.sun_tau is None
    assert out[0].medium.radii.dtype == np.float64
    if lr_flight:
        out = (*out[:2], dataclasses.replace(out[2], lr_flight=True))
        ref = (*ref[:2], dataclasses.replace(ref[2], lr_flight=True))
    return out, ref


@pytest.mark.parametrize("polarized", [False, True], ids=["scalar", "polarized"])
@pytest.mark.parametrize("path", ["sza75", "sza85", "path_b"])
def test_c4_lane_gate_against_reference_under_x64(x64, path, polarized):
    _set("mono_polarized_double" if polarized else "mono_double")
    kwargs = c4_kwargs(85.0 if path == "sza85" else 75.0)
    if polarized:
        kwargs["integrator"] = {"type": "volpath", "stokes": True}
    out, ref = _pair(kwargs, lr_flight=path == "path_b")
    spread, flips = double_lane_gate(out, ref, SPP, seed=7, max_spread=8)
    assert flips == 0


def test_planet_of_1e6_km(x64):
    """``r1e6_f64``'s analog: plane-parallel against spherical shells at a
    planet radius of 1e6 km in the port (3 sigma + 0.2%), and the port's
    spherical render against the reference's at the same seed."""
    _set("mono_double")
    kwargs = dict(
        illumination={"type": "directional", "zenith": 40.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-45.0, 0.0, 45.0],
                  "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.3},
        atmosphere={"type": "molecular"},
    )
    spherical = {**kwargs, "geometry": {"type": "spherical_shell", "planet_radius": 1.0e6}}
    spp = 4096
    r_pp = eradiate_tpu_torch.run(AtmosphereExperiment(**kwargs), spp=spp, device="cpu")
    r_sp = eradiate_tpu_torch.run(AtmosphereExperiment(**spherical), spp=spp, device="cpu")
    bp, bs = r_pp["brf"].values[0], r_sp["brf"].values[0]
    sig = np.pi * np.sqrt(r_pp["var"].values[0] + r_sp["var"].values[0]) / float(
        r_pp["irradiance"].values[0])
    assert np.all(np.abs(bp - bs) < 3 * sig + 2e-3 * bp), (bp, bs, sig)
    out, ref = _pair({**spherical, "measures": {**kwargs["measures"],
                                                "target": [0.0, 0.0, 1.0e6]}})
    double_lane_gate(out, ref, SPP, seed=5, max_spread=8)
