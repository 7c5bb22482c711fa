"""Aerosols over shells and canopies, and textured grounds under a canopy,
against the JAX package at one seed.

- c4 at SZA 75 under c2's continental aerosol (0-2 km, ``tab`` phase) in
  ``mono_single``: the lane gate of ``tests/test_torch_spherical_experiment.py``
  with the aerosol's bounds. The lanes whose sum of radiance differs from
  the reference's by more than 1e-3 relative have taken another branch: at
  most 32 of the 480 (15-24 at seeds 7-9; 2-4 for the Rayleigh c4). The
  aerosol's forward peak turns the last-ulp differences of a scattering
  cosine into a different direction more often. The pixels' sums over
  every other lane agree within 2e-4 (1.2e-4 measured at SZA 75, 6e-5 at
  SZA 60, within 5e-5 at SZA 30; 5e-5 for the Rayleigh c4): the aerosol
  doubles the optical depth of the lowest 2 km, so the reference's bf16
  weights of its sun-tau table fetch and both packages' slant depths move
  the sun's transmittance twice as far. Then every pixel within |z| <= 5.
- The small HET01 of ``tests/test_torch_canopy_experiment.py`` under the
  Rayleigh and continental aerosol column: scalar (``tab``) and polarized
  (``tab_polarized``, which the polarized canopy tracer now takes), each
  within the canopy gate (every pixel |z| <= 5 and 2e-3, the median within
  1e-4; Q and U against I).
- The same canopy over a ``checkerboard`` ground (its 0.5 km cells meet
  under the canopy's centre) and over a ``central_patch`` ground (an
  ``rtls`` patch 10 m wide under the crowns, Lambertian around it): the
  canopy tracers hand the ground point to the BSDF, in the units the
  reference hands it.
"""

import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.experiments import CanopyAtmosphereExperiment as RefCanopyAtmosphere
from eradiate_tpu.experiments import CanopyExperiment as RefCanopy
from eradiate_tpu.scenes import biosphere as ref_bio
from eradiate_tpu_torch import AtmosphereExperiment, CanopyAtmosphereExperiment, CanopyExperiment
from eradiate_tpu_torch.scenes import biosphere as bio
from test_torch_canopy_experiment import SPP, gate, kwargs
from test_torch_polarized_canopy import gate as polarized_gate
from test_torch_spherical_experiment import _compile_kwargs, _port_lanes, _ref_lanes, c4_kwargs

torch.set_num_threads(1)

AEROSOL = {
    "type": "heterogeneous",
    "molecular_atmosphere": {"type": "molecular", "has_absorption": False},
    "particle_layers": [{"type": "particle_layer", "bottom": 0.0, "top": 2.0, "tau_ref": 0.2,
                         "dataset": "govaerts_2021-continental"}],
}
GROUNDS = {
    "checkerboard": {"type": "checkerboard", "reflectance_a": 0.1, "reflectance_b": 0.3},
    "central_patch": {"type": "central_patch",
                      "bsdf": {"type": "lambertian", "reflectance": 0.159},
                      "patch_bsdf": {"type": "rtls"}, "patch_edges": 0.005},
}


@pytest.fixture
def mode(request):
    eradiate_tpu.set_mode(request.param)
    eradiate_tpu_torch.set_mode(request.param)
    yield request.param
    eradiate_tpu.set_mode("mono")
    eradiate_tpu_torch.set_mode("mono")


@pytest.mark.parametrize("mode", ["mono_single"], indirect=True)
def test_c4_under_the_aerosol_matches_reference(mode):
    kw = {**c4_kwargs(75.0), "atmosphere": AEROSOL}
    out, ctx = _compile_kwargs(AtmosphereExperiment, kw)
    ref, _ = _compile_kwargs(RefExperiment, kw, ctx)
    assert out[2].phase_kinds == ref[2].phase_kinds == ("rayleigh", "tab")
    spp = 256
    (sums, m2), lp = _port_lanes(*out, spp, 7)
    ref_sums, ref_m2 = _ref_lanes(*ref, spp, 7)
    n_pix = sums.shape[0] // lp
    flip = np.abs(sums - ref_sums) > 1e-3 * np.abs(ref_sums)
    assert 0 < flip.sum() <= 32, flip.reshape(n_pix, lp).sum(1)
    kept, ref_kept = (np.where(flip, 0.0, x).reshape(n_pix, lp).sum(1) for x in (sums, ref_sums))
    np.testing.assert_allclose(kept, ref_kept, rtol=2e-4, atol=0)
    st, ref_st, sq, ref_sq = (x.reshape(n_pix, lp).sum(1) / spp for x in (sums, ref_sums, m2, ref_m2))
    var = (sq - st**2 + ref_sq - ref_st**2) / spp
    assert np.isfinite(st).all() and (np.abs(st - ref_st) / np.sqrt(var) <= 5.0).all()


def _canopy_pair(mode, atmosphere, surface=None):
    """``(port experiment, reference experiment)``: the small HET01 of the
    canopy tests, under ``atmosphere`` (None: none) and over ``surface``."""
    pkg_kw = {}
    for pkg, cls in ((bio, (CanopyAtmosphereExperiment, CanopyExperiment)),
                     (ref_bio, (RefCanopyAtmosphere, RefCanopy))):
        kw = kwargs(pkg, atmosphere=False)
        if mode == "mono_polarized_single":
            kw["integrator"] = {"type": "volpath", "stokes": True}
        if surface is not None:
            kw["surface"] = surface
        if atmosphere is not None:
            pkg_kw[pkg] = cls[0](**kw, atmosphere=atmosphere)
        else:
            pkg_kw[pkg] = cls[1](**kw)
    return pkg_kw[bio], pkg_kw[ref_bio]


def _run_pair(exp, ref_exp):
    ref = eradiate_tpu.run(ref_exp, spp=SPP, seed_state=eradiate_tpu.SeedState(7), mesh=None)
    out = eradiate_tpu_torch.run(exp, spp=SPP, seed_state=eradiate_tpu_torch.SeedState(7),
                                 device="cpu")
    return out, ref


@pytest.mark.parametrize("mode", ["mono_single", "mono_polarized_single"], indirect=True)
def test_canopy_under_the_aerosol_matches_reference(mode):
    exp, ref_exp = _canopy_pair(mode, AEROSOL)
    out, ref = _run_pair(exp, ref_exp)
    if mode == "mono_single":
        gate(out, ref)
        return
    I_ref = np.asarray(ref["I"])
    var = np.asarray(out["var"]) + np.asarray(ref["var"])
    for c in "IQU":
        polarized_gate(np.asarray(out[c]), np.asarray(ref[c]), I_ref, var)
    assert np.asarray(out["dolp"]).max() > 0.02


@pytest.mark.parametrize("mode", ["mono_single"], indirect=True)
@pytest.mark.parametrize("ground", GROUNDS)
def test_canopy_over_a_textured_ground_matches_reference(mode, ground):
    exp, ref_exp = _canopy_pair(mode, None, GROUNDS[ground])
    out, ref = _run_pair(exp, ref_exp)
    gate(out, ref)
