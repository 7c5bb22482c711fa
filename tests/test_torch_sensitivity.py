"""``eradiate_tpu_torch.sensitivity.sensitivities`` on plane-parallel scenes,
against ``eradiate_tpu.sensitivity.sensitivities`` at the same seed, on the
CPU.

One scene shape, c1's column at 3 view zeniths and 256 spp (a compile of the
reference each), with the channels ``surface.reflectance``,
``medium.albedo``, ``medium.tau_scale`` and
``illumination.irradiance_scale`` in ``mono_single`` and
``mono_polarized_single``, RPV's ``surface.k`` and ``surface.rho_0``, and
``gas.H2O`` on the synthetic absorption database: values within 1e-5
relative, each tangent within 1e-4 of its channel's largest |tangent| (BRF
and radiance); in ``mono_double`` (the reference under x64) within 1e-9.

Port only: the primal equals the production render (RR off, no
``lr_flight``) bit for bit, scalar and polarized; the BRF is invariant under
``illumination.irradiance_scale`` and the radiance linear in it; the gas
channel leaves the merge tolerances as it found them; and the refusals
(unknown channel or surface parameter, a leaf channel without a canopy, an
unknown species, a third-party dispatch, a ``mesh=`` that is no mesh).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import eradiate_tpu
import eradiate_tpu_torch
from eradiate_tpu.experiments import AtmosphereExperiment as RefExperiment
from eradiate_tpu.physics.absorption import make_synthetic_mono_db as ref_mono_db
from eradiate_tpu.sensitivity import sensitivities as ref_sensitivities
from eradiate_tpu_torch import AtmosphereExperiment
from eradiate_tpu_torch.physics.absorption import make_synthetic_mono_db
from eradiate_tpu_torch.sensitivity import channel_names, sensitivities

torch.set_num_threads(1)

SPP = 256
SEED = 7
CHANNELS = ("surface.reflectance", "medium.albedo", "medium.tau_scale",
            "illumination.irradiance_scale")


def _kwargs(surface=None, atmosphere=None):
    return dict(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [-60.0, 0.0, 60.0],
                  "azimuth": 0.0, "spp": SPP, "id": "m"},
        surface=surface or {"type": "lambertian", "reflectance": 0.5},
        atmosphere=atmosphere or {"type": "molecular"},
    )


def _pair(mode, wrt, kwargs=None, ref_kwargs=None, x64=False):
    """(port entry, reference entry) at one seed in ``mode``."""
    kwargs = kwargs or _kwargs()
    eradiate_tpu.set_mode(mode)
    eradiate_tpu_torch.set_mode(mode)
    old = jax.config.jax_enable_x64
    try:
        out = sensitivities(AtmosphereExperiment(**kwargs), wrt, seed=SEED, device="cpu")["m"]
        jax.config.update("jax_enable_x64", x64)
        ref = ref_sensitivities(RefExperiment(**(ref_kwargs or kwargs)), wrt, seed=SEED)
    finally:
        jax.config.update("jax_enable_x64", old)
        eradiate_tpu.set_mode("mono_single")
        eradiate_tpu_torch.set_mode("mono_single")
    (ref,) = ref.values()
    return out, ref


def _check(out, ref, wrt, rtol, ttol):
    for key in ("radiance", "brf", "radiance_var"):
        np.testing.assert_allclose(out[key], ref[key], rtol=rtol, atol=0)
    for ch in wrt:
        for key in ("radiance", "brf"):
            a, b = out["jac"][ch][key], ref["jac"][ch][key]
            scale = np.abs(b).max()
            assert a.shape == b.shape and np.isfinite(a).all()
            assert np.abs(a - b).max() <= ttol * scale, (ch, key, np.abs(a - b).max() / scale)


@pytest.mark.parametrize("mode", ["mono_single", "mono_polarized_single"])
def test_channels_match_the_reference(mode):
    out, ref = _pair(mode, CHANNELS)
    _check(out, ref, CHANNELS, 1e-5, 1e-4)
    # the extinction channel is live: the likelihood-ratio weights carry it
    assert np.abs(out["jac"]["medium.tau_scale"]["radiance"]).max() > 1e-3


def test_rpv_shape_channels_match_the_reference():
    wrt = ("surface.k", "surface.rho_0")
    kw = _kwargs(surface={"type": "rpv", "rho_0": 0.18, "k": 0.75, "g": -0.1})
    out, ref = _pair("mono_single", wrt, kw)
    _check(out, ref, wrt, 1e-5, 1e-4)
    assert (out["jac"]["surface.rho_0"]["radiance"] > 0).all()


def _gas_kwargs(db):
    return _kwargs(atmosphere={"type": "molecular", "absorption_data": db})


def _gas_db(maker):
    return maker(w_nm=np.linspace(500.0, 600.0, 8), base_sigma=5e-3, species="H2O")


def test_gas_channel_matches_the_reference():
    out, ref = _pair("mono_single", ("gas.H2O",), _gas_kwargs(_gas_db(make_synthetic_mono_db)),
                     _gas_kwargs(_gas_db(ref_mono_db)))
    _check(out, ref, ("gas.H2O",), 1e-5, 1e-4)
    assert (out["jac"]["gas.H2O"]["radiance"] < 0).all()


def test_double_mode_matches_the_reference_under_x64():
    wrt = ("medium.albedo", "medium.tau_scale")
    out, ref = _pair("mono_double", wrt, x64=True)
    assert out["radiance"].dtype == np.float64
    _check(out, ref, wrt, 1e-9, 1e-9)


def _production(mode):
    """The production render of the sensitivity scene (RR off, no
    ``lr_flight``) at the sensitivity seed."""
    eradiate_tpu_torch.set_mode(mode)
    exp = AtmosphereExperiment(**_kwargs())
    m = exp.measures[0]
    scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
    config = dataclasses.replace(config, rr_depth=config.max_depth)
    return exp, exp._render_one(scene, sensor, config, SPP, SEED, device="cpu")


@pytest.mark.parametrize("mode", ["mono_single", "mono_polarized_single"])
def test_the_primal_is_the_production_render_bit_for_bit(mode):
    """The likelihood-ratio weights are 1 in the primal: the sensitivity
    value equals the production render, and so does the ``lr_flight``
    render without a tangent."""
    try:
        exp, raw = _production(mode)
        out = sensitivities(exp, ["medium.tau_scale"], seed=SEED, device="cpu")["m"]
        m = exp.measures[0]
        scene, sensor, config = exp.compile_scene(m, exp.spectral_context(m))
        lr = exp._render_one(scene, sensor, dataclasses.replace(
            config, rr_depth=config.max_depth, lr_flight=True), SPP, SEED, device="cpu")
    finally:
        eradiate_tpu_torch.set_mode("mono_single")
    want = raw["radiance"].numpy()
    assert np.array_equal(out["radiance"], want)
    assert np.array_equal(lr["radiance"].numpy(), want)
    if mode == "mono_polarized_single":
        assert torch.equal(lr["stokes"], raw["stokes"])


def test_irradiance_scale_is_linear_and_leaves_the_brf():
    exp = AtmosphereExperiment(**_kwargs())
    e = sensitivities(exp, ["illumination.irradiance_scale"], seed=0, device="cpu")["m"]
    jac = e["jac"]["illumination.irradiance_scale"]
    np.testing.assert_allclose(jac["radiance"], e["radiance"], rtol=1e-6)
    np.testing.assert_allclose(jac["brf"], 0.0, atol=1e-7)


def test_gas_channel_restores_the_merge_tolerance():
    exp = AtmosphereExperiment(**_gas_kwargs(_gas_db(make_synthetic_mono_db)))
    exp.measures[0].spp = 16
    before = exp.geometry.layer_merge_tol
    sensitivities(exp, ["gas.H2O"], seed=0, device="cpu")
    assert exp.geometry.layer_merge_tol == before


def test_channel_names():
    exp = AtmosphereExperiment(**_kwargs())
    m = exp.measures[0]
    scene, _, _ = exp.compile_scene(m, exp.spectral_context(m))
    assert channel_names(scene) == ["surface.reflectance", "medium.albedo",
                                    "medium.tau_scale", "illumination.irradiance_scale"]
    assert channel_names(scene, canopy=True)[-2:] == ["canopy.reflectance",
                                                      "canopy.transmittance"]


class _ThirdParty(AtmosphereExperiment):
    def process(self, *args, **kwargs):
        return super().process(*args, **kwargs)


@pytest.mark.parametrize("case, error, words", [
    ("medium.banana", ValueError, "unknown sensitivity channel"),
    ("surface.banana", KeyError, "not in compiled scene"),
    ("canopy.reflectance", ValueError, "requires a canopy"),
    ("gas.XYZ", ValueError, "not in the thermophysical"),
    ("gas.O3", ValueError, "not resolvable"),
    ("third party", NotImplementedError, "_ThirdParty"),
    ("mesh", ValueError, "mesh must be 'auto', None or a DeviceMesh"),
])
def test_refusals(case, error, words):
    if case.startswith("gas."):
        exp = AtmosphereExperiment(**_gas_kwargs(_gas_db(make_synthetic_mono_db)))
    elif case == "third party":
        exp = _ThirdParty(**_kwargs())
    else:
        exp = AtmosphereExperiment(**_kwargs())
    exp.measures[0].spp = 16
    wrt = ["surface.reflectance"] if case in ("third party", "mesh") else [case]
    with pytest.raises(error, match=words):
        sensitivities(exp, wrt, seed=0, device="cpu", mesh="eight" if case == "mesh" else None)
