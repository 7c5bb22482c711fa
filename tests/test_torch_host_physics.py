"""The port's host copies of ``physics/ocean_data.py`` and ``physics/mie.py``.

The analogs of ``tests/unit/test_ocean_data.py`` and
``tests/unit/test_mie.py`` on the port's copies (the tables' published
anchors, the case-1 underlight's ocean colour, the Mie solver's analytic
limits), the copies' outputs equal to the reference's bit for bit on the
same inputs, and the ocean BSDF's scene element carrying the tables' values
into the port's ``ocean_legacy``.
"""

import numpy as np
import pytest
import torch

from eradiate_tpu.physics import mie as ref_mie
from eradiate_tpu.physics import ocean_data as ref_od
from eradiate_tpu_torch.ops import bsdf_ops
from eradiate_tpu_torch.physics import mie
from eradiate_tpu_torch.physics import ocean_data as od
from eradiate_tpu_torch.scenes.bsdfs import bsdf_factory

MU = np.linspace(-1.0, 1.0, 361)
W = np.linspace(250.0, 2500.0, 97)


def test_water_ior_anchors():
    assert od.water_ior(550.0, 0.0) == pytest.approx(1.333, abs=2e-3)
    assert od.water_ior(400.0, 0.0) == pytest.approx(1.339, abs=2e-3)
    assert od.water_ior(1000.0, 0.0) == pytest.approx(1.327, abs=2e-3)
    assert od.water_ior(2500.0, 0.0) == pytest.approx(1.261, abs=3e-3)
    assert od.water_ior(550.0, 19.0) > od.water_ior(550.0, 0.0)
    assert np.all(np.diff(od.water_ior(np.linspace(400.0, 2400.0, 60), 0.0)) <= 1e-12)


def test_water_absorption_anchors():
    assert od.water_absorption_m1(420.0)[0] == pytest.approx(0.00454, rel=0.05)
    assert od.water_absorption_m1(440.0)[0] == pytest.approx(0.00635, rel=0.05)
    assert od.water_absorption_m1(700.0)[0] == pytest.approx(0.624, rel=0.05)
    assert od.water_absorption_m1(1450.0)[0] / od.water_absorption_m1(450.0)[0] > 1e4


def test_case1_reflectance_is_ocean_colour():
    """Clear water is blue, eutrophic water greener, and pigment darkens the
    blue; the NIR is dark."""
    assert od.case1_water_reflectance(440.0, 0.03)[0] > 2 * od.case1_water_reflectance(560.0, 0.03)[0]
    assert od.case1_water_reflectance(440.0, 10.0)[0] < 1.5 * od.case1_water_reflectance(560.0, 10.0)[0]
    assert 0.01 < od.case1_water_reflectance(440.0, 0.1)[0] < 0.15
    assert od.case1_water_reflectance(900.0, 0.1)[0] < 1e-3
    r = [od.case1_water_reflectance(440.0, c)[0] for c in (0.03, 0.3, 3.0)]
    assert r[0] > r[1] > r[2]


@pytest.mark.parametrize("fn, args", [
    ("water_ior", (W, 19.0)), ("water_ior", (W, 0.0)), ("water_ior_imag", (W,)),
    ("water_absorption_m1", (W,)), ("case1_water_reflectance", (W, 0.3)),
    ("case1_water_reflectance", (W, 5.0)),
])
def test_ocean_tables_equal_the_references(fn, args):
    np.testing.assert_array_equal(getattr(od, fn)(*args), getattr(ref_od, fn)(*args))


def test_rayleigh_limit():
    """x << 1: Qsca -> (8/3) x^4 |(m^2-1)/(m^2+2)|^2; the dipole pattern."""
    m = complex(1.5, -0.0)
    lor = (m * m - 1.0) / (m * m + 2.0)
    for x in (0.01, 0.03):
        _, Qsca, _, _ = mie.mie_single(x, m, MU)
        np.testing.assert_allclose(Qsca, 8.0 / 3.0 * x**4 * abs(lor) ** 2, rtol=5e-3)
    _, _, S1, S2 = mie.mie_single(0.01, complex(1.33, 0.0), MU)
    i11 = np.abs(S1) ** 2 + np.abs(S2) ** 2
    np.testing.assert_allclose(i11 / i11[-1], (1.0 + MU**2) / 2.0, rtol=1e-3)
    np.testing.assert_allclose((np.abs(S1) ** 2 - np.abs(S2) ** 2) / i11,
                               (1.0 - MU**2) / (1.0 + MU**2), atol=1e-3)


def test_mie_limits_and_conservation():
    Qext, Qsca, _, _ = mie.mie_single(150.0, complex(1.5, -0.1), MU[:3])
    assert abs(Qext - 2.0) < 0.1 and 0.0 < Qsca < Qext  # the extinction paradox
    for x in (0.5, 3.0, 20.0):
        Qext, Qsca, _, _ = mie.mie_single(x, complex(1.45, -0.005), MU[:3])
        assert 0.0 < Qsca <= Qext + 1e-12
    Qext, Qsca, _, _ = mie.mie_single(5.0, complex(1.33, 0.0), MU[:3])
    np.testing.assert_allclose(Qsca, Qext, rtol=1e-10)
    x, m = 4.0, complex(1.5, -0.02)
    Qext, _, S1, S2 = mie.mie_single(x, m, np.array([1.0]))  # the optical theorem
    np.testing.assert_allclose(Qext, 4.0 / (x * x) * S1[0].real, rtol=1e-10)
    np.testing.assert_allclose(S1[0].real, S2[0].real, rtol=1e-12)


def test_lognormal_phase_matrix():
    out = mie.mie_lognormal(0.55, complex(1.53, -0.006), 0.2, 2.0, MU, n_quad=48)
    p11 = out["P11"]
    assert np.all(p11 > 0) and p11[-1] == p11.max()
    np.testing.assert_allclose(np.trapezoid(p11, MU) / 2.0, 1.0, rtol=1e-12)
    for k in ("P12", "P33", "P34"):
        assert np.all(np.abs(out[k]) <= p11 + 1e-12)
    g = np.trapezoid(p11 * MU, MU) / np.trapezoid(p11, MU)
    assert 0.5 < g < 0.9 and out["sigma_sca"] < out["sigma_ext"]


def test_mie_equals_the_references():
    a = mie.mie_single(3.0, complex(1.5, -0.01), MU)
    b = ref_mie.mie_single(3.0, complex(1.5, -0.01), MU)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = mie.mie_lognormal(0.55, complex(1.53, -0.006), 0.1, 2.0, MU, n_quad=24)
    b = ref_mie.mie_lognormal(0.55, complex(1.53, -0.006), 0.1, 2.0, MU, n_quad=24)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_ocean_bsdf_carries_the_tables():
    """The scene element evaluates the tables (no longer refused), and the
    port's ``ocean_legacy`` reads ``n_water``: a doctored value moves it."""
    b = bsdf_factory.convert({"type": "ocean_legacy", "wind_speed": 5.0})
    w = [440.0, 550.0, 1600.0]
    params = b.eval_params(w)
    np.testing.assert_array_equal(params["n_water"], ref_od.water_ior(w, 19.0))
    np.testing.assert_array_equal(params["r_water"], ref_od.case1_water_reflectance(w, 0.3))

    def direction(zen, az=0.0):
        z, a = np.deg2rad(zen), np.deg2rad(az)
        return torch.tensor([[np.sin(z) * np.cos(a), np.sin(z) * np.sin(a), np.cos(z)]])

    base = {k: torch.tensor([v]) for k, v in
            {"wind_speed": 5.0, "wind_azimuth": 0.0, "chlorinity": 19.0,
             "pigmentation": 0.3, "wavelength": 550.0}.items()}
    wi, wo = direction(30.0), direction(30.0, 180.0)
    f_fallback = float(bsdf_ops.bsdf_eval("ocean_legacy", base, wi, wo)[0])
    doctored = {**base, "n_water": torch.tensor([1.5]), "r_water": torch.tensor([0.0])}
    f_table = float(bsdf_ops.bsdf_eval("ocean_legacy", doctored, wi, wo)[0])
    assert f_table != pytest.approx(f_fallback, rel=1e-3)
