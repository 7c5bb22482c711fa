"""The kernels' forward-mode rules and refusals, and the shell depths of the
likelihood-ratio flight, on the CPU.

A CUDA kernel writes its outputs through raw pointers, so a forward-mode
dual would lose its tangent there without an error. Each wrapper therefore
has a rule (``torch.autograd.Function.jvp``) or refuses a dual. On CPU
tensors the wrappers run their plain versions inside the same rules, so:

- K1's rule (the collision fetch with a tangent on the fetched tables, the
  c1 and c2 columns with the layers' thicknesses in front, as the
  likelihood-ratio flight fetches them) equals forward AD through
  ``collision_fetch_plain`` bit for bit, float32 and float64;
- K4's rule (the slant depth with a tangent on sigma) equals forward AD
  through ``slant_tau_exact`` bit for bit on the slant stresses, blocked
  lanes included;
- ``shell_depths_plain`` on the tangent of sigma equals ``jax.jvp`` of the
  reference's ``shell_flight_lr`` (the tangents of ``g_col`` and
  ``tau_max_att``) on K2's stress lanes of five columns, at the reference's
  own flights: every lane within 1e-5 of its depth scale in float32 and
  1e-10 in float64 under x64;
- the spherical likelihood-ratio weights carry the shell depths of sigma's
  tangent, bit for bit;
- a dual into any geometry wrapper (K2, K3, K5-K9, the terrain march), into
  the shell depths or into an operand of K1 or K4 that has no rule raises;
- ``scene_state._tensor`` keeps a dual leaf dual and turns numpy leaves into
  the same tensors as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import eradiate_tpu_torch
from eradiate_tpu.ops import spherical as ref_spherical
from eradiate_tpu_torch.kernels import collision_fetch as cf
from eradiate_tpu_torch.kernels import shell_flight as sf
from eradiate_tpu_torch.ops.scene_state import _tensor, from_reference
from eradiate_tpu_torch.ops.spherical import TAU_BLOCKED, shell_depths_plain, slant_tau_exact
from eradiate_tpu_torch.ops.tracer_spherical import lr_weights
from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools
from eradiate_tpu_torch.test_tools.duals import geometry_calls
from eradiate_tpu_torch.test_tools import shells
from eradiate_tpu_torch.test_tools.test_cases import create_rpv_afgl1986_continental_brfpp

torch.set_num_threads(1)


def _tangent(x):
    return fwAD.unpack_dual(x).tangent


def _bits_equal(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _c2_operands(dtype):
    eradiate_tpu_torch.set_mode("mono_double" if dtype == np.float64 else "mono_single")
    try:
        return fetch_tools.experiment_operands(create_rpv_afgl1986_continental_brfpp(n_vza=1),
                                               dtype=dtype)
    finally:
        eradiate_tpu_torch.set_mode("mono_single")


def _c1_operands(dtype):
    eradiate_tpu_torch.set_mode("mono_double" if dtype == np.float64 else "mono_single")
    try:
        return fetch_tools.column_operands(dtype=dtype)
    finally:
        eradiate_tpu_torch.set_mode("mono_single")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("column", ["c1", "c2"])
def test_collision_fetch_rule_equals_forward_ad_through_the_plain_version(column, dtype):
    z_levels, tau_levels, tables = (torch.tensor(a) for a in (
        _c1_operands if column == "c1" else _c2_operands)(dtype))
    q = torch.tensor(fetch_tools.stress_queries(tau_levels.numpy(), 4099, 5))
    rng = np.random.default_rng(6)
    tabs = torch.cat([torch.diff(tau_levels)[None], tables]).contiguous()
    tan = torch.tensor(rng.normal(size=tabs.shape).astype(dtype))
    with fwAD.dual_level():
        got = cf.collision_fetch(q, z_levels, tau_levels, fwAD.make_dual(tabs, tan))
        want = cf.collision_fetch_plain(q, z_levels, tau_levels, fwAD.make_dual(tabs, tan))
        assert torch.equal(got[1], want[1])
        assert _bits_equal(fwAD.unpack_dual(got[0]).primal, fwAD.unpack_dual(want[0]).primal)
        assert _bits_equal(fwAD.unpack_dual(got[2]).primal, fwAD.unpack_dual(want[2]).primal)
        assert _bits_equal(_tangent(got[2]), _tangent(want[2]))
        # z carries no tangent: zero in the rule, none through the plain version
        assert not _tangent(got[0]).any() and _tangent(want[0]) is None


def _slant_case(dtype):
    rng = np.random.default_rng(11)
    radii, sigma = (torch.tensor(np.asarray(a, dtype)) for a in shells.stress_columns(rng)[
        "232 shells"])
    w = torch.tensor(np.asarray([0.3, 0.1, -0.2], dtype))
    w = w / torch.linalg.norm(w)
    p = torch.tensor(np.asarray(shells.stress_points(rng, radii.numpy(), w.numpy(), 3001),
                                dtype))
    return p.contiguous(), w.contiguous(), radii, sigma


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slant_tau_rule_equals_forward_ad_through_the_plain_version(dtype):
    p, w, radii, sigma = _slant_case(dtype)
    sig_t = sigma * torch.tensor(np.random.default_rng(12).uniform(0.5, 1.5, sigma.shape[0])
                                 .astype(dtype))
    with fwAD.dual_level():
        got = sf.slant_tau(p, w, radii, fwAD.make_dual(sigma, sig_t))
        want = slant_tau_exact(p, w, radii, fwAD.make_dual(sigma, sig_t))
        blocked = fwAD.unpack_dual(want).primal == TAU_BLOCKED
        assert blocked.any() and not blocked.all()
        assert _bits_equal(fwAD.unpack_dual(got).primal, fwAD.unpack_dual(want).primal)
        assert _bits_equal(_tangent(got), _tangent(want))
        assert not _tangent(got)[blocked].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lr_weights_carry_the_shell_depths_of_the_tangent(dtype):
    """The spherical likelihood-ratio weights for a dual sigma: primal
    exactly 1, tangents sigma'[layer] / sigma[layer] - depth_col(sigma') and
    -depth_max(sigma') from one ``shell_depths`` call on the tangent, bit for
    bit; none where sigma carries no tangent."""
    radii, sigma = (np.asarray(a, dtype) for a in shells.flight_columns(
        np.random.default_rng(8))["232 shells"])
    p, d, t_max, tau_s = shells.flight_stress_inputs(np.random.default_rng(9), radii, sigma,
                                                     2003, device="cpu", dtype=dtype)
    radii, sigma = torch.tensor(radii), torch.tensor(sigma)
    _, t_col, layer = sf.shell_flight(p, d, t_max, radii, sigma, tau_s)
    sig_t = torch.flip(sigma, [0]).contiguous()
    assert lr_weights(p, d, t_col, t_max, radii, sigma, layer) == (None, None)
    with fwAD.dual_level():
        r_col, r_bnd = lr_weights(p, d, t_col, t_max, radii, fwAD.make_dual(sigma, sig_t), layer)
        dep_col, dep_max = shell_depths_plain(p, d, t_col, layer, t_max, radii, sig_t)
        s_at = sigma[layer.long()]
        want = torch.where(s_at > 1e-30, sig_t[layer.long()] / s_at, 0.0) - dep_col
        for r, t in ((r_col, want), (r_bnd, -dep_max)):
            assert torch.equal(fwAD.unpack_dual(r).primal, torch.ones_like(t_col))
            assert _bits_equal(_tangent(r), t)


def _reference_tangents(p, d, t_max, radii, sigma, sig_t, tau_s):
    """The reference's flight and the tangents of g_col and tau_max_att
    along sigma' (``jax.jvp`` of ``shell_flight_lr``, jitted). The operands
    are the jitted function's arguments, as in a render: closed over as
    constants, XLA would fold x0, b^2 and the shell coordinates at compile
    time, with another rounding than the compiled code's."""

    @jax.jit
    def f(p, d, t_max, radii, sigma, tau_s, sig_t):
        return jax.jvp(lambda s: ref_spherical.shell_flight_lr(p, d, t_max, radii, s, tau_s),
                       (sigma,), (sig_t,))

    (collide, t_col, layer, _, _), (_, _, _, g_t, tmax_t) = f(
        *(jnp.asarray(np.asarray(a)) for a in (p, d, t_max, radii, sigma, tau_s, sig_t)))
    return (np.asarray(collide), np.asarray(t_col), np.asarray(layer), np.asarray(g_t),
            np.asarray(tmax_t))


# the flight's stress columns on which XLA:CPU forms the reference's float32
# shell coordinates X = sqrt(r^2 - b^2) as K2 and the port do, r^2 rounded
# before the difference; on the 1200-shell column (1201 levels) it fuses
# r^2 - b^2 in its 16-wide vector loop and rounds twice only in the tail,
# so that column's float32 coordinates differ from K2's
# (tools/shell_depth_lanes.py; ROADMAP.md, section 3); float64 takes it too
DEPTH_COLUMNS = ("232 shells", "232 shells, vacuum", "229 shells, vacuum runs",
                 "17 shells, vacuum run", "1 shell")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shell_depths_plain_against_the_reference_jvp(dtype):
    """The shell depths of sigma' against ``jax.jvp`` of the reference's
    likelihood-ratio flight (x64 for float64) on K2's stress lanes
    (``shells.flight_stress_inputs``, 2004 lanes) of five of the flight's
    stress columns (float64: all six), at the reference's own flights (its
    t_col and layer):
    g_col' = sigma'[layer] / sigma[layer] - depth_col(sigma') and tau_max' =
    depth_max(sigma').

    Every lane within 1e-5 in float32 and 1e-10 in float64 of its scale:
    for tau_max' the lane's depth of |sigma'| from its tangent point to the
    top, which bounds every prefix it reads; for g_col' that plus
    |sigma'[layer] / sigma[layer]|, the other term of the reference's sum."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        cols = shells.flight_columns(np.random.default_rng(8))
        for name in DEPTH_COLUMNS + (("1200 shells",) if dtype == np.float64 else ()):
            radii, sigma = (np.asarray(a, dtype) for a in cols[name])
            p, d, t_max, tau_s = shells.flight_stress_inputs(np.random.default_rng(9), radii,
                                                             sigma, 2004, dtype=dtype)
            sig_t = (sigma * np.random.default_rng(14).uniform(0.5, 1.5, sigma.shape[0])
                     ).astype(dtype)
            collide, t_col, layer, g_t, tmax_t = _reference_tangents(
                p, d, t_max, radii, sigma, sig_t, tau_s)
            dep_col, dep_max = shell_depths_plain(p, d, torch.tensor(t_col),
                                                  torch.tensor(layer.astype(np.int32)), t_max,
                                                  torch.tensor(radii), torch.tensor(sig_t))
            s_at = sigma[layer]
            ratio = np.where(s_at > 1e-30, sig_t[layer] / np.where(s_at > 0, s_at, 1.0), 0.0)
            p64, d64 = np.asarray(p, np.float64), np.asarray(d, np.float64)
            b2 = (np.cross(p64, d64) ** 2).sum(-1)
            X = np.sqrt(np.maximum(radii.astype(np.float64)[:, None] ** 2 - b2, 0.0))
            scale = np.maximum((np.abs(sig_t)[:, None] * np.diff(X, axis=0)).sum(0), 1e-30)
            dev = np.concatenate([
                np.abs(dep_max.numpy() - tmax_t) / scale,
                (np.abs(ratio - dep_col.numpy() - g_t) / (scale + np.abs(ratio)))[collide]])
            assert collide.mean() > 0.05 and np.isfinite(dev).all(), name
            assert dev.max() <= (1e-10 if dtype == np.float64 else 1e-5), (name, dev.max())
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("name", list(geometry_calls()[1]))
def test_a_dual_into_a_geometry_operand_raises(name):
    p, calls = geometry_calls()
    calls[name](p)  # the primal runs
    with fwAD.dual_level():
        with pytest.raises(NotImplementedError, match="forward-mode"):
            calls[name](fwAD.make_dual(p, torch.ones_like(p)))


def test_a_dual_into_a_rule_free_operand_raises():
    """K1's levels, K4's radii and the shell depths' per-shell operand have
    no rule either (the depths' caller launches them on the tangent)."""
    z_lv, tau_lv = torch.linspace(0.0, 10.0, 3), torch.tensor([0.0, 0.1, 0.2])
    q = torch.tensor([0.05, 0.15])
    radii = torch.tensor([6378.1, 6388.1, 6398.1])
    p = torch.tensor([[0.0, 0.0, 6388.1]])
    with fwAD.dual_level():
        with pytest.raises(NotImplementedError, match="tau_levels"):
            cf.collision_fetch(q, z_lv, fwAD.make_dual(tau_lv, tau_lv), torch.ones(1, 2))
        with pytest.raises(NotImplementedError, match="radii"):
            sf.slant_tau(p, torch.tensor([0.0, 0.0, 1.0]), fwAD.make_dual(radii, radii),
                         torch.tensor([0.01, 0.02]))
        sigma = torch.tensor([0.01, 0.02])
        with pytest.raises(NotImplementedError, match="'v'"):
            sf.shell_depths(p, torch.tensor([[0.0, 0.0, -1.0]]), torch.ones(1),
                            torch.zeros(1, dtype=torch.int32), torch.ones(1), radii,
                            fwAD.make_dual(sigma, sigma))


def _c1_compiled():
    eradiate_tpu_torch.set_mode("mono_single")
    exp = eradiate_tpu_torch.AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [0.0, 30.0]},
        surface={"type": "lambertian", "reflectance": 0.5}, atmosphere={"type": "molecular"})
    m = exp.measures[0]
    return exp.compile_scene(m, exp.spectral_context(m))


def test_tensor_keeps_a_dual_and_numpy_leaves_as_before():
    x = np.linspace(0.0, 1.0, 7).astype(np.float64)
    assert torch.equal(_tensor(x, "cpu", np.float32), torch.tensor(x.astype(np.float32)))
    assert _tensor(x, "cpu", np.float64).dtype == torch.float64
    assert _tensor(np.arange(3), "cpu").dtype == torch.int64
    assert _tensor(None, "cpu") is None and _tensor("rayleigh", "cpu") == "rayleigh"
    scene, sensor, config = _c1_compiled()
    before = from_reference(scene, sensor, config, "cpu")[0]
    with fwAD.dual_level():
        t = _tensor(fwAD.make_dual(torch.tensor(x), torch.ones(7, dtype=torch.float64)), "cpu",
                    np.float32)
        assert t.dtype == torch.float32 and torch.equal(_tangent(t), torch.ones(7))
        import dataclasses

        albedo = torch.as_tensor(scene.medium.albedo)
        dual = dataclasses.replace(scene, medium=dataclasses.replace(
            scene.medium, albedo=fwAD.make_dual(albedo, torch.ones_like(albedo))))
        after = from_reference(dual, sensor, config, "cpu")[0]
        assert torch.equal(_tangent(after.medium.albedo), torch.ones_like(albedo))
        assert torch.equal(fwAD.unpack_dual(after.medium.albedo).primal, before.medium.albedo)
    assert torch.equal(after.medium.tau_levels, before.medium.tau_levels)
    for k, v in before.surface.params.items():
        assert torch.equal(after.surface.params[k], v)

