"""The slant-depth sum in the CUDA kernel's order against the plain twin.

``eradiate_tpu_torch.test_tools.shells.slant_tau_shared`` emulates the
kernels' ``slant_tau`` (``csrc/shell_flight.cu``): it starts each lane at the
first shell its path crosses, loops a warp of 32 lanes from the least start
of its lanes, takes one root a shell and carries it to the next shell,
reuses a root only where the endpoint compares equal to the radius it was
taken of, and forms one up segment a shell with the down one as an exact
doubling below the point's shell. Tolerances:

- the emulation against ``slant_tau_exact``: bit for bit, on every lane,
  in float32 and in float64 (the float64 builds' ``slant_tau64`` takes the
  same order, its roots exact);
- every per-shell term of the twin below the first crossed shell: exactly
  +0 (the bits of 0.0, in float32 and in float64), so that skipping it
  leaves the float64 sum as it is;
- ``slant_tau_exact`` against the reference's ``_slant_tau_exact_xla`` under
  ``jit``: the tolerance of ``tests/test_torch_spherical.py``
  (``test_slant_tau_exact``): the blocked lanes exactly, elsewhere 8 ulp (the
  reference sums the shells in float32, the port in float64 in level order).

The stresses are points on shell radii, tangent radii on shell radii and at
the ground (and one ulp either side of it), ``b`` above ``r`` by rounding,
``p.w = +-0``, points above the top radius, vacuum shells and a column of
1200 shells, toward a direction along an axis (where these come out exact)
and toward a sun at 85 degrees, made in float32 and in float64 (each ulp
then a float64 one), and in float64 a planet of 1e6 km. A twin that reuses
a root across a one-ulp difference of the endpoint is caught in both
dtypes. Two shapes reach XLA (232 and 1200 shells), each compiled once.

In float64 (the double modes; what the float64 build equals on the card)
the twin is held against ``_slant_tau_exact_xla`` under x64 on the same
stresses and on a planet of 1e6 km (``test_tools.shells.planet_inputs``):
the blocked lanes exactly; elsewhere the median lane within 8 ulps and
every lane within 4e-6 relative (2e-5 on the planet). Near a tangent the
reference forms the radicand ``r^2 - b^2`` with a float64 fused
multiply-add where the twin rounds the product first, and the cancellation
turns that last ulp into a part in a million of the depth.
"""

import jax
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import spherical as ref
from eradiate_tpu_torch.ops import spherical
from eradiate_tpu_torch.test_tools import shells

torch.set_num_threads(1)

N = 1500
COLUMNS = shells.stress_columns(np.random.default_rng(8))
SUN_85 = np.array([np.sin(np.deg2rad(85.0)), 0.0, np.cos(np.deg2rad(85.0))], np.float32)
DIRECTIONS = {"axis": shells.AXIS_W, "sun at 85 deg": SUN_85}
CASES = [(c, d) for c in COLUMNS for d in DIRECTIONS]
#: The float64 cases (the double modes' builds): the stresses made in
#: float64 (each ulp a float64 one), and a planet of 1e6 km toward the SZA 85
#: sun (float64 only).
PLANET = "planet of 1e6 km"
CASES_F64 = [(c, d, "float64") for c, d in CASES] + [(PLANET, "sun at 85 deg", "float64")]


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _case(column, direction, dtype="float32"):
    """``(p, w, radii, sigma)`` numpy arrays of ``dtype``."""
    w = DIRECTIONS[direction]
    if column == PLANET:
        p, _, _, _, radii, sigma = shells.planet_inputs(np.random.default_rng(6), 3000)
        return p.numpy(), w.astype(np.float64), radii.numpy(), sigma.numpy()
    radii, sigma = COLUMNS[column]
    p = shells.stress_points(np.random.default_rng(len(column) + len(direction)), radii, w, N,
                             dtype=dtype)
    return tuple(a.astype(dtype) for a in (p, w, radii, sigma))


@pytest.fixture(params=CASES, ids=[f"{c}, {d}" for c, d in CASES], scope="module")
def case(request):
    return _case(*request.param)


@pytest.fixture(params=CASES + CASES_F64, ids=[", ".join(c) for c in CASES + CASES_F64],
                scope="module")
def any_case(request):
    """A float32 case of ``case`` or a float64 one."""
    return _case(*request.param)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_stresses_reach_the_hard_cases():
    """The generator makes what the module docstring says, with the axis."""
    p, w, radii, _ = (torch.as_tensor(a) for a in _case("232 shells", "axis"))
    r, descending, _, b = shells._geometry(p, w)
    x0 = spherical.dot3(p, w)
    _, _, blocked = shells.first_shells(p, w, radii)
    on_radius = torch.isin(r, radii)
    assert on_radius.sum() >= N // 10
    assert (torch.isin(b, radii[1:]) & descending & ~blocked).any()
    assert ((b == radii[0]) & descending & ~blocked).any()  # tangent at the ground
    assert ((b == torch.nextafter(radii[0], torch.tensor(0.0))) & descending & blocked).any()
    assert ((b > r) & descending).any() and ((b > r) & ~descending).any()
    assert ((x0 == 0) & torch.signbit(x0)).any() and ((x0 == 0) & ~torch.signbit(x0)).any()
    assert (r > radii[-1]).sum() >= N // 10
    assert ((r > radii[-1]) & descending & ~blocked).any()


def test_shared_sum_equals_the_twin_bitwise(any_case):
    p, w, radii, sigma = _torch(*any_case)
    want = spherical.slant_tau_exact(p, w, radii, sigma)
    got = shells.slant_tau_shared(p, w, radii, sigma)
    assert got.dtype == want.dtype == p.dtype
    differ = _bits(got) != _bits(want)
    assert not differ.any(), f"{int(differ.sum())} of {len(p)} lanes differ"
    assert (want == spherical.TAU_BLOCKED).any()
    assert (want == 0).any() or len(p) != N  # the planet has no point above its top


def test_terms_below_the_first_crossed_shell_are_zero(any_case):
    p, w, radii, sigma = _torch(*any_case)
    L = sigma.shape[0]
    r, descending, b2, b = shells._geometry(p, w)
    D = spherical._shell_paths(b2, b, r, radii[:-1, None], radii[1:, None], descending)
    terms = D * sigma[:, None]  # [L, B], the twin's
    l0, _, blocked = shells.first_shells(p, w, radii)
    below = (torch.arange(L)[:, None] < l0[None, :]) & ~blocked[None, :]
    assert below.any()
    assert torch.all(_bits(D)[below] == 0) and torch.all(_bits(terms)[below] == 0)
    # the distinct segments: every nonzero up segment, and the nonzero down
    # segment of a descending lane's point shell (below it, down = up)
    lo, hi = radii[:-1, None], radii[1:, None]
    c = torch.where(descending, b, torch.maximum(r, b))
    up = spherical._seg(b2, torch.minimum(torch.maximum(lo, c), hi), hi)
    des_hi = torch.minimum(hi, r)
    down = spherical._seg(b2, torch.minimum(torch.maximum(lo, b), des_hi), des_hi)
    partial = descending & (down > 0) & (hi > r)
    want = torch.where(blocked, 0, (up > 0).sum(0) + partial.sum(0))
    assert torch.equal(shells.crossed_segments(p, w, radii), want)


def test_twin_matches_the_reference_on_the_stresses(case):
    p, w, radii, sigma = case
    want = np.asarray(jax.jit(ref._slant_tau_exact_xla)(p, w, radii, sigma))
    got = spherical.slant_tau_exact(*_torch(p, w, radii, sigma)).numpy()
    blocked = want == ref.TAU_BLOCKED
    np.testing.assert_array_equal(got == spherical.TAU_BLOCKED, blocked)
    ia = got[~blocked].view(np.int32).astype(np.int64)
    ib = want[~blocked].view(np.int32).astype(np.int64)
    assert np.abs(ia - ib).max() <= 8


@pytest.mark.parametrize("column", [*COLUMNS, *(f"{c}, float64" for c in COLUMNS)])
def test_root_reuse_across_one_ulp_is_caught(column):
    """A mutated emulation that takes the root at a radius for an endpoint
    within one ulp of it differs from the twin: the stresses see the rule,
    in float32 and in float64."""
    name, _, dtype = column.partition(", float64")
    p, w, radii, sigma = _torch(*_case(name, "axis", "float64" if column != name else "float32"))
    want = spherical.slant_tau_exact(p, w, radii, sigma)

    def within_an_ulp(x, y):
        return (x - y).abs() <= torch.nextafter(y, torch.tensor(np.inf)) - y

    mutated = shells.slant_tau_shared(p, w, radii, sigma, same=within_an_ulp)
    assert (_bits(mutated) != _bits(want)).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_warp_start_is_the_least_first_shell_of_its_looping_lanes(dtype):
    l0 = torch.tensor([5, 3, 9, 7, 2, 8])
    loops = torch.tensor([True, True, False, True, False, True])
    start = shells.loop_starts(l0, loops, L=10, warp=2)
    assert start.tolist() == [3, 3, 7, 7, 8, 8]
    assert shells.loop_starts(l0, torch.zeros(6, dtype=torch.bool), 10, 2).tolist() == [10] * 6
    # on the stresses of this dtype: each warp of 32 lanes from the least l0
    # of its looping lanes
    p, w, radii, _ = _torch(*_case("232 shells", "sun at 85 deg", dtype))
    l0, _, blocked = shells.first_shells(p, w, radii)
    L = radii.shape[0] - 1
    loops = ~blocked & (l0 < L)
    start = shells.loop_starts(l0, loops, L)
    for i in range(0, len(p), shells.WARP):
        mine = l0[i:i + shells.WARP][loops[i:i + shells.WARP]]
        assert (start[i:i + shells.WARP] == (mine.min() if len(mine) else L)).all()
    assert (start[loops] <= l0[loops]).all() and (start[loops] < l0[loops]).any()


def _x64_slant(p, w, radii, sigma):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        out = jax.jit(ref._slant_tau_exact_xla)(*(a.numpy() for a in (p, w, radii, sigma)))
        return torch.from_numpy(np.array(out))
    finally:
        jax.config.update("jax_enable_x64", old)


def _ulps64(a, b):
    ia, ib = (torch.where(x.view(torch.int64) < 0, -(2**63) - x.view(torch.int64),
                          x.view(torch.int64)) for x in (a, b))
    return (ia - ib).abs()


def _float64_gate(p, w, radii, sigma, rel_max, median_ulps):
    want = spherical.slant_tau_exact(p, w, radii, sigma)
    got = _x64_slant(p, w, radii, sigma)
    assert want.dtype == got.dtype == torch.float64
    blocked = want >= 1e9
    assert torch.equal(blocked, got >= 1e9) and blocked.any() and not blocked.all()
    assert torch.equal(want[blocked], got[blocked])
    rel = (want - got).abs() / got.abs().clamp(min=1e-300)
    assert float(rel.max()) <= rel_max, float(rel.max())
    assert float(_ulps64(want, got)[~blocked].double().median()) <= median_ulps


def test_float64_twin_matches_the_reference_on_the_stresses(case):
    _float64_gate(*(torch.as_tensor(a).double() for a in case), 4e-6, 8)


def test_float64_twin_matches_the_reference_on_a_planet_of_1e6_km():
    p, _, _, _, radii, sigma = shells.planet_inputs(np.random.default_rng(6), 3000)
    w = torch.tensor(SUN_85).double()
    _float64_gate(p, w, radii, sigma, 2e-5, 8)
