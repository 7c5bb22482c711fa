"""The shell free flight in the CUDA kernel's order against the plain twin.

``eradiate_tpu_torch.test_tools.shells.shell_flight_checkpointed`` emulates
the kernels' ``shell_flight_lane`` (``csrc/shell_flight.cu``): one sweep from
level 0 to the bracket of the larger of ``|x0|`` and ``|x_max|`` that keeps
a float64 checkpoint every S levels, then the inversion of G at ``v``
resumed from the sweep's stop or from the last checkpoint with ``G <= v``
(the kernel's binary search), and a walk forward. Tolerances:

- the emulation against ``shell_flight_plain``: bit for bit (collide, t_col
  and layer), on every lane, at every stride S (1, 7, 8, L, L + 1 and the
  kernels' default ceil(L / 16), ceil(L / 8) in the float64 builds);
- the walk after a resume from a checkpoint: at most S levels; a lane's
  levels in all: at most L + S;
- ``flight_levels`` (the bound's count): equal to the count read off the
  twin's own brackets, exactly;
- the twin against the JAX package's ``_shell_flight_xla`` under
  ``jax.jit`` (whose prefix G is a hi/lo bfloat16 matrix product, ~2^-17 of
  the column depth from the exact sum): ``collide`` and ``layer`` equal
  except on near-tie lanes, whose ``tau_s`` lies within 2^-14 of the
  column depth of the twin's ``tau_max`` or whose ``v`` lies that close to
  a level's G (the twin's own float32 values: the stresses put lanes on
  ties of float32 quantities, where float64 geometry would miss them); a
  tie may go either way, and on descent to either leg. Away from ties,
  ``t_col`` within 2e-3 km plus 2^-14 of the column depth over the
  extinction of the event's shell (the prefix error moves the event by
  that much along the ray).

The float64 twin (what the double modes' float64 builds of K2 and K3 equal
on the card: its prefix is the reference's bfloat16-halves matrix product,
summed in float64) is held against ``_shell_flight_xla`` under x64 on the
stresses taken into float64 and on a planet of 1e6 km
(``test_tools.shells.planet_inputs``): ``collide`` and ``layer`` equal on
every lane, ``t_col`` within 1e-8 of the flight cap (at least 1 km): XLA
fuses the radicands ``r^2 - b^2`` and the dot products into float64
multiply-adds where the twin rounds twice, which moves a collision by a few
parts in a billion of the cap at most.

The stresses (``test_tools.shells.flight_stress_inputs``) put ``v`` on a
level's G inside runs of vacuum shells that span a checkpoint, ``tau_s`` at 0
and one ulp either side of ``tau_max``, ``t_max = 0``, ``x0 = +-0``, ``b2``
at ``fl(r_k^2)`` and one ulp either side, grazing lanes in the top shell and
random lanes, a third of them cut short, on six columns (232 shells, the
same with vacuum shells, 1200 shells, 229 with vacuum runs, the lowest 17
of those with one vacuum run, one shell). An emulation that resumes one
level above the checkpoint it found is caught.

The float64 builds (``shell_flight_lane64``) take the same order; their
emulation keeps at each checkpoint the two float64 running sums of the
bfloat16 halves (the reference's x64 prefix). On the same stresses made in
float64 (each tie and ulp a float64 one) and on a planet of 1e6 km: bit for
bit with the float64 twin at every stride, the walk bounded by the stride,
the resume one level too high caught, and the float64 G nondecreasing on
every lane (the binary search of the checkpoints relies on it). The
wrappers' float64 shared-memory mirror and shell caps are held exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from eradiate_tpu.ops import spherical as ref_spherical
from eradiate_tpu_torch.kernels.shell_flight import flight_stride
from eradiate_tpu_torch.ops import spherical
from eradiate_tpu_torch.test_tools import shells

torch.set_num_threads(1)

N = 1200
COLUMNS = shells.flight_columns(np.random.default_rng(8))
#: Float64 lanes (the double modes' builds): each column's stresses made in
#: float64 (ties and ulps of float64), and a planet of 1e6 km (float64 only:
#: float32 tells none of its shells apart).
PLANET = "planet of 1e6 km"
F64 = ", float64"
CASES = [*COLUMNS, *(c + F64 for c in COLUMNS), PLANET]


def _bits(x):
    return x.view({torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]) \
        if x.is_floating_point() else x


def _strides(L, dtype=torch.float32):
    """The strides by name; "default" is the kernels' in the build of
    ``dtype``."""
    return {"1": 1, "7": 7, "8": 8, "L": L, "L + 1": L + 1, "default": flight_stride(L, dtype)}


@functools.lru_cache(maxsize=None)
def _column(name):
    """(name, radii, sigma, lanes (p, d, t_max, tau_s), the twin's outputs),
    float32, or float64 for the names of ``CASES`` beyond ``COLUMNS``."""
    if name == PLANET:
        p, d, t_max, tau_s, radii, sigma = shells.planet_inputs(np.random.default_rng(6), 2000)
        lanes = (p, d, t_max, tau_s)
    else:
        dtype = np.float64 if name.endswith(F64) else np.float32
        radii, sigma = (a.astype(dtype) for a in COLUMNS[name.removesuffix(F64)])
        lanes = shells.flight_stress_inputs(np.random.default_rng(5), radii, sigma, N,
                                            dtype=dtype)
        radii, sigma = torch.tensor(radii), torch.tensor(sigma)
    want = spherical.shell_flight_plain(*lanes[:3], radii, sigma, lanes[3])
    return name, radii, sigma, lanes, want


@pytest.fixture(params=list(COLUMNS))
def column(request):
    return _column(request.param)


@pytest.fixture(params=CASES)
def any_column(request):
    """A float32 column of ``column`` or a float64 case."""
    return _column(request.param)


@functools.lru_cache(maxsize=None)
def _emulated(name, stride, overshoot=0):
    _, radii, sigma, (p, d, t_max, tau_s), _ = _column(name)
    return shells.shell_flight_checkpointed(p, d, t_max, radii, sigma, tau_s, stride, overshoot)


def _emulate(column, stride, overshoot=0):
    return _emulated(column[0], stride, overshoot)


@pytest.mark.parametrize("stride", ["1", "7", "8", "L", "L + 1", "default"])
def test_checkpointed_flight_equals_the_twin_bitwise(any_column, stride):
    L = any_column[2].shape[0]
    got = _emulate(any_column, _strides(L, any_column[2].dtype)[stride])
    n = any_column[3][0].shape[0]
    for label, g, w in zip(("collide", "t_col", "layer"), got[:3], any_column[4]):
        assert g.dtype == w.dtype
        differ = _bits(g) != _bits(w)
        assert not differ.any(), f"{label}: {int(differ.sum())} of {n} lanes differ"


@pytest.mark.parametrize("name", CASES[len(COLUMNS):])
def test_float64_prefix_is_nondecreasing(name):
    """The float64 G (the reference's prefix: two float64 running sums of
    the bfloat16 halves, added at each level) never falls from one level to
    the next on any lane: the kernels' binary search of the checkpoints and
    the twin's ``bracket(G, v)`` both rely on it."""
    _, radii, sigma, (p, d, _, _), _ = _column(name)
    b2 = spherical.cross_norm2(p, d)
    X = spherical.sqrt_rn(torch.clamp((radii * radii)[:, None] - b2, min=0.0))
    G = spherical._prefix_levels(sigma[:, None] * (X[1:] - X[:-1]))  # [L+1, B]
    assert G.dtype == torch.float64 and G.shape == (sigma.shape[0] + 1, p.shape[0])
    assert (G[-1] > 0).any()
    assert (G[1:] >= G[:-1]).all()


@pytest.fixture(params=CASES[:-1])
def stress_column(request):
    """A column's stresses, float32 or made in float64."""
    return _column(request.param)


def test_stresses_reach_the_hard_cases(stress_column):
    """The generator makes what the module docstring says, in float32 and,
    with float64 ties and ulps, in float64."""
    column = stress_column
    name, radii, sigma, (p, d, t_max, tau_s), want = column
    L = sigma.shape[0]
    x0 = spherical.dot3(p, d)
    b2 = spherical.cross_norm2(p, d)
    r2 = radii * radii
    _, _, _, trace = _emulate(column, flight_stride(L, p.dtype))
    assert ((x0 == 0) & ~torch.signbit(x0)).any() and ((x0 == 0) & torch.signbit(x0)).any()
    assert (t_max == 0).sum() >= N // 20 and (tau_s == 0).any()
    inf = torch.tensor(np.inf, dtype=p.dtype)
    for r2_near in (r2, torch.nextafter(r2, inf), torch.nextafter(r2, -inf)):
        assert torch.isin(b2, r2_near).sum() >= N // 40
    assert ((b2 > r2[-2]) & (b2 < r2[-1])).sum() >= N // 20  # tangent in the top shell
    # tau_s one ulp either side of tau_max: both decisions taken
    tm = trace["tau_max"]
    above, below = tau_s == torch.nextafter(tm, inf), tau_s == torch.nextafter(tm, -inf)
    assert (above & ~want[0]).any() and (below & (tm > 0)).any() and want[0][below & (tm > 0)].all()
    # v on a level's G, on the ascending and on the descending side
    G = shells._prefix_table(b2, radii, sigma)
    on_level = (G == trace["v"][None]).any(0)
    assert (on_level & (x0 == 0)).sum() >= N // 20 and (on_level & (x0 < 0)).sum() >= N // 40
    if (sigma == 0).any():
        # flat runs of G spanning a checkpoint, v on them: the inversion ties
        # to the last equal level, past the checkpoint inside the run. The
        # 17-shell column's run ends at level 9, a checkpoint of the float64
        # builds' stride there (3): stride 7 puts one inside it
        S = 7 if (L, p.dtype) == (17, torch.float64) else flight_stride(L, p.dtype)
        if S != flight_stride(L, p.dtype):
            _, _, _, trace = _emulate(column, S)
        kv = want[2].long()
        flat_below = (kv > 0) & (sigma[torch.clamp(kv - 1, min=0)] == 0)
        crosses = (trace["resume"] < kv) & (trace["resume"] % S == 0) & ~trace["at_end"]
        assert (on_level & flat_below & crosses).any()


#: Where a resume one level too high can give another answer: not with one
#: shell, and not where each checkpoint level's G equals the next level's:
#: at the float32 kernels' stride (15) of the column with every third shell
#: vacuum (the float64 builds' stride there, 29, is not a multiple of 3),
#: and at stride 8 of the 17-shell column (its checkpoint 8 inside the
#: vacuum run), in float32 and in float64.
UNMUTABLE = {("232 shells, vacuum", "default"), ("17 shells, vacuum run", "8"),
             ("17 shells, vacuum run" + F64, "8")}
MUTABLE = [(c, s) for c in CASES if c.removesuffix(F64) != "1 shell"
           for s in ("1", "7", "8", "default") if (c, s) not in UNMUTABLE]


@pytest.mark.parametrize("name, stride", MUTABLE, ids=[f"{c}-{s}" for c, s in MUTABLE])
def test_resume_one_level_too_high_is_caught(name, stride):
    """A mutated emulation that resumes one level above the checkpoint it
    found (with that level's exact prefix) differs from the twin: the
    stresses put v where the found checkpoint's level is the answer."""
    column = _column(name)
    L = column[2].shape[0]
    got = _emulate(column, _strides(L, column[2].dtype)[stride], overshoot=1)
    assert (got[2] != column[4][2]).any()


def test_walk_is_bounded_by_the_stride(any_column):
    """After a resume from a checkpoint (inside the sweep's range) the walk
    reads at most S levels; a lane's two loops read at most L + S levels."""
    L = any_column[2].shape[0]
    for stride in sorted(set(_strides(L, any_column[2].dtype).values())):
        _, _, _, trace = _emulate(any_column, stride)
        inside = ~trace["at_end"]
        assert (trace["walk"][inside] <= stride).all(), stride
        assert (trace["sweep"] + trace["walk"]).max() <= L + stride
        assert (trace["kv"][inside] <= trace["end"][inside]).all()


def test_flight_levels_equal_the_twins_brackets(column):
    """``flight_levels``: from the lane's tangent level (the last with X = 0)
    to the highest of the twin's brackets of |x0|, |x_max| and v."""
    _, radii, sigma, (p, d, t_max, tau_s), want = column
    L = sigma.shape[0]
    x0 = spherical.dot3(p, d)
    b2 = spherical.cross_norm2(p, d)
    X = spherical.sqrt_rn(torch.clamp((radii * radii)[:, None] - b2, min=0.0))
    _, _, _, trace = _emulate(column, flight_stride(L))

    def bracket(table, y):
        return torch.clamp((table <= y).sum(0) - 1, 0, L - 1)

    ka, km = bracket(X, torch.abs(x0)), bracket(X, torch.abs(x0 + t_max))
    kv = want[2].long()
    assert torch.equal(trace["ka"], ka) and torch.equal(trace["km"], km)
    tangent = torch.clamp((X[:L] == 0).sum(0) - 1, min=0)
    top = torch.maximum(torch.maximum(ka, km), kv)
    assert torch.equal(shells.flight_levels(trace), top - tangent + 1)
    assert (shells.flight_levels(trace) >= 1).all()


def test_parent_visits_are_the_two_sweeps():
    """The two sweeps before this design: from level 0 to the level above the
    larger bracket of |x0| and |x_max|, and to the level above kv, each
    capped at L passes."""
    trace = {"ka": torch.tensor([0, 5, 9, 9]), "km": torch.tensor([3, 2, 9, 0]),
             "kv": torch.tensor([0, 4, 9, 7])}
    assert shells.parent_visits(trace, L=10).tolist() == [5 + 2, 7 + 6, 10 + 10, 10 + 9]
    assert shells.warp_max(torch.arange(70), warp=32).tolist() == [31, 63, 69]


#: The near-tie width and the reference's prefix error, relative to the
#: column depth (as ``tests/test_torch_spherical.py`` finds near ties).
REL = 2.0**-14


def test_twin_matches_the_reference_on_the_stresses(column):
    """The plain twin (which the kernels equal bit for bit) against the JAX
    package's ``_shell_flight_xla`` under ``jax.jit``, on the flight's
    stresses; tolerances in the module docstring."""
    _, radii, sigma, (p, d, t_max, tau_s), want = column
    ref = [torch.from_numpy(np.array(o)) for o in jax.jit(ref_spherical._shell_flight_xla)(
        *(a.numpy() for a in (p, d, t_max, radii, sigma, tau_s)))]
    _, _, _, trace = _emulate(column, 1)
    G = shells._prefix_table(spherical.cross_norm2(p, d), radii, sigma).double()
    eps = REL * G[-1]
    ties = ((tau_s.double() - trace["tau_max"].double()).abs() <= eps) | (
        (G - trace["v"].double()[None]).abs().amin(0) <= eps)
    differ = (want[0] != ref[0]) | ((want[2] != ref[2]) & ref[0])
    assert not (differ & ~ties).any(), f"{int((differ & ~ties).sum())} lanes differ off a tie"
    agree = ~differ & ~ties & ref[0]
    assert agree.sum() >= N // 20
    err = (want[1].double() - ref[1].double()).abs()
    tol = 2e-3 + eps / torch.clamp(sigma[want[2].long()].double(), min=1e-30)
    assert (err <= tol)[agree].all(), f"t_col off by {float((err / tol)[agree].max()):.3g} x tol"


@pytest.mark.parametrize("name", [*COLUMNS, "planet of 1e6 km"])
def test_float64_twin_matches_the_reference_under_x64(name):
    if name in COLUMNS:
        _, radii, sigma, lanes, _ = _column(name)
        p, d, t_max, tau_s = (x.double() for x in lanes)
        radii, sigma = radii.double(), sigma.double()
    else:
        p, d, t_max, tau_s, radii, sigma = shells.planet_inputs(np.random.default_rng(6), 3000)
    want = spherical.shell_flight_plain(p, d, t_max, radii, sigma, tau_s)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        ref = [torch.from_numpy(np.array(o)) for o in jax.jit(ref_spherical._shell_flight_xla)(
            *(a.numpy() for a in (p, d, t_max, radii, sigma, tau_s)))]
    finally:
        jax.config.update("jax_enable_x64", old)
    assert want[1].dtype == ref[1].dtype == torch.float64
    assert torch.equal(want[0], ref[0]) and torch.equal(want[2], ref[2])
    err = (want[1] - ref[1]).abs() / torch.clamp(t_max, min=1.0)
    assert float(err.max()) <= 1e-8, float(err.max())


def _operands(kernel, dtype, L, n=16):
    """Operands of ``kernel`` for ``_check``: ``(lanes, radii, sigma, w)``."""
    lanes = {"p": torch.zeros(n, 3, dtype=dtype), "d": torch.zeros(n, 3, dtype=dtype),
             "t_max": torch.zeros(n, dtype=dtype), "tau_s": torch.zeros(n, dtype=dtype)}
    if kernel == "slant_tau":
        lanes = {"p": lanes["p"]}
    radii = torch.linspace(6378.0, 6398.0, L + 1, dtype=dtype)
    return lanes, radii, torch.zeros(L, dtype=dtype), torch.zeros(3, dtype=dtype)


KERNELS = ["shell_flight", "shell_event", "slant_tau"]


@pytest.mark.parametrize("case_", ["float16", "mixed"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_reject_float16_and_mixed_dtypes(kernel, case_):
    """The shell wrappers take all float32 or all float64 and refuse the
    rest; in either dtype they refuse a column taller than a block's shared
    memory holds (30000 shells)."""
    from eradiate_tpu_torch.kernels import shell_flight as sf

    def check(lanes, radii, sigma, w):
        return sf._check(kernel, lanes, radii, sigma, None if kernel == "shell_flight" else w)

    assert check(*_operands(kernel, torch.float64, 1200)) == (16, 1200)
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError):  # the kernels' shared memory
            check(*_operands(kernel, dtype, 30000))
    lanes, radii, sigma, w = _operands(
        kernel, torch.float16 if case_ == "float16" else torch.float64, 8)
    if case_ == "mixed":
        sigma = sigma.float()
    with pytest.raises(TypeError):
        check(lanes, radii, sigma, w)


#: The float64 builds' shell caps: 32 KiB of checkpoint columns (8 a thread
#: of 256, two float64 sums each) and 16 bytes a level for the flight, 24
#: bytes a shell for the slant tables, in 227 KiB.
CAPS_F64 = {"shell_flight": 12479, "shell_event": 4991, "slant_tau": 9684}


@pytest.mark.parametrize("kernel", KERNELS)
def test_float64_shared_memory_mirror(kernel):
    """The float64 builds stage the shells in shared memory (they took none
    before): the wrapper's mirror of the source's layout, at L = 232 and at
    every L up to the cap, which holds."""
    from eradiate_tpu_torch.kernels import shell_flight as sf

    flight = (8 * sf.THREADS + 233) * 16  # checkpoints of two float64 sums, (r^2, sigma)
    slant = (3 * 232 + 2) * 8  # r^2, r and sigma in float64
    want = {"shell_flight": flight, "shell_event": flight + slant, "slant_tau": slant}[kernel]
    assert sf._smem_bytes(kernel, 232, torch.float64) == want > 0
    cap = sf.shell_cap(kernel, torch.float64)
    assert cap == CAPS_F64[kernel]
    sizes = [sf._smem_bytes(kernel, L, torch.float64) for L in range(1, cap + 2)]
    assert max(sizes[:-1]) <= sf.SMEM_BYTES < sizes[-1]


@pytest.mark.parametrize("kernel", KERNELS)
def test_float64_column_above_the_cap_is_refused(kernel, monkeypatch):
    """On CPU tensors, before any library is built: a float64 column one
    shell above the cap is refused with a message naming the cap; the cap
    itself is taken."""
    from eradiate_tpu_torch.kernels import _build
    from eradiate_tpu_torch.kernels import shell_flight as sf

    def no_build():
        raise AssertionError("a library was built")

    monkeypatch.setattr(_build, "library", no_build)
    cap = CAPS_F64[kernel]
    lanes, radii, sigma, w = _operands(kernel, torch.float64, cap)
    assert sf._check(kernel, lanes, radii, sigma, w) == (16, cap)
    lanes, radii, sigma, w = _operands(kernel, torch.float64, cap + 1)
    with pytest.raises(ValueError, match=f"at most {sf.SMEM_BYTES}, {cap} shells"):
        sf._check(kernel, lanes, radii, sigma, w)


def test_every_float64_column_the_tests_use_is_accepted():
    """The columns the tests and the card's checks run in float64 (the
    flight's and the slant's stress columns, the planet of 1e6 km, c4's
    merged and unmerged columns: at most 1200 shells) fit every float64
    build."""
    from eradiate_tpu_torch.kernels import shell_flight as sf

    counts = {len(sigma) for _, sigma in COLUMNS.values()}
    counts |= {len(sigma) for _, sigma in shells.stress_columns(np.random.default_rng(8)).values()}
    counts |= {_column(PLANET)[2].shape[0], 232, 1200}
    assert max(counts) == 1200
    for L in sorted(counts):
        for kernel in KERNELS:
            lanes, radii, sigma, w = _operands(kernel, torch.float64, L)
            assert sf._check(kernel, lanes, radii, sigma, w) == (16, L)
