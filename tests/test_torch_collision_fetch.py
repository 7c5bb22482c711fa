"""The collision fetch's plain twin against the JAX package, and its wrapper.

On the CPU the twin is what runs; it must equal ``medium.collision_fetch``
(gather path): layer and fetched values exactly, z within 1e-6 relative. It
is also held against the Pallas kernel in interpret mode, within the bounds
of that kernel's hi/lo-bf16 fetch (as ``tests/unit/test_pallas_kernels.py``
holds it). The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
and ``tests/test_torch_cuda_kernels.py`` compare it with the twin bit for
bit. Its search, a fixed number of branch-free trips down the levels staged
as a breadth-first tree, is emulated by ``test_tools.collision_fetch`` and
held here to ``torch.searchsorted(right=True)``, on NaN and +-inf too.

The float64 twin (what the double modes' float64 build equals on the card)
is held against ``medium.collision_fetch`` under x64 on float64 queries:
NaN, +-inf, -0.0, every level and one ulp either side, random ones. The
layer and the fetched values exactly, z to the last bit but where XLA
flushes a subnormal. The wrapper refuses float16 and mixed dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eradiate_tpu.ops.medium import collision_fetch as ref_collision_fetch
from eradiate_tpu.ops.pallas.collision_fetch import collision_fetch_pallas
from eradiate_tpu_torch.kernels import collision_fetch as cf
from eradiate_tpu_torch.ops import medium
from eradiate_tpu_torch.test_tools import collision_fetch as fetch_tools

torch.set_num_threads(1)


def _afgl_table():
    """The c1 column before layer merging: AFGL Rayleigh at 550 nm on 1200
    layers of 0.1 km, with c1's per-layer tables (albedo, phase weight,
    depolarisation)."""
    from eradiate_tpu.scenes.atmosphere import atmosphere_factory
    from eradiate_tpu.scenes.geometry import PlaneParallelGeometry

    atm = atmosphere_factory.convert({"type": "molecular"})
    zgrid = PlaneParallelGeometry().zgrid
    w = np.array([550.0])
    sigma = atm.eval_sigma_t(w, None, zgrid)[0]
    albedo = atm.eval_albedo(w, None, zgrid)[0]
    _, params, weights = atm.eval_phase(w, zgrid)
    levels = zgrid.levels
    tau = np.concatenate([[0.0], np.cumsum(sigma * np.diff(levels))])
    tables = np.stack([albedo, weights[0, 0], params[0]["depol"][0]])
    return levels, tau, tables


def _flat_table():
    """Seven layers with runs of zero extinction (equal levels)."""
    levels = np.array([0.0, 1.0, 2.0, 3.5, 4.0, 6.0, 8.0, 12.0])
    sigma = np.array([0.1, 0.0, 0.0, 0.3, 0.2, 0.0, 0.5])
    tau = np.concatenate([[0.0], np.cumsum(sigma * np.diff(levels))])
    rng = np.random.default_rng(3)
    tables = rng.uniform(0.0, 1.0, (3, 7))
    return levels, tau, tables


def _queries(tau, seed, n=3000):
    """Random tau in [0, tau_top] plus edges: 0, tau_top, every level
    exactly, neighbours one ulp either side, and values past the top."""
    tau = tau.astype(np.float32)
    top = tau[-1]
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.0, top, n).astype(np.float32)
    edges = np.concatenate(
        [
            [0.0, top, 1.5 * top],
            tau,
            np.nextafter(tau, np.float32(np.inf)),
            np.nextafter(tau[1:], np.float32(0.0)),
        ]
    ).astype(np.float32)
    return np.concatenate([q, edges]).astype(np.float32)


TABLES = {"afgl1200": _afgl_table, "flat7": _flat_table}


@pytest.fixture(params=sorted(TABLES), scope="module")
def case(request):
    levels, tau, tables = TABLES[request.param]()
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return f32(levels), f32(tau), f32(tables), _queries(tau, seed=len(tau))


def _twin(levels, tau, tables, q):
    return cf.collision_fetch_plain(
        torch.as_tensor(q), torch.as_tensor(levels), torch.as_tensor(tau),
        torch.as_tensor(tables),
    )


def test_twin_matches_medium_collision_fetch(case):
    levels, tau, tables, q = case
    z_ref, idx_ref, fetched_ref = ref_collision_fetch(
        jnp.asarray(q), jnp.asarray(levels), jnp.asarray(tau),
        [jnp.asarray(t) for t in tables],
    )
    z, layer, fetched = _twin(levels, tau, tables, q)
    assert layer.dtype == torch.int32
    np.testing.assert_array_equal(layer.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(fetched.numpy(), np.stack([np.asarray(f) for f in fetched_ref]))
    # atol: XLA:CPU flushes subnormals to zero, so the query one ulp above
    # tau = 0 gives z = 0 there and a subnormal z here
    np.testing.assert_allclose(
        z.numpy(), np.asarray(z_ref), rtol=1e-6, atol=np.finfo(np.float32).tiny
    )


def test_twin_matches_pallas_interpret(case):
    levels, tau, tables, q = case
    L = tables.shape[1]
    stacked = np.concatenate([tables.T, np.zeros((1, tables.shape[0]), np.float32)])
    out, idx = collision_fetch_pallas(
        jnp.asarray(q), jnp.asarray(tau), jnp.asarray(stacked), block_b=256,
        interpret=True,
    )
    _, layer, fetched = _twin(levels, tau, tables, q)
    np.testing.assert_array_equal(layer.numpy(), np.asarray(idx))
    assert int(layer.max()) <= L - 1
    np.testing.assert_allclose(fetched.numpy().T, np.asarray(out), rtol=2e-4, atol=1e-5)


def test_ties_go_to_upper_bound(case):
    levels, tau, tables, _ = case
    layer = _twin(levels, tau, tables, tau)[1].numpy()
    expect = np.clip(np.searchsorted(tau, tau, side="right") - 1, 0, tables.shape[1] - 1)
    np.testing.assert_array_equal(layer, expect)


def test_medium_dispatches_to_twin_on_cpu(case):
    levels, tau, tables, q = case
    before = cf.launches
    args = [torch.as_tensor(a) for a in (q, levels, tau, tables)]
    out = medium.collision_fetch(*args)
    ref = cf.collision_fetch_plain(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert cf.launches == before  # no kernel launch for CPU tensors


def _args(L=8, K=3, B=16):
    return [
        torch.zeros(B),
        torch.linspace(0, 1, L + 1),
        torch.linspace(0, 1, L + 1),
        torch.zeros(K, L),
    ]


def _bad_args(kind):
    args = _args()
    if kind == "dtype":
        args[0] = args[0].double()
    elif kind == "non-contiguous":
        args[3] = torch.zeros(8, 3).T
    elif kind == "levels-shape":
        args[2] = torch.linspace(0, 1, 5)
    elif kind == "rank":
        args[0] = torch.zeros(4, 4)
    elif kind == "shared-memory":
        args = _args(L=cf.MAX_LEVELS)
    return args


@pytest.mark.parametrize(
    "kind, exc",
    [
        ("dtype", TypeError),
        ("non-contiguous", ValueError),
        ("levels-shape", ValueError),
        ("rank", ValueError),
        ("shared-memory", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(kind, exc):
    cf._check(*_args())  # the unmodified inputs pass
    with pytest.raises(exc):
        cf._check(*_bad_args(kind))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        cf.collision_fetch(*[a.to("meta") for a in _args()])



def _random_levels(L, seed):
    """L + 1 ascending float32 levels with runs of equal ones."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.0, 1.0, L) * (rng.uniform(size=L) > 0.3)
    return np.concatenate([[0.0], np.cumsum(dtau)]).astype(np.float32)


def _searchsorted(levels, q):
    return torch.searchsorted(torch.as_tensor(levels), torch.as_tensor(q), right=True).numpy()


@pytest.mark.parametrize("L", [*range(1, 65), 1200])
def test_fixed_trip_search_equals_searchsorted(L):
    """The kernel's search (its trip count, tree layout and comparison)
    counts what ``searchsorted(right=True)`` counts on every level, one ulp
    either side, runs of equal levels, -0.0 and -inf; on NaN and +inf it
    counts past the last level, which the kernel's clamp makes the same."""
    levels = _random_levels(L, seed=L)
    q = fetch_tools.stress_queries(levels, 3 * L + 600, seed=L)
    count = fetch_tools.upper_bound_fixed(levels, q)
    want = _searchsorted(levels, q)
    past = np.isnan(q) | (q == np.inf)
    np.testing.assert_array_equal(count[~past], want[~past])
    assert (want[past] == L + 1).all() and (count[past] >= L + 1).all()
    assert np.array_equal(np.clip(count - 1, 0, L - 1), np.clip(want - 1, 0, L - 1))


@pytest.mark.parametrize("L", [1, 2, 3, 6, 7, 46, 1200])
def test_fixed_trip_search_one_trip_too_few_is_caught(L):
    """With one trip fewer (and the tree it fills) the search cannot tell
    L + 2 outcomes apart; the queries on every level find it out."""
    levels = _random_levels(L, seed=L)
    q = fetch_tools.stress_queries(levels, 3 * L + 600, seed=L)
    short = fetch_tools.upper_bound_fixed(levels, q, fetch_tools.search_trips(L) - 1)
    assert not np.array_equal(np.minimum(short, L + 1), _searchsorted(levels, q))
    if 2 ** (fetch_tools.search_trips(L) - 1) <= L:  # and then a layer (the
        # counts it loses, 2^(T-1) and above, are not all clamped to L - 1)
        assert not np.array_equal(np.clip(short - 1, 0, L - 1),
                                  np.clip(_searchsorted(levels, q) - 1, 0, L - 1))


@pytest.mark.parametrize("L", [1, 5, 46, 1200, 12287])
def test_search_tree_is_the_levels_in_breadth_first_order(L):
    """An in-order walk of the staged tree gives the levels in order, then
    the +inf padding; the tree fits the trip count."""
    levels = _random_levels(L, seed=L)
    T = fetch_tools.search_trips(L)
    assert 2 ** (T - 1) < L + 2 <= 2**T
    tree = fetch_tools.search_tree(levels)
    assert tree.size == 2**T

    walk, stack, i = [], [], 1
    while stack or i < 2**T:  # in order, without recursion
        while i < 2**T:
            stack.append(i)
            i = 2 * i
        i = stack.pop()
        walk.append(tree[i])
        i = 2 * i + 1
    walk = np.asarray(walk, np.float32)
    np.testing.assert_array_equal(walk[: L + 1], levels)
    assert walk.size == 2**T - 1 and np.isinf(walk[L + 1 :]).all()


def test_twin_matches_medium_collision_fetch_on_special_queries(case):
    """NaN, +-inf and -0.0: the twin and the JAX package's CPU path put NaN
    and +inf in the last layer, -inf in the first; z is NaN only for NaN."""
    levels, tau, tables, _ = case
    q = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, np.float32(3.4e38)], np.float32)
    z_ref, idx_ref, fetched_ref = ref_collision_fetch(
        jnp.asarray(q), jnp.asarray(levels), jnp.asarray(tau),
        [jnp.asarray(t) for t in tables],
    )
    z, layer, fetched = _twin(levels, tau, tables, q)
    L = tables.shape[1]
    np.testing.assert_array_equal(layer.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(layer.numpy()[:3], [L - 1, L - 1, 0])
    np.testing.assert_array_equal(fetched.numpy(), np.stack([np.asarray(f) for f in fetched_ref]))
    np.testing.assert_array_equal(np.isnan(z.numpy()), np.isnan(q))
    np.testing.assert_array_equal(np.isnan(np.asarray(z_ref)), np.isnan(q))
    np.testing.assert_allclose(z.numpy()[1:], np.asarray(z_ref)[1:], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_float64_twin_matches_medium_collision_fetch_under_x64(name):
    levels, tau, tables = (np.ascontiguousarray(a, np.float64) for a in TABLES[name]())
    q = fetch_tools.stress_queries(tau, 5000, seed=len(tau))
    assert q.dtype == np.float64 and np.isnan(q[0]) and (q == -0.0).any()
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        z_ref, idx_ref, fetched_ref = (np.asarray(x) if not isinstance(x, list) else x
                                       for x in ref_collision_fetch(
            jnp.asarray(q), jnp.asarray(levels), jnp.asarray(tau),
            [jnp.asarray(t) for t in tables]))
        fetched_ref = np.stack([np.asarray(f) for f in fetched_ref])
    finally:
        jax.config.update("jax_enable_x64", old)
    assert z_ref.dtype == fetched_ref.dtype == np.float64
    z, layer, fetched = _twin(levels, tau, tables, q)
    assert z.dtype == fetched.dtype == torch.float64 and layer.dtype == torch.int32
    np.testing.assert_array_equal(layer.numpy(), idx_ref)
    assert int(layer[0]) == tables.shape[1] - 1  # NaN: past every level
    np.testing.assert_array_equal(fetched.numpy(), fetched_ref)
    same = (z.numpy() == z_ref) | (np.isnan(z.numpy()) & np.isnan(z_ref))
    # XLA:CPU flushes subnormals to zero (the query one ulp above tau = 0)
    flushed = ~same & (np.abs(z.numpy()) < np.finfo(np.float64).tiny) & (z_ref == 0.0)
    assert (same | flushed).all(), np.nonzero(~(same | flushed))


@pytest.mark.parametrize("case_", ["float16", "mixed"])
def test_wrapper_rejects_float16_and_mixed_dtypes(case_):
    cf._check(*[a.double() for a in _args()])  # all float64 passes
    args = _args()
    if case_ == "float16":
        args = [a.half() for a in args]
    else:
        args[3] = args[3].double()
    with pytest.raises(TypeError):
        cf._check(*args)
