"""The collision fetch's search as the CUDA kernel runs it, and its operands,
for the tests and the smoke script.

The kernel (``csrc/collision_fetch.cu``) finds each lane's upper bound among
the ``L + 1`` levels with a branch-free search of a fixed trip count,
:func:`search_trips` (``ceil(log2(L + 2))``), over the levels laid out as an
implicit binary tree in breadth-first order (:func:`search_tree`: node ``i``
at depth ``d`` holds the sorted level ``(2 (i - 2^d) + 1) 2^(T-1-d) - 1``,
``+inf`` past the last). Each trip goes right where ``!(q < node)``, so the
path's bits, the leaf reached less ``2^T``, count the levels at or below
``q``: a tie or a run of equal levels goes up, ``-0.0`` lands as ``+0.0``,
and a NaN goes right everywhere, past every level, as
``torch.searchsorted(right=True)`` puts it. :func:`upper_bound_fixed`
emulates that search in numpy; a NaN or ``+inf`` query may count past
``L + 1`` into the padding, which the kernel's clamp of the layer to
``L - 1`` makes the same.

:func:`column_operands` gives the c1 column's operands (merged or not),
:func:`flat_run_operands` a table with runs of equal levels, and
:func:`stress_queries` the queries where the search is hardest to keep.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "search_trips",
    "search_tree",
    "upper_bound_fixed",
    "column_operands",
    "flat_run_operands",
    "stress_queries",
]


def search_trips(L):
    """The kernel's trip count at ``L`` layers: ``ceil(log2(L + 2))``, the
    least ``T`` with ``2^T >= L + 2`` outcomes (0 to ``L + 1`` levels at or
    below a query)."""
    return int(L + 1).bit_length()


def search_tree(levels, trips=None):
    """The ``L + 1`` ascending ``levels`` in breadth-first order, as the
    kernel stages them: ``2^T`` float32 (node 0 unused, ``+inf``), node
    ``i`` at depth ``d = floor(log2 i)`` holding sorted level
    ``(2 (i - 2^d) + 1) 2^(T-1-d) - 1``, ``+inf`` past the last level."""
    levels = np.asarray(levels, np.float32)
    T = search_trips(levels.size - 1) if trips is None else trips
    i = np.arange(1, 2**T)
    d = np.floor(np.log2(i)).astype(np.int64)
    s = (2 * (i - 2**d) + 1) * 2 ** (T - 1 - d) - 1
    tree = np.full(2**T, np.inf, np.float32)
    inside = s < levels.size
    tree[i[inside]] = levels[s[inside]]
    return tree


def upper_bound_fixed(levels, q, trips=None):
    """The kernel's search: the count of levels at or below each query
    (``int64``), from ``trips`` (default :func:`search_trips`) branch-free
    trips down :func:`search_tree`. Equal to ``searchsorted(side="right")``
    for every query but NaN and ``+inf``, which count past the last level."""
    levels = np.asarray(levels, np.float32)
    T = search_trips(levels.size - 1) if trips is None else trips
    tree = search_tree(levels, T)
    q = np.asarray(q, np.float32)
    node = np.ones(q.shape, np.int64)
    for _ in range(T):
        node = 2 * node + ~(q < tree[node])
    return node - 2**T


def column_operands(layer_merge_tol=1e-3, dtype=np.float32):
    """The c1 column's collision-fetch operands at 550 nm (albedo, phase
    weight, depolarisation: K = 3; :func:`experiment_operands`).
    ``layer_merge_tol=None`` keeps the 1200 layers of 0.1 km; c1's 1e-3
    merges them into 46. It compiles the scene under the mode that is set
    (c1's is ``mono_single``, or ``mono_double`` for ``dtype`` float64)."""
    from ..experiments import AtmosphereExperiment

    return experiment_operands(AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane", "zeniths": [0.0],
                  "azimuth": 0.0, "id": "m"},
        surface={"type": "lambertian", "reflectance": 0.5},
        atmosphere={"type": "molecular"},
        geometry={"type": "plane_parallel", "layer_merge_tol": layer_merge_tol},
    ), dtype=dtype)


def experiment_operands(exp, row=0, dtype=np.float32):
    """The collision-fetch operands of a plane-parallel experiment's first
    measure, spectral row ``row``, as the tracer holds them: ``(z_levels
    [L+1], tau_levels [L+1], tables [K, L])`` of ``dtype``, the tables the
    albedo, each phase component's weight and the layer-indexed phase
    parameters (c2: K = 4). It compiles the scene under the mode that is
    set."""
    from ..ops.phase_ops import layer_param_slots

    m = exp.measures[0]
    scene, _, config = exp.compile_scene(m, exp.spectral_context(m))
    med = scene.medium
    params = tuple({k: v[row] for k, v in p.items()} for p in med.phase_params)
    extra, _ = layer_param_slots(config.phase_kinds, params)
    tables = np.stack([med.albedo[row], *med.phase_weights[row], *extra])
    return tuple(np.ascontiguousarray(a, dtype)
                 for a in (med.z_levels, med.tau_levels[row], tables))


def flat_run_operands(K=3, seed=3, dtype=np.float32):
    """Seven layers whose extinction is 0 in three of them (levels 1, 2 and 3
    equal, and levels 5 and 6), with ``K`` seeded table rows."""
    tau = np.concatenate([[0.0], np.cumsum([0.1, 0, 0, 0.3, 0.2, 0, 0.5])])
    tables = np.random.default_rng(seed).uniform(size=(K, 7))
    return tuple(np.ascontiguousarray(a, dtype) for a in (np.arange(8.0), tau, tables))


def stress_queries(tau, n, seed):
    """``n`` queries of ``tau``'s dtype (float32 or float64): uniform in
    ``[0, tau_top]``, with NaN, +-inf, -0.0, +0.0, a negative value, values
    past the top, every level and its neighbours one ulp either side written
    over the head (as many as fit)."""
    tau = np.asarray(tau)
    dt = np.float64 if tau.dtype == np.float64 else np.float32
    tau = tau.astype(dt)
    q = np.random.default_rng(seed).uniform(0.0, tau[-1], n).astype(dt)
    edges = np.concatenate([
        [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, 1.5 * tau[-1], 3.4e38 if dt is np.float32 else 1.7e308],
        tau,
        np.nextafter(tau, dt(np.inf)),
        np.nextafter(tau, dt(-np.inf)),
    ]).astype(dt)
    k = min(n, edges.size)
    q[:k] = edges[:k]
    return q
