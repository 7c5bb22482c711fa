# Host-code copy of eradiate_tpu/physics/shell_merge.py; regenerate with tools/copy_host_code.py, do not edit.
"""Error-bounded adaptive merging of spherical-shell layers.

The spherical tracer's per-event cost is O(B·L) in the shell count L
(measured VPU elementwise law, ``docs/developer_guide/performance.md``):
the flight and slant-tau kernels sweep every [B, L] element each event.
The default altitude grid (100 m over [0, 120] km, mirroring the
reference's ``scenes/geometry.py:22-97`` where the grid is likewise a
user-settable model parameter) spends most of those 1200 shells where the
extinction profile is nearly constant — merging adjacent shells there
cuts L (and the tracer's per-event time, which scales ~1/L) at a
*bounded* slant optical-depth error.

Merge rule
----------
Adjacent layers are grouped greedily from the ground up. A group spanning
radii [r_a, r_b] is represented by ONE shell whose extinction is the
thickness-weighted mean ``sigma_m = sum(sigma_i dz_i) / sum(dz_i)`` — the
vertical optical depth of the column is preserved *exactly* (every
nadir/zenith path integral is unchanged). The only error is for slant
rays, where the geometric path weights differ across the group; it is
largest for the ray tangent at the group floor. The greedy criterion
bounds that worst case directly:

    err(group) = 2 * max_s  sum_i |sigma_i[s] - sigma_m[s]| * ds_i  <=  tau_tol

with ``ds_i`` the per-layer path lengths of the tangent ray (factor 2:
both legs), maximized over spectral rows ``s``. Per-group tangent rays
are the worst case (the traversed length of a radius interval decreases
as the impact parameter drops below the interval floor), and a single
physical ray is tangent to exactly one group while crossing the others
at steeper local angles, so the realized per-ray error stays near the
single-group bound rather than the sum (measured in
``docs/developer_guide/performance.md``).

Scattering parameters (albedo, phase blend weights, per-layer phase
parameters) are averaged with scattering-depth weights so the vertical
scattering optical depth and the column-mean phase function are
preserved.

Reference for the grid being a model parameter (not a fixed constant):
``src/eradiate/scenes/geometry.py:22-97`` (user-settable ``zgrid``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "adaptive_layer_groups_pp",
    "adaptive_shell_groups",
    "merge_layer_mean",
    "merge_layer_weighted",
]


def adaptive_shell_groups(
    z_levels: np.ndarray,
    sigma_t: np.ndarray,
    planet_radius: float,
    tau_tol: float,
    max_group_height: float | None = None,
) -> np.ndarray:
    """Greedy bottom-up grouping of shells under a slant-tau error bound.

    Parameters
    ----------
    z_levels : [L+1] ascending altitudes [km]
    sigma_t : [S, L] per-row extinction [1/km]
    planet_radius : planet radius [km]
    tau_tol : worst-case per-group tangent-ray optical depth error bound;
        <= 0 disables merging (identity grouping)
    max_group_height : optional cap on merged shell thickness [km]

    Returns
    -------
    [G+1] int array of level indices bounding the merged groups
    (``groups[0] == 0``, ``groups[-1] == L``).
    """
    z = np.asarray(z_levels, dtype=np.float64)
    sig = np.atleast_2d(np.asarray(sigma_t, dtype=np.float64))
    L = z.size - 1
    if tau_tol is None or tau_tol <= 0.0 or L < 2:
        return np.arange(L + 1)

    r = planet_radius + z
    dz = np.diff(z)
    bounds = [0]
    i0 = 0
    while i0 < L:
        b = r[i0]  # tangent at the group floor: worst-case geometry
        # per-layer tangent path lengths, cancellation-stable quotient form
        f = np.sqrt(np.maximum(r * r - b * b, 0.0))
        ds = np.diff(f)  # [L]
        i1 = i0 + 1
        while i1 < L:
            j = slice(i0, i1 + 1)
            dzj = dz[j]
            sig_m = (sig[:, j] @ dzj) / dzj.sum()
            err = 2.0 * np.max(
                np.abs(sig[:, j] - sig_m[:, None]) @ ds[j]
            )
            if err > tau_tol:
                break
            if (
                max_group_height is not None
                and z[i1 + 1] - z[i0] > max_group_height
            ):
                break
            i1 += 1
        bounds.append(i1)
        i0 = i1
    return np.asarray(bounds, dtype=np.int64)


def adaptive_layer_groups_pp(
    z_levels: np.ndarray,
    rows: np.ndarray,
    tau_tol: float,
    mu_min: float = 0.1,
) -> np.ndarray:
    """Plane-parallel variant of :func:`adaptive_shell_groups`.

    Plane-parallel transport is exactly invariant under layer merging
    when the profile is constant within each group — radiance depends on
    the optical-depth coordinate alone — so the only error source is the
    *variation* of the merged quantities inside a group. The criterion
    bounds the worst-case slant path integral of that variation:

        err(group) = 2 * max_r  sum_i |rows[r, i] - mean_r| dz_i / mu_min
                   <= tau_tol

    ``rows`` stacks every quantity whose smearing matters — extinction
    AND the per-component scattering coefficients (sigma_s * blend
    weight), so sharp material boundaries (an aerosol layer edge) block
    merging across them. ``mu_min`` is the steepest slant credited
    (|cos zenith| below it is measure-zero for distant measures).
    """
    z = np.asarray(z_levels, dtype=np.float64)
    r = np.atleast_2d(np.asarray(rows, dtype=np.float64))
    L = z.size - 1
    if tau_tol is None or tau_tol <= 0.0 or L < 2:
        return np.arange(L + 1)
    dz = np.diff(z)
    bounds = [0]
    i0 = 0
    while i0 < L:
        i1 = i0 + 1
        while i1 < L:
            j = slice(i0, i1 + 1)
            dzj = dz[j]
            m = (r[:, j] @ dzj) / dzj.sum()
            err = 2.0 * np.max(np.abs(r[:, j] - m[:, None]) @ dzj) / mu_min
            if err > tau_tol:
                break
            i1 += 1
        bounds.append(i1)
        i0 = i1
    return np.asarray(bounds, dtype=np.int64)


def _group_reduce(x: np.ndarray, groups: np.ndarray, weights: np.ndarray):
    """Weighted mean of trailing-axis-L array ``x`` over each group.

    weights: [..., L] broadcastable to x; groups as returned by
    :func:`adaptive_shell_groups`. Zero-weight groups fall back to the
    unweighted mean (vacuum shells: values are inert there).
    """
    x = np.asarray(x, dtype=np.float64)
    w = np.broadcast_to(np.asarray(weights, dtype=np.float64), x.shape)
    segs = np.asarray(groups)
    out = np.empty(x.shape[:-1] + (segs.size - 1,), dtype=np.float64)
    for g in range(segs.size - 1):
        j = slice(segs[g], segs[g + 1])
        wj = w[..., j]
        denom = wj.sum(axis=-1)
        num = (x[..., j] * wj).sum(axis=-1)
        plain = x[..., j].mean(axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[..., g] = np.where(denom > 0.0, num / np.maximum(denom, 1e-300), plain)
    return out


def merge_layer_mean(x, groups, dz):
    """Thickness-weighted group mean (preserves vertical integrals of
    ``x * dz`` — used for sigma_t)."""
    return _group_reduce(x, groups, dz)


def merge_layer_weighted(x, groups, weights):
    """Group mean with caller-supplied weights (e.g. scattering depth
    ``sigma_s * dz`` for albedo/phase quantities)."""
    return _group_reduce(x, groups, weights)
