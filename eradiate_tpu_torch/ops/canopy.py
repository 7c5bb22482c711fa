"""Canopy geometry: leaf-disk clouds and their ray sweeps.

Port of ``eradiate_tpu/ops/canopy.py``. Leaves are flat disks: centers
[N, 3], unit normals [N, 3], radii [N], lengths in km. A canopy is a flat
table (:class:`LeafCloudArrays`) or one canonical cloud with per-instance
translations (:class:`InstancedLeafArrays`), which the sweeps treat as the
union of the translated copies without materialising them.

:func:`leaf_nearest` and :func:`leaf_occluded` clip each ray to the cloud's
bounding box (:func:`_advance_to_aabb`, an accuracy fix for float32 as much
as a cull) and hand the clipped segment to the sweeps of
:mod:`eradiate_tpu_torch.kernels.leaf_intersect`: CUDA kernels for CUDA
tensors, the plain sweeps for CPU tensors. Everything follows the dtype of
the leaves and the rays: float32, or float64 in the double modes (the
kernels' float64 builds; the box advance's fused multiply-adds exact in
float64, as XLA:CPU rounds them under x64).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.leaf_intersect import (
    fma,
    leaf_bvh,
    leaf_instanced_bvh,
    ray_leaves_nearest,
    ray_leaves_nearest_instanced,
    ray_leaves_occluded,
    ray_leaves_occluded_instanced,
)

__all__ = [
    "InstancedLeafArrays",
    "LeafCloudArrays",
    "leaf_bounds",
    "leaf_nearest",
    "leaf_accel",
    "leaf_occluded",
    "morton_order",
]


@dataclasses.dataclass
class LeafCloudArrays:
    centers: Any  # [N, 3]
    normals: Any  # [N, 3]
    radii: Any  # [N]


@dataclasses.dataclass
class InstancedLeafArrays:
    """One canonical (Morton-ordered) cloud and per-instance translations;
    leaf storage is the canonical cloud alone."""

    canonical: LeafCloudArrays
    offsets: Any  # [I, 3]


def leaf_bounds(leaves):
    """(lo, hi) bounding box of the leaf set (flat or instanced)."""
    if isinstance(leaves, InstancedLeafArrays):
        c = leaves.canonical
        lo_c = (c.centers - c.radii[:, None]).min(dim=0).values
        hi_c = (c.centers + c.radii[:, None]).max(dim=0).values
        return (
            lo_c + leaves.offsets.min(dim=0).values,
            hi_c + leaves.offsets.max(dim=0).values,
        )
    lo = (leaves.centers - leaves.radii[:, None]).min(dim=0).values
    hi = (leaves.centers + leaves.radii[:, None]).max(dim=0).values
    return lo, hi


def morton_order(positions):
    """Host-side Morton (Z-curve) ordering permutation for leaf positions
    [N, 3] (numpy). Spatially adjacent leaves land in adjacent slots, as the
    reference orders them (its TPU kernels bound groups of consecutive
    leaves). Pure reordering: the sweeps are order-invariant up to exact
    ties."""
    pos = np.asarray(positions, dtype=np.float64)
    lo = pos.min(axis=0)
    span = np.maximum(pos.max(axis=0) - lo, 1e-12)
    q = np.clip((pos - lo) / span * ((1 << 21) - 1), 0, (1 << 21) - 1).astype(np.uint64)
    code = np.zeros(pos.shape[0], dtype=np.uint64)
    for b in range(21):
        for ax in range(3):
            code |= ((q[:, ax] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + ax)
    return np.argsort(code, kind="stable")


def leaf_accel(leaves):
    """Acceleration data for the leaf sweeps: ``(cull, box_lo, box_hi)``.
    ``cull`` is the kernels' cull operand on CUDA, built here on the host:
    the bounding volume hierarchy of a flat table
    (:func:`~eradiate_tpu_torch.kernels.leaf_intersect.leaf_bvh`) or the
    two-level one of an instanced set, the instances' boxes above the
    canonical cloud's hierarchy
    (:func:`~eradiate_tpu_torch.kernels.leaf_intersect.leaf_instanced_bvh`);
    None on the CPU, where the dense sweeps use none and nothing is built.
    Compute once per render, outside the path loop, and pass to every
    :func:`leaf_nearest`/:func:`leaf_occluded`."""
    lo, hi = leaf_bounds(leaves)
    instanced = isinstance(leaves, InstancedLeafArrays)
    base = leaves.canonical if instanced else leaves
    if base.centers.device.type == "cpu":
        return None, lo, hi
    if instanced:
        return leaf_instanced_bvh(base.centers, base.normals, base.radii, leaves.offsets), lo, hi
    return leaf_bvh(base.centers, base.normals, base.radii), lo, hi


def _advance_to_aabb(p, d, t_max, lo, hi):
    """Clip rays to their overlap with the cloud's box: returns
    ``(p_adv, t0, t_cap)`` with ``p_adv = p + t0 d`` and the remaining
    in-box flight cap ``t_cap`` (0 where the segment misses the box).

    Two purposes. Precision: sweeping from a TOA-distant origin (|p| ~ 1e2
    km) against 1e-4 km disks loses ~7 mm to float32 rounding in ``p + t
    d``, a double-digit percentage of the disk radius; starting at the box
    keeps the round-off ~1e4 times below the disk size. Speed: lanes whose
    segment misses the box sweep nothing (``t_cap = 0``).

    Rounding of ``p + t0 d``: XLA:CPU contracts the x and y components into
    fused multiply-adds and leaves z a separate product and sum (the
    vectorised pair and the scalar remainder of a 3-wide row). A ray that
    leaves a leaf at a grazing angle meets that leaf again or not depending
    on this last bit, so the port rounds the same way: with it, same-seed
    runs of the small canopy tests follow the reference's paths on every
    pixel; with all three components fused, or none, about one pixel in five
    takes another path.
    """
    safe_d = torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    ta = (lo[None, :] - p) / safe_d
    tb = (hi[None, :] - p) / safe_d
    t_enter = torch.minimum(ta, tb).max(dim=1).values
    t_exit = torch.maximum(ta, tb).min(dim=1).values
    # back the entry off by a relative epsilon: geometry lying ON a box face
    # would otherwise see its hit at t_loc ~ +-ulp(t_enter), rejected by the
    # sweeps' t > 1e-7 gate. 1e-5 relative keeps the advanced origin within
    # ~2e-4 of the box at t ~ 20 km, far below the disk scale the advance
    # exists to protect.
    t_enter = t_enter - 1e-5 * torch.abs(t_enter) - 1e-6
    # ... and pad the exit symmetrically: geometry lying ON the far box face
    # would otherwise see its hit at t_loc == t_cap, rejected by the sweeps'
    # strict t < t_max gate
    t_exit = t_exit + 1e-5 * torch.abs(t_exit) + 1e-6
    t0 = torch.minimum(torch.clamp(t_enter, min=0.0), t_max)
    t_cap = torch.clamp(torch.minimum(t_exit, t_max) - t0, min=0.0)
    p_adv = torch.cat(
        [fma(t0[:, None], d[:, :2], p[:, :2]), p[:, 2:] + t0[:, None] * d[:, 2:]], dim=1
    )
    return p_adv, t0, t_cap


def leaf_nearest(p, d, t_max, leaves, accel=None):
    """Nearest leaf hit of rays ``p + t d``, t in (0, t_max): box-advanced
    origins, then the sweep (flat or instanced). Returns ``(t [B], normal
    [B, 3], hit [B])``; misses keep ``t = t_max``."""
    cull, lo, hi = accel if accel is not None else leaf_accel(leaves)
    p_adv, t0, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(leaves, InstancedLeafArrays):
        c = leaves.canonical
        t_loc, n, hit = ray_leaves_nearest_instanced(
            p_adv, d, t_cap, c.centers, c.normals, c.radii, leaves.offsets, cull
        )
    else:
        t_loc, n, hit = ray_leaves_nearest(
            p_adv, d, t_cap, leaves.centers, leaves.normals, leaves.radii, cull
        )
    return torch.where(hit, t0 + t_loc, t_max), n, hit


def leaf_occluded(p, d, t_max, leaves, accel=None):
    """Shadow-ray any-hit with the box advance; returns bool [B]."""
    cull, lo, hi = accel if accel is not None else leaf_accel(leaves)
    p_adv, _, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(leaves, InstancedLeafArrays):
        c = leaves.canonical
        return ray_leaves_occluded_instanced(
            p_adv, d, t_cap, c.centers, c.normals, c.radii, leaves.offsets, cull
        )
    return ray_leaves_occluded(
        p_adv, d, t_cap, leaves.centers, leaves.normals, leaves.radii, cull
    )
