"""The wrappers that must refuse a forward-mode dual, for the tests and the
smoke script.

:func:`geometry_calls` gives small operands on ``device`` and, by wrapper
name, a call that puts its argument where the ray origins (or, for the
collision fetch, the queries) go: every geometry wrapper (K2, K3, K5-K9, the
terrain march) and the operands of K1, K4 and the shell depths that carry
no tangent. A dual passed there must raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..kernels import collision_fetch as cf
from ..kernels import leaf_intersect as li
from ..kernels import shell_flight as sf
from ..kernels import tri_intersect as ti
from ..ops.dem import DemArrays, dem_intersect, dem_occluded

__all__ = ["geometry_calls"]


def geometry_calls(device="cpu", B=8):
    """``(p [B, 3], {name: call})``: ``p`` ray origins 10 km above a
    two-shell planet, each call taking ``p`` (or a dual of it)."""

    def tensor(v):
        return torch.tensor(v, device=device)

    p = torch.zeros(B, 3, device=device)
    p[:, 2] = 6388.1
    d = torch.zeros(B, 3, device=device)
    d[:, 2] = -1.0
    t = torch.full((B,), 5.0, device=device)
    layer = torch.zeros(B, dtype=torch.int32, device=device)
    radii = tensor([6378.1, 6388.1, 6398.1])
    sigma = tensor([0.01, 0.02])
    w = tensor([0.0, 0.0, 1.0])
    c = torch.zeros(4, 3, device=device)
    n = torch.zeros(4, 3, device=device)
    n[:, 2] = 1.0
    r = torch.full((4,), 0.1, device=device)
    off = torch.zeros(2, 3, device=device)
    dem = DemArrays(torch.zeros(4, 4, device=device), *(tensor(v) for v in (0.0, 0.0, 1.0, 1.0)))
    tables = torch.ones(2, 2, device=device)
    z_lv, tau_lv = torch.linspace(0.0, 10.0, 3, device=device), tensor([0.0, 0.1, 0.2])
    return p, {
        "shell_flight": lambda x: sf.shell_flight(x, d, t, radii, sigma, t),
        "shell_event": lambda x: sf.shell_event(x, d, t, radii, sigma, t, w),
        "slant_tau": lambda x: sf.slant_tau(x, w, radii, sigma),
        "shell_depths": lambda x: sf.shell_depths(x, d, t, layer, t, radii, sigma),
        "collision_fetch": lambda x: cf.collision_fetch(x[:, 2].contiguous(), z_lv, tau_lv,
                                                        tables),
        "ray_leaves_nearest": lambda x: li.ray_leaves_nearest(x, d, t, c, n, r),
        "ray_leaves_occluded": lambda x: li.ray_leaves_occluded(x, d, t, c, n, r),
        "ray_leaves_nearest_instanced": lambda x: li.ray_leaves_nearest_instanced(
            x, d, t, c, n, r, off),
        "ray_leaves_occluded_instanced": lambda x: li.ray_leaves_occluded_instanced(
            x, d, t, c, n, r, off),
        "ray_tris_nearest": lambda x: ti.ray_tris_nearest(x, d, t, c, n, n),
        "ray_tris_occluded": lambda x: ti.ray_tris_occluded(x, d, t, c, n, n),
        "ray_tris_nearest_instanced": lambda x: ti.ray_tris_nearest_instanced(
            x, d, t, c, n, n, off),
        "ray_tris_occluded_instanced": lambda x: ti.ray_tris_occluded_instanced(
            x, d, t, c, n, n, off),
        "dem_intersect": lambda x: dem_intersect(dem, x, d, t),
        "dem_occluded": lambda x: dem_occluded(dem, x, d, t),
    }
