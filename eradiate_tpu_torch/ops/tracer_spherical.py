"""Regenerative wavefront path tracer, spherical-shell geometry.

Port of ``eradiate_tpu/ops/tracer_spherical.py``: exact free flight through
concentric shells (one shell-flight kernel launch per event), next-event
estimation aimed straight at the directional sun, Russian roulette on real
interactions, and path regeneration. As in the reference, any sampler
renders as ``independent`` and the constant sky is carried in the rows but
never read.

The sun transmittance at an event comes from one of three branches, as in
the reference:

- **lr_flight**: with ``config.lr_flight`` (the configuration the
  sensitivity renders use) the flight is
  :func:`..kernels.shell_flight.shell_flight` on the detached extinction and
  the exact slant depth at the event point a second launch,
  :func:`..kernels.shell_flight.slant_tau`, on the attached one (its forward
  rule carries the extinction's tangent). Where the extinction carries a
  tangent, the reference's likelihood-ratio weights follow
  (:func:`lr_weights`: the shell-depth kernel on the tangent, primal exactly
  1), so the estimate equals the exact branch's bit for bit;
- **table**: when the compiled scene carries a sun slant-tau table
  (``sun_tau``, on up to SZA 80 by default), the event point's slant depth
  is fetched from it by exact bilinear interpolation
  (:func:`.spherical.sun_tau_fetch_fast`), with the ground's shadow applied
  exactly; the flight is :func:`..kernels.shell_flight.shell_flight`;
- **exact**: otherwise :func:`..kernels.shell_flight.shell_event` returns the
  flight and the exact slant depth at the event point in one launch.

The loop is eager and follows :mod:`.tracer`: every update is gated by
``active``, ``path_end`` or ``regen`` where it matters, so the host reads the
all-lanes-done flag only every ``check_every`` iterations without changing
the result. Per-event uniforms are indexed by ``evt``, the number of events
since the current path started (8 per event), so each sample's stream
depends only on (seed, spectral row, pixel, global sample id, event).
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
import torch.autograd.forward_ad as fwAD

from ..kernels.dual import tangent
from ..kernels.shell_flight import shell_depths, shell_event, shell_flight, slant_tau
from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms, check_kind
from .fastmath import depth_sample
from .fastrng import bounce_uniforms, derive_keys
from .medium import fetch_at_index
from .phase_ops import (
    check_phase_kinds,
    layer_param_slots,
    ortho_frame,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import IlluminationArrays, SphericalMediumArrays, SurfaceArrays, from_reference
from .spherical import (
    TAU_BLOCKED,
    cross_norm2,
    dot3,
    fma,
    ray_sphere_intersect,
    sqrt_rn,
    sun_tau_fetch_fast,
)
from .tracer import CHECK_EVERY, RowRenderer, _row, lane_partition, row_key

__all__ = [
    "render_spherical",
    "row_renderer",
    "trace_paths_spherical_regen",
    "spherical_lanes_target",
    "sun_flight",
    "flight_bounds",
    "toa_rays",
    "to_local",
    "to_world",
    "spherical_row",
    "check_supported",
    "EPS_T",
    "MAX_ITERATIONS",
]

#: CUDA lane-count target. The eager loop costs a roughly fixed host time per
#: event iteration, so lanes are added until the device time per iteration
#: matches it (PERF.md, c4 lane sweep on an H100).
SPHERICAL_LANES_TARGET_CUDA = 2**21

#: Lane-count rule of the reference (``spherical_lanes_target``), kept for
#: the CPU so that CPU runs decompose as the reference's do.
_LANES_LO = 2**14
_LANES_HI = 2**16
_QUOTA_DEEP = 24

#: Cap on events per path (reference ``render_spherical`` ``max_iterations``).
MAX_ITERATIONS = 512

#: Surface offset against self-intersection, km.
EPS_T = 1e-4


def spherical_lanes_target(n_pix, spp, device_type="cpu"):
    """Lane-count target: the reference's rule on the CPU, the swept
    :data:`SPHERICAL_LANES_TARGET_CUDA` on CUDA."""
    if device_type == "cuda":
        return SPHERICAL_LANES_TARGET_CUDA
    return _LANES_HI if n_pix * spp >= _LANES_HI * _QUOTA_DEEP else _LANES_LO


def to_local(n, v):
    """World vectors -> local frames with +z = n."""
    t1, t2 = ortho_frame(n)
    return torch.stack([dot3(t1, v), dot3(t2, v), dot3(n, v)], dim=-1)


def to_world(n, v):
    t1, t2 = ortho_frame(n)
    return t1 * v[..., 0:1] + t2 * v[..., 1:2] + n * v[..., 2:3]


def flight_bounds(p, d, radii):
    """Distances along ``p + t d`` to the ground and to the top of the
    atmosphere: ``(t_ground, t_exit)``, ``t_ground`` inf where the ray
    misses the ground. The flight cap is their minimum."""
    r_ground = radii[0]
    tgn, tgf, hit_g = ray_sphere_intersect(p, d, r_ground)
    inside = dot3(p, p) < r_ground * r_ground
    t_ground = torch.where(
        hit_g & (tgn > EPS_T),
        tgn,
        torch.where(hit_g & (tgf > EPS_T) & (tgn <= EPS_T) & inside, tgf, torch.inf),
    )
    _, ttf, _ = ray_sphere_intersect(p, d, radii[-1])
    return t_ground, torch.clamp(ttf, min=EPS_T)


def lr_weights(p, d, t_col, t_max, radii, sigma, layer):
    """The likelihood-ratio flight's weights ``(r_col, r_bnd)`` of the
    reference's ``exp(g_col - sg(g_col))`` and ``exp(-(tau_max - sg(tau_max)))``
    for a flight sampled on the detached ``sigma``: primal exactly 1, tangents
    ``sigma'[layer] / sigma[layer] - tau_path'`` and ``-tau_max'``, the path
    depths' tangents from the shell-depth kernel launched on ``sigma'`` (one
    launch). ``(None, None)`` where ``sigma`` carries no tangent: the weights
    are then 1 and nothing is launched."""
    sig_t = tangent(sigma)
    if sig_t is None:
        return None, None
    depth_col, depth_max = shell_depths(p, d, t_col, layer, t_max, radii, sig_t.contiguous())
    idx = layer.long()
    s_at = fwAD.unpack_dual(sigma).primal[idx]
    g_t = torch.where(s_at > 1e-30, sig_t[idx] / s_at, 0.0) - depth_col
    one = torch.ones_like(t_col)
    return fwAD.make_dual(one, g_t), fwAD.make_dual(one.clone(), -depth_max)


def sun_flight(config, medium_row, w_sun, p, d, u_dist):
    """An event's exact free flight from ``p`` along ``d`` and the sun's
    slant depth toward ``w_sun`` at its end, by the branch that ``config``
    and the medium pick (module docstring). Returns ``(accept, layer, p_new,
    tau_sun, t_ground, t_exit, r_col, r_bnd)``: the collide flag, the
    collision's layer, the event point (the collision, or the flight cap
    where the path leaves the medium), the flight cap's two distances and
    the likelihood-ratio weights of the collision and the boundary event
    (:func:`lr_weights`; None outside the likelihood-ratio flight and where
    the extinction carries no tangent)."""
    radii = medium_row.radii
    sigma = medium_row.sigma_t
    r_ground = radii[0]
    t_ground, t_exit = flight_bounds(p, d, radii)
    t_max = torch.minimum(t_ground, t_exit)

    # float32 uniforms: the depth is float32, taken exactly into the path
    # state's dtype, as the reference promotes it
    tau_s = depth_sample(u_dist, exact=radii.dtype == torch.float64).to(radii.dtype)
    r_col = r_bnd = None
    if config.lr_flight:
        # the likelihood-ratio flight: sampled on the detached extinction,
        # then the slant depth from the event point on the attached one,
        # formed with one fused multiply-add per component as the fused
        # event kernel forms it
        accept, t_col, layer = shell_flight(p, d, t_max, radii, sigma.detach(), tau_s)
        t_step = torch.where(accept, t_col, t_max)[:, None]
        tau_sun = slant_tau(fma(d, t_step, p), w_sun, radii, sigma)
        p_new = p + d * t_step
        r_col, r_bnd = lr_weights(p, d, t_col, t_max, radii, sigma, layer)
    elif medium_row.sun_tau is not None:
        accept, t_col, layer = shell_flight(p, d, t_max, radii, sigma, tau_s)
        p_new = p + d * torch.where(accept, t_col, t_max)[:, None]
        r_ev = sqrt_rn(dot3(p_new, p_new))
        mu_ev = dot3(p_new, w_sun) / torch.clamp(r_ev, min=1e-12)
        blocked = (mu_ev < 0.0) & (cross_norm2(p_new, w_sun) <= r_ground * r_ground)
        tau_fetch = sun_tau_fetch_fast(
            medium_row.sun_tau, medium_row.sun_r_grid, medium_row.sun_mu_warp, r_ev, mu_ev,
        )
        tau_sun = torch.where(blocked, TAU_BLOCKED, tau_fetch)
    else:
        accept, t_col, layer, tau_sun = shell_event(p, d, t_max, radii, sigma, tau_s, w_sun)
        p_new = p + d * torch.where(accept, t_col, t_max)[:, None]
    return accept, layer, p_new, tau_sun, t_ground, t_exit, r_col, r_bnd


def _make_event(config, medium_row, surface_row, illum_row):
    """Per-event transition shared by every lane: returns
    ``event(evt, p, d, beta, depth, keys)`` ->
    ``(contribution, p', d', beta', depth', alive')``."""
    d_sun = illum_row.direction
    w_sun = -d_sun
    E_sun = illum_row.irradiance

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    # albedo, blend weights and layer-indexed phase parameters: one gather
    fetch_tables = torch.stack(
        [medium_row.albedo]
        + [medium_row.phase_weights[c] for c in range(C)]
        + param_tables
    )

    def event(evt, p, d, beta, depth, keys):
        U = bounce_uniforms(keys, evt, 8, config.rng)
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        accept, layer, p_new, tau_sun, t_ground, t_exit, r_col, r_bnd = sun_flight(
            config, medium_row, w_sun, p, d, U[:, 0]
        )
        beta_w = beta if r_col is None else beta * r_col  # primal 1
        beta_b = beta if r_bnd is None else beta * r_bnd
        hit_surface = (~accept) & (t_ground <= t_exit) & config.has_surface

        fetched = fetch_at_index(layer, fetch_tables)
        albedo_col = fetched[0]
        weights_at = fetched[1 : 1 + C].T  # [B, C]
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[1 + C :])

        # one sun transmittance serves the volume and the surface branch
        T_sun = torch.exp(-torch.clamp(tau_sun, max=80.0))

        # ---- volume collision ------------------------------------------
        cos_nee = dot3(-d, d_sun)
        p_nee = phase_eval_at(config.phase_kinds, phase_params, weights_at, params_at, cos_nee)
        L_col = beta_w * albedo_col * p_nee * T_sun * E_sun
        d_col = phase_sample_at(
            config.phase_kinds, phase_params, weights_at, params_at, d, u_ph_sel, u_ph_cos,
            u_ph_phi,
        )
        beta_col = beta_w * albedo_col

        # ---- surface interaction ---------------------------------------
        r_new = sqrt_rn(dot3(p_new, p_new))
        n_srf = p_new / torch.clamp(r_new, min=1e-12)[:, None]
        mu_sun_srf = dot3(n_srf, w_sun)
        wo_local = to_local(n_srf, -d)
        wi_sun_local = to_local(n_srf, w_sun.expand_as(p_new))
        f_nee = bsdf_eval(config.surface_kind, surface_row.params, wi_sun_local, wo_local)
        L_srf = beta_b * f_nee * torch.clamp(mu_sun_srf, min=0.0) * T_sun * E_sun
        d_srf_local, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_local, u_srf
        )
        d_srf = to_world(n_srf, d_srf_local)
        beta_srf = beta_b * w_srf
        p_srf = p_new + n_srf * EPS_T  # lifted off the surface

        # ---- combine ----------------------------------------------------
        contribution = torch.where(accept, L_col, torch.where(hit_surface, L_srf, 0.0))
        p2 = torch.where(hit_surface[:, None], p_srf, p_new)
        d2 = torch.where(
            accept[:, None], d_col, torch.where(hit_surface[:, None], d_srf, d)
        )
        beta2 = torch.where(accept, beta_col, torch.where(hit_surface, beta_srf, beta))
        interacted = accept | hit_surface
        alive2 = interacted & (beta2 > 0.0)
        depth2 = depth + (interacted & alive2)

        # ---- Russian roulette on real interactions past rr_depth --------
        do_rr = interacted & (depth2 >= config.rr_depth)
        q = torch.clamp(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = torch.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & (survive | ~do_rr) & (depth2 < config.max_depth)
        return contribution, p2, d2, beta2, depth2, alive2

    return event


def trace_paths_spherical_regen(
    config, medium_row, surface_row, illum_row, init_p, init_d, row_key,
    lane_first, quota, max_iterations=MAX_ITERATIONS, check_every=CHECK_EVERY,
):
    """Regenerative shell trace: lane ``l`` renders samples ``lane_first[l] ..
    lane_first[l] + quota[l] - 1`` of its pixel, each path starting at
    ``init_p`` [B, 3] along ``init_d`` [B, 3].

    Returns ``(L_sum, m2_sum, iterations)``: per-lane sums of sample
    contributions and of their squares, and the event iterations run.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_p.shape[0]
    dev = init_p.device
    event = _make_event(config, medium_row, surface_row, illum_row)

    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    evt = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    p, d = init_p, init_d
    beta = torch.ones(B, device=dev)
    L_cur = torch.zeros(B, device=dev)
    L_sum = torch.zeros(B, device=dev)
    m2_sum = torch.zeros(B, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    iterations = 0
    while True:
        contribution, p2, d2, beta2, depth2, alive2 = event(evt, p, d, beta, depth, keys)
        active = ~done
        L_cur = L_cur + torch.where(active, contribution, 0.0)
        evt = evt + 1
        path_end = active & (~alive2 | (evt >= max_iterations))

        L_sum = L_sum + torch.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota)

        # regenerate: fresh path for the lane's next sample
        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        p = torch.where(regen[:, None], init_p, p2)
        d = torch.where(regen[:, None], init_d, d2)
        beta = torch.where(regen, 1.0, beta2)
        depth = torch.where(regen, 0, depth2)
        evt = torch.where(regen, 0, evt)
        L_cur = torch.where(path_end, 0.0, L_cur)

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            return L_sum, m2_sum, iterations


def toa_rays(w_v, target, r_top):
    """Path starts for viewing directions ``w_v`` [B, 3] (toward the
    sensor): the point at radius ``r_top`` on the viewing ray through
    ``target``, and the direction ``-w_v`` into the atmosphere. The distance
    is rounded as the jitted reference rounds it here (``fused``), so that
    the ground hit below lands on the reference's side of the ground."""
    _, t_far, _ = ray_sphere_intersect(target.expand(w_v.shape), w_v, r_top, fused=True)
    return target + w_v * t_far[:, None], -w_v


def _render_row_spherical(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, target,
    key, lanes_target, check_every, sample_offset=0, spp_stride=None,
):
    """One spectral row, its sample ids placed as
    :func:`.tracer.lane_partition`'s; returns (radiance [N], m2 [N],
    iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, directions.device, spp_stride, sample_offset
    )
    init_p, init_d = toa_rays(directions[pix], target, medium_row.radii[-1])
    L_sum, m2_sum, iterations = trace_paths_spherical_regen(
        config, medium_row, surface_row, illum_row, init_p, init_d, key,
        lane_first, quota, check_every=check_every,
    )
    radiance = L_sum.reshape(n_pix, lp).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return radiance, m2, iterations


def spherical_row(scene, s):
    """Spectral row ``s`` of a compiled spherical-shell scene on the device:
    ``(medium_row, surface_row, illum_row)``."""
    med, il = scene.medium, scene.illumination
    medium_row = SphericalMediumArrays(
        radii=med.radii,
        sigma_t=med.sigma_t[s],
        sigma_majorant=med.sigma_majorant[s],
        albedo=med.albedo[s],
        phase_weights=med.phase_weights[s],
        phase_params=tuple({k: v[s] for k, v in p.items()} for p in med.phase_params),
        sun_tau=None if med.sun_tau is None else med.sun_tau[s],
        mu_grid=med.mu_grid,
        sun_r_grid=med.sun_r_grid,
        sun_mu_warp=med.sun_mu_warp,
    )
    surface_row = SurfaceArrays(params={k: _row(v, s) for k, v in scene.surface.params.items()})
    illum_row = IlluminationArrays(
        direction=il.direction,
        irradiance=il.irradiance[s],
        cos_cutoff=_row(il.cos_cutoff, s),
        sky_radiance=_row(il.sky_radiance, s),
    )
    return medium_row, surface_row, illum_row


def check_supported(config, medium, polarized=False):
    """Raise ``NotImplementedError`` naming each feature the spherical
    tracer (``polarized``: its polarized twin) lacks, and a config of the
    other kind of transport, naming the renderer it belongs to;
    ``ValueError`` for an unknown surface kind. The surfaces take no
    position here (``p=None``), as in the reference."""
    if config.polarized and not polarized:
        raise NotImplementedError(
            "polarized transport in spherical shells is rendered by "
            "ops.tracer_spherical_polarized.render_spherical_polarized"
        )
    if polarized and not config.polarized:
        raise ValueError("config.polarized is False: render it with render_spherical")
    unsupported = {
        f"geometry {config.geometry!r}": config.geometry != "spherical_shell",
        "the legacy sun_tau_fetch (a sun-tau table without sun_r_grid)":
            medium.sun_tau is not None and medium.sun_r_grid is None,
    }
    for feature, missing in unsupported.items():
        if missing:
            raise NotImplementedError(f"{feature} is not ported yet")
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds, polarized=polarized)


def row_renderer(scene, sensor, config, *, device="cuda", lanes_target=None,
                 check_every=CHECK_EVERY):
    """:class:`.tracer.RowRenderer` of a spherical-shell scene (arguments as
    :func:`render_spherical`; by default each call's lanes are
    :func:`spherical_lanes_target`'s for its samples)."""
    check_supported(config, scene.medium)
    dev = resolve_device(device)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = spherical_row(scene, s)
        lanes = spherical_lanes_target(n_pix, n, dev.type) if lanes_target is None else lanes_target
        return _render_row_spherical(
            config, n_pix, n, medium_row, surface_row, illum_row, sensor.directions,
            sensor.target, key, lanes, check_every, sample_offset or 0, spp_stride,
        )

    return RowRenderer(scene.medium.sigma_t.shape[0], n_pix, scene.medium.sigma_t.dtype, dev,
                       False, render_row)


def render_spherical(
    scene, sensor, config, spp, seed=0, *, device="cuda", lanes_target=None,
    check_every=CHECK_EVERY,
):
    """Render the spectral batch of one distant-sensor bank through a
    spherical-shell atmosphere (reference ``render_spherical``).

    ``scene``/``sensor``/``config`` are a compiled scene, moved to ``device``
    first. ``lanes_target`` (default :func:`spherical_lanes_target`) sets the
    lane count and does not change the estimate beyond float summation
    order.

    Returns a dict with ``radiance`` [S, N], ``m2`` [S, N], ``spp`` and
    ``iterations`` (event iterations, summed over rows).
    """
    rr = row_renderer(scene, sensor, config, device=device, lanes_target=lanes_target,
                      check_every=check_every)
    rads, m2s, iterations = [], [], 0
    # key(seed) -> fold_in(row) -> fold_in(chunk 0), as render_spherical
    for s in range(rr.rows):
        rad, m2, it = rr.render(s, row_key(seed, s, 0, rr.device), spp)
        rads.append(rad)
        m2s.append(m2)
        iterations += it
    return {
        "radiance": torch.stack(rads),
        "m2": torch.stack(m2s),
        "spp": spp,
        "iterations": iterations,
    }
