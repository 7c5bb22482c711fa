"""Regenerative wavefront path tracer with polarized (Stokes/Mueller)
transport, spherical-shell geometry.

Port of ``eradiate_tpu/ops/tracer_spherical_polarized.py``
(``render_spherical_polarized``): the exact shell flight of
:mod:`.tracer_spherical` with the Mueller calculus of
:mod:`.tracer_polarized`. Each event takes the scalar tracer's flight and
sun slant depth (:func:`.tracer_spherical.sun_flight`: K2 then K4 under
``config.lr_flight``, K2 and the sun-tau table where the scene carries it,
else K3), then the polarized next-event estimate, scattering and surface
blocks of the reference. Null collisions leave the accumulated Mueller
product untouched; accepted collisions apply frame-rotated phase matrices
(``phase_mueller_at`` on the layer's fetched row, a ``tab_polarized``
aerosol on its spectral row's tables); surfaces use the Mueller-general
dispatch (scalar kinds are depolarizers). Every 4x4 product is a
fixed-order four-term sum (:mod:`.mueller`), every root correctly rounded
(:func:`.spherical.sqrt_rn`).

The per-event uniform slots are those of the scalar spherical tracer, so a
scalar and a polarized run with one seed trace the same paths. Unlike the
scalar ``render_spherical``, the reference splits the samples into chunks
by itself where ``S * n_pix * spp`` exceeds
:data:`.tracer.MAX_PATHS_PER_DISPATCH`, each chunk with its own key
``fold_in(fold_in(key(seed), row), chunk)``; so does the port, on every
device, so that a full-width render follows the reference's stream. Output
Stokes vectors are referenced to the meridian basis of each viewing
direction.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .bsdf_ops import bsdf_sample_from_uniforms
from .bsdf_polarized import surface_mueller
from .fastrng import bounce_uniforms, derive_keys
from .medium import fetch_at_index
from .mueller import default_basis
from .phase_ops import layer_param_slots, rebuild_fetched
from .scene_state import from_reference
from .spherical import dot3, sqrt_rn
from .tracer import (
    CHECK_EVERY,
    MAX_PATHS_PER_DISPATCH,
    RowRenderer,
    chunk_plan,
    lane_partition,
    row_key,
)
from .tracer_polarized import (
    basis_rotator,
    phase_vertex,
    roulette,
    surface_vertex,
    unpolarized,
)
from .tracer_spherical import (
    EPS_T,
    MAX_ITERATIONS,
    check_supported,
    spherical_lanes_target,
    spherical_row,
    sun_flight,
    toa_rays,
    to_local,
    to_world,
)

__all__ = [
    "render_spherical_polarized",
    "row_renderer",
    "trace_paths_spherical_polarized_regen",
]


def _make_event_polarized(config, medium_row, surface_row, illum_row):
    """Per-event Mueller transition shared by every lane: returns
    ``event(evt, p, d, P, b, beta, depth, keys)`` -> ``(S_add, p', d', P',
    b', beta', depth', alive')``; updates are unconditional (the caller masks
    finished lanes)."""
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

    def event(evt, p, d, P, b, beta, depth, keys):
        B = p.shape[0]
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
        l_out = -d  # light leaves the vertex toward the sensor path
        d_sun_b = d_sun.expand(B, 3)
        # one sun transmittance serves the volume and the surface branch
        T_sun = torch.exp(-torch.clamp(tau_sun, max=80.0))
        # the sun's light arrives along d_sun at either vertex kind: one
        # rotation into its scattering plane serves both estimates
        _, R_sun = basis_rotator(d_sun_b, l_out, b)

        # ---- accepted collisions ----------------------------------------
        S_sun = unpolarized(E_sun * T_sun * albedo_col * beta_w)
        S_col, d_new, P_col, h_in_s = phase_vertex(
            config.phase_kinds, phase_params, weights_at, params_at, P, b, d, d_sun_b, R_sun,
            S_sun, u_ph_sel, u_ph_cos, u_ph_phi,
        )
        beta_col = beta_w * albedo_col

        # ---- surface interaction, in the local frame of the normal ------
        r_new = sqrt_rn(dot3(p_new, p_new))
        n_srf = p_new / torch.clamp(r_new, min=1e-12)[:, None]
        wo_local = to_local(n_srf, l_out)
        wi_sun_local = to_local(n_srf, w_sun.expand_as(p_new))
        M_srf = surface_mueller(config.surface_kind, surface_row.params, wi_sun_local, wo_local)
        mu_sun_srf = torch.clamp(dot3(n_srf, w_sun), min=0.0)
        S_sun_srf = unpolarized(beta_b * mu_sun_srf * T_sun * E_sun)
        d_srf_local, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_local, u_srf
        )
        d_srf = to_world(n_srf, d_srf_local)
        M_cont = surface_mueller(config.surface_kind, surface_row.params, d_srf_local, wo_local)
        S_srf, P_srf, h_in_c = surface_vertex(
            P, b, l_out, R_sun, M_srf, S_sun_srf, d_srf, M_cont
        )
        beta_srf = beta_b * w_srf
        p_srf = p_new + n_srf * EPS_T  # lifted off the surface

        # ---- combine ----------------------------------------------------
        acc, hit = accept[:, None], hit_surface[:, None]
        S_add = torch.where(acc, S_col, torch.where(hit, S_srf, 0.0))
        p2 = torch.where(hit, p_srf, p_new)
        d2 = torch.where(acc, d_new, torch.where(hit, d_srf, d))
        P2 = torch.where(acc[..., None], P_col, torch.where(hit[..., None], P_srf, P))
        b2 = torch.where(acc, h_in_s, torch.where(hit, h_in_c, b))
        beta2 = torch.where(accept, beta_col, torch.where(hit_surface, beta_srf, beta))
        interacted = accept | hit_surface
        alive2 = interacted & (beta2 > 0.0)
        depth2 = depth + (interacted & alive2)

        # Russian roulette on real interactions past rr_depth
        beta2, alive2 = roulette(beta2, alive2, interacted & (depth2 >= config.rr_depth), u_rr)
        alive2 = alive2 & (depth2 < config.max_depth)
        return S_add, p2, d2, P2, b2, beta2, depth2, alive2

    return event


def trace_paths_spherical_polarized_regen(
    config, medium_row, surface_row, illum_row, init_p, init_d, row_key, lane_first,
    quota, max_iterations=MAX_ITERATIONS, check_every=CHECK_EVERY,
):
    """Regenerative Mueller shell trace (see
    :func:`.tracer_spherical.trace_paths_spherical_regen`): lane ``l``
    renders samples ``lane_first[l] .. lane_first[l] + quota[l] - 1`` of its
    pixel, each from ``init_p`` [B, 3] along ``init_d`` [B, 3] with a fresh
    ``P = I`` and the meridian basis of its viewing direction. Returns
    ``(S_sum [B, 4], m2_sum [B], iterations)``: per-lane sums of the
    samples' Stokes vectors and of their I squared, and the event iterations
    run."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_p.shape[0]
    dev, dtype = init_p.device, init_p.dtype
    event = _make_event_polarized(config, medium_row, surface_row, illum_row)
    b_init = default_basis(-init_d)
    eye4 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)

    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    evt = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    p, d, P, b = init_p, init_d, eye4, b_init
    beta = torch.ones(B, dtype=dtype, device=dev)
    S_cur = torch.zeros((B, 4), dtype=dtype, device=dev)
    S_sum = torch.zeros((B, 4), dtype=dtype, device=dev)
    m2_sum = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    iterations = 0
    while True:
        S_add, p2, d2, P2, b2, beta2, depth2, alive2 = event(evt, p, d, P, b, beta, depth, keys)
        active = ~done
        S_cur = S_cur + torch.where(active[:, None], S_add, 0.0)
        evt = evt + 1
        path_end = active & (~alive2 | (evt >= max_iterations))

        S_sum = S_sum + torch.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, S_cur[:, 0] * S_cur[:, 0], 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota)

        # regenerate: a fresh path, P and basis for the lane's next sample
        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        p = torch.where(regen[:, None], init_p, p2)
        d = torch.where(regen[:, None], init_d, d2)
        P = torch.where(regen[:, None, None], eye4, P2)
        b = torch.where(regen[:, None], b_init, b2)
        beta = torch.where(regen, 1.0, beta2)
        depth = torch.where(regen, 0, depth2)
        evt = torch.where(regen, 0, evt)
        S_cur = torch.where(path_end[:, None], 0.0, S_cur)

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            return S_sum, m2_sum, iterations


def _render_row(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, target, key,
    lanes_target, check_every, sample_offset=0, spp_stride=None,
):
    """One spectral row of one chunk, its sample ids placed as
    :func:`.tracer.lane_partition`'s; returns (stokes [N, 4], m2 [N],
    iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, directions.device, spp_stride, sample_offset
    )
    init_p, init_d = toa_rays(directions[pix], target, medium_row.radii[-1])
    S_sum, m2_sum, iterations = trace_paths_spherical_polarized_regen(
        config, medium_row, surface_row, illum_row, init_p, init_d, key, lane_first, quota,
        check_every=check_every,
    )
    stokes = S_sum.reshape(n_pix, lp, 4).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return stokes, m2, iterations


def row_renderer(scene, sensor, config, *, device="cuda", lanes_target=None,
                 check_every=CHECK_EVERY):
    """:class:`.tracer.RowRenderer` of a polarized spherical-shell scene
    (arguments as :func:`render_spherical_polarized`; by default each call's
    lanes are :func:`.tracer_spherical.spherical_lanes_target`'s for its
    samples)."""
    check_supported(config, scene.medium, polarized=True)
    dev = resolve_device(device)
    scene, sensor, config = from_reference(scene, sensor, config, dev)
    n_pix = sensor.directions.shape[0]

    def render_row(s, key, n, sample_offset=None, spp_stride=None):
        medium_row, surface_row, illum_row = spherical_row(scene, s)
        lanes = spherical_lanes_target(n_pix, n, dev.type) if lanes_target is None else lanes_target
        return _render_row(
            config, n_pix, n, medium_row, surface_row, illum_row, sensor.directions,
            sensor.target, key, lanes, check_every, sample_offset or 0, spp_stride,
        )

    return RowRenderer(scene.medium.sigma_t.shape[0], n_pix, scene.medium.sigma_t.dtype, dev,
                       True, render_row)


def render_spherical_polarized(
    scene, sensor, config, spp, seed=0, spp_chunk=None, *, device="cuda", lanes_target=None,
    check_every=CHECK_EVERY,
):
    """Polarized render of the spectral batch of one distant-sensor bank
    through a spherical-shell atmosphere (reference
    ``render_spherical_polarized``).

    ``scene``/``sensor``/``config`` are a compiled scene with
    ``config.polarized``, moved to ``device`` first; ``spp_chunk`` (default:
    what :data:`.tracer.MAX_PATHS_PER_DISPATCH` allows,
    :func:`.tracer.chunk_plan`) splits the samples as the reference does,
    each chunk with its own key; ``lanes_target`` (default
    :func:`.tracer_spherical.spherical_lanes_target` of each chunk) changes
    only the float summation order. Returns a dict with ``stokes`` [S, N, 4]
    (meridian-aligned), ``radiance`` [S, N] (= I), ``m2`` [S, N] (second
    moment of I), ``spp`` and ``iterations`` (event iterations, summed over
    chunks and rows; one flight kernel launch each).
    """
    rr = row_renderer(scene, sensor, config, device=device, lanes_target=lanes_target,
                      check_every=check_every)
    S, n_pix, dev = rr.rows, rr.n_pix, rr.device
    chunks = chunk_plan(spp, spp_chunk, S, n_pix, MAX_PATHS_PER_DISPATCH)

    st_sum = torch.zeros((S, n_pix, 4), dtype=rr.dtype, device=dev)  # the mode's accumulators
    m2_sum = torch.zeros((S, n_pix), dtype=rr.dtype, device=dev)
    iterations = 0
    for chunk_id, n in enumerate(chunks):
        for s in range(S):
            st, m2, it = rr.render(s, row_key(seed, s, chunk_id, dev), n)
            st_sum[s] += st * n
            m2_sum[s] += m2 * n
            iterations += it
    traced = sum(chunks)
    stokes = st_sum / traced
    return {
        "stokes": stokes,
        "radiance": stokes[..., 0],
        "m2": m2_sum / traced,
        "spp": traced,
        "iterations": iterations,
    }
