"""Regenerative wavefront path tracer with polarized transport for canopy
scenes (leaf-disk clouds, triangle meshes, a ground and an optional 1D
atmosphere), plane-parallel geometry.

Port of ``eradiate_tpu/ops/tracer_canopy_polarized.py``
(``render_canopy_polarized``, BASELINE config 5 as benchmarked). The event
structure is the scalar canopy tracer's (:mod:`.tracer_canopy`: medium
collision, leaf-disk or triangle hit, ground, escape; one shared shadow
sweep a bounce), and the Mueller bookkeeping the plane-parallel polarized
tracer's (:mod:`.tracer_polarized`: the backward left product P of rotated
Mueller matrices, importance sampling by the scalar pdf).

Leaves and triangles are bilambertian, an ideal depolarizer: their NEE adds
``P (f cos E, 0, 0, 0)`` (an unpolarized Stokes vector needs no rotation)
and a continuation collapses P onto its first column. The ground goes
through :func:`.bsdf_polarized.surface_mueller`, so polarized floors
(``maignan``, ``ocean_mishchenko``) keep their matrices; the atmosphere's
Rayleigh phase matrices are the main source of polarization.

The per-bounce uniform slots are the scalar canopy tracer's, so a scalar
and a polarized run with one seed trace the same paths, and the geometry
calls are the same: the leaf sweeps (K5/K6 flat, K7 instanced) and, with
triangles, the triangle sweeps (K8 flat, K9 instanced) launch once each a
bounce iteration on the card. The Morton lane sort permutes P and the
basis with the rest of a lane's state; regeneration resets them; Russian
roulette reweights beta once, not P. The emitter is the sun or a spot (the
scalar tracer's NEE terms, :func:`.tracer_canopy._canopy_helpers`), whose
light reaches each vertex along its own direction.

In ``mono_polarized_double`` (``bench.py``'s ``mono_polarized``) the path
state, the Mueller chain, the leaves, the triangles and the sums are
float64, as in the reference under x64, and the leaf and triangle sweeps
run their float64 builds on the card.
"""

from __future__ import annotations

import torch

from .bsdf_ops import (
    bilambertian_eval,
    bilambertian_sample_from_uniforms,
    bsdf_sample_from_uniforms,
    check_kind,
)
from .bsdf_polarized import surface_mueller
from .canopy import leaf_nearest
from .fastmath import depth_sample
from .fastrng import bounce_uniforms, derive_keys, origin_uniforms
from .medium import clamp_mu, take_1d, z_at_tau
from .mesh import tri_nearest
from .mueller import default_basis, depolarizer, matmul4, matvec4
from .phase_ops import check_phase_kinds, layer_param_slots, rebuild_fetched
from .tracer import CHECK_EVERY, lane_partition
from .tracer_canopy import (
    CANOPY_SORT_EVERY,
    _canopy_helpers,
    _morton_u32,
    _step,
    _to_local,
    _to_world,
    canopy_row_renderer,
    canopy_sums,
    lane_rays,
)
from .tracer_polarized import (
    basis_rotator,
    phase_vertex,
    roulette,
    surface_vertex,
    unpolarized,
)

__all__ = ["render_canopy_polarized", "trace_paths_canopy_polarized_regen", "row_renderer"]


def _make_bounce_canopy_polarized(
    config, medium_row, surface_row, leaf_row, leaves, helpers, B, tris=None,
    tri_row=None, eps=1e-6,
):
    """Per-bounce Mueller transition shared by every lane: returns
    ``bounce(depth, pos, d, P, b, beta, keys) -> (S_add, pos', d', P', b',
    beta', alive')``; updates are unconditional (the caller masks finished
    lanes). The geometry and the scalar weights are computed as in
    :func:`.tracer_canopy._make_bounce_canopy`."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]
    tau_z, nee_dir, nee_at = helpers["tau_z"], helpers["nee_dir"], helpers["nee_at"]
    accel, tris_accel = helpers["accel"], helpers["tris_accel"]

    dev, dtype = z_levels.device, z_levels.dtype
    ground_lift = torch.tensor([0.0, 0.0, eps], dtype=dtype, device=dev)
    depolarize = depolarizer(torch.ones((B,), dtype=dtype, device=dev))

    C = len(config.phase_kinds)
    phase_params = medium_row.phase_params
    param_tables, param_slots = layer_param_slots(config.phase_kinds, phase_params)
    fetch_tables = torch.stack(
        [medium_row.phase_weights[c] for c in range(C)] + param_tables
    )

    def bounce(depth_b, pos, d, P, b, beta, keys):
        U = bounce_uniforms(keys, depth_b, 8, config.rng)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2].contiguous()
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = torch.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        tau_s = depth_sample(u_dist, exact=dtype == torch.float64)
        collide_med = tau_s < tau_exit

        tau_new = torch.minimum(torch.clamp(tau_here + mu * tau_s, min=0.0), tau_top)
        z_med, layer = z_at_tau(tau_new, z_levels, tau_levels)
        z_edge = torch.where(mu > 0.0, z_top, z_bottom)
        t_med = torch.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)

        # nearest scatterer (leaf disk or mesh triangle) within the segment
        t_leaf, n_leaf, hit_leaf = leaf_nearest(pos, d, t_med, leaves, accel)
        optics = leaf_row
        if tris is not None:
            t_tri, n_tri, hit_tri = tri_nearest(pos, d, t_med, tris, tris_accel)
            tri_first = hit_tri & (~hit_leaf | (t_tri < t_leaf))
            hit_leaf = hit_leaf | hit_tri
            t_leaf = torch.where(tri_first, t_tri, t_leaf)
            n_leaf = torch.where(tri_first[:, None], n_tri, n_leaf)
            optics = {k: torch.where(tri_first, tri_row[k], leaf_row[k])
                      for k in ("reflectance", "transmittance")}

        event_leaf = hit_leaf
        event_med = collide_med & ~hit_leaf
        event_ground = (~collide_med) & ~hit_leaf & (mu < 0.0) & config.has_surface

        # ---- positions (rounded as the scalar canopy tracer's) -----------
        if tris is None:
            pos_leaf = _step(pos, d, t_leaf[:, None])
        else:
            pos_leaf = pos + d * t_leaf[:, None]
        pos_med = _step(pos, d, t_med[:, None])
        t_ground = (z_bottom - z) / mu
        pos_ground = _step(pos, d, t_ground[:, None])
        pos_ground = torch.cat([pos_ground[:, :2], z_bottom.expand(B, 1)], dim=1)

        # ---- shared NEE: one shadow sweep a bounce ------------------------
        to_front = -torch.sign((d * n_leaf).sum(-1))
        n_shade = n_leaf * to_front[:, None]
        wi_leaf_sign = torch.sign((n_shade * nee_dir(pos_leaf)).sum(-1))[:, None]
        eps_lane = (eps + t_leaf * 2.4e-7)[:, None]
        pos_leaf_off = _step(pos_leaf, n_shade * wi_leaf_sign, eps_lane)
        pos_ground_off = pos_ground + ground_lift
        pos_nee = torch.where(
            event_leaf[:, None],
            pos_leaf_off,
            torch.where(event_med[:, None], pos_med, pos_ground_off),
        )
        w_nee, E_nee = nee_at(pos_nee)

        l_out = -d  # light leaves every vertex toward the sensor path
        # the emitter's light arrives along l_sun = -w_nee at either Mueller
        # vertex: one rotation into its scattering plane serves both estimates
        l_sun = -w_nee
        _, R_sun = basis_rotator(l_sun, l_out, b)

        # ---- medium collision (Mueller phase) -----------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        fetched = fetch_tables[:, layer]
        weights_at = fetched[:C].T
        params_at = rebuild_fetched(config.phase_kinds, param_slots, fetched[C:])
        S_in_med = unpolarized(E_nee * albedo_col * beta)
        S_med, d_med, P_med, h_in_s = phase_vertex(
            config.phase_kinds, phase_params, weights_at, params_at, P, b, d, l_sun, R_sun,
            S_in_med, u_sel, u_cos, u_phi,
        )
        beta_med = beta * albedo_col

        # ---- leaf or triangle interaction (bilambertian: depolarizing) ----
        wo_leaf = _to_local(n_shade, -d)
        wi_sun_leaf = _to_local(n_shade, w_nee)
        f_leaf = bilambertian_eval(optics, wi_sun_leaf, wo_leaf)
        cos_sun_leaf = torch.abs((n_shade * w_nee).sum(-1))
        S_leaf = matvec4(P, unpolarized(beta * f_leaf * cos_sun_leaf * E_nee))
        d_leaf_local, w_leaf = bilambertian_sample_from_uniforms(
            optics, wo_leaf, u_sel, u_cos
        )
        d_leaf = _to_world(n_shade, d_leaf_local)
        # the chain stays normalized (unit I throughput): the sampling weight
        # lives in beta, as for the phase and surface continuations
        P_leaf = matmul4(P, depolarize)
        b_leaf = default_basis(-d_leaf)
        beta_leaf = beta * w_leaf
        pos_leaf_new = _step(pos_leaf, d_leaf, eps_lane)

        # ---- ground (Mueller-general surface) -----------------------------
        xy_ground = pos_ground[:, :2]
        M_nee_srf = surface_mueller(
            config.surface_kind, surface_row.params, w_nee, l_out, xy_ground
        )
        mu_nee_g = torch.clamp(w_nee[:, 2], min=0.0)
        S_in_g = unpolarized(beta * mu_nee_g * E_nee)
        d_ground, w_g = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, l_out, u_srf, xy_ground
        )
        M_cont = surface_mueller(
            config.surface_kind, surface_row.params, d_ground, l_out, xy_ground
        )
        S_ground, P_ground, h_in_c = surface_vertex(
            P, b, l_out, R_sun, M_nee_srf, S_in_g, d_ground, M_cont
        )
        beta_ground = beta * w_g

        # ---- combine ------------------------------------------------------
        def pick(leaf, med, ground, other):
            shape = (-1,) + (1,) * (leaf.ndim - 1)
            return torch.where(
                event_leaf.view(shape), leaf,
                torch.where(event_med.view(shape), med,
                            torch.where(event_ground.view(shape), ground, other)),
            )

        S_add = pick(S_leaf, S_med, S_ground, 0.0)
        pos2 = pick(pos_leaf_new, pos_med, pos_ground, pos_ground)
        d2 = pick(d_leaf, d_med, d_ground, d_ground)
        P2 = pick(P_leaf, P_med, P_ground, P)
        b2 = pick(b_leaf, h_in_s, h_in_c, h_in_c)
        beta2 = pick(beta_leaf, beta_med, beta_ground, 0.0)
        alive2 = (event_leaf | event_med | event_ground) & (beta2 > 0.0)

        beta2, alive2 = roulette(beta2, alive2, depth_b >= config.rr_depth, u_rr)
        return S_add, pos2, d2, P2, b2, beta2, alive2

    return bounce


def trace_paths_canopy_polarized_regen(
    config, medium_row, surface_row, leaf_row, leaves, illum_row, init_pos, init_d,
    row_key, lane_first, quota, ext=None, sort_every=CANOPY_SORT_EVERY,
    check_every=CHECK_EVERY, tris=None, tri_row=None,
):
    """Regenerative polarized canopy trace (see
    :func:`.tracer_canopy.trace_paths_canopy_regen`, whose lane plan, origin
    jitter, parking and Morton sort it keeps; P and the basis travel with
    their lane). Returns ``(S_sum [B, 4], m2_sum [B], iterations)`` in the
    caller's lane order (m2 over the I component)."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    B = init_pos.shape[0]
    dev, dtype = init_pos.device, init_pos.dtype
    helpers = _canopy_helpers(config, medium_row, leaves, illum_row, B, tris)
    bounce = _make_bounce_canopy_polarized(
        config, medium_row, surface_row, leaf_row, leaves, helpers, B, tris, tri_row
    )
    z_top = medium_row.z_levels[-1]
    _, box_lo, box_hi = helpers["accel"]
    park = torch.stack([z_top.new_zeros(()), z_top.new_zeros(()), z_top]).expand(B, 3)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev).expand(B, 3)
    eye4 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)

    def origin(keys, init_pos_l, ext_l):
        if ext is None:
            return init_pos_l
        jit = (origin_uniforms(keys, 2, config.rng, dtype) - 0.5) * ext_l
        return init_pos_l + torch.cat([jit, jit.new_zeros(B, 1)], dim=-1)

    ext_l = torch.zeros((B, 2), dtype=dtype, device=dev) if ext is None else ext
    quota_l = torch.as_tensor(quota, device=dev).expand(B)
    lane_first_l, init_pos_l, init_d_l = lane_first, init_pos, init_d
    b_init_l = default_basis(-init_d)
    s_local = torch.zeros(B, dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    keys = derive_keys(row_key, lane_first, config.rng)
    pos, d, P, b = origin(keys, init_pos, ext_l), init_d, eye4, b_init_l
    beta = torch.ones(B, dtype=dtype, device=dev)
    S_cur = torch.zeros((B, 4), dtype=dtype, device=dev)
    S_sum = torch.zeros((B, 4), dtype=dtype, device=dev)
    m2_sum = torch.zeros(B, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    orig = torch.arange(B, device=dev)

    iterations = 0
    while True:
        S_add, pos2, d2, P2, b2, beta2, alive2 = bounce(depth, pos, d, P, b, beta, keys)
        active = ~done
        S_cur = S_cur + torch.where(active[:, None], S_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        S_sum = S_sum + torch.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + torch.where(path_end, S_cur[:, 0] * S_cur[:, 0], 0.0)
        s_local = s_local + path_end
        done = done | (s_local >= quota_l)

        regen = path_end & ~done
        keys_new = derive_keys(row_key, lane_first_l + s_local, config.rng)
        keys = torch.where(regen[:, None], keys_new, keys)
        pos = torch.where(regen[:, None], origin(keys_new, init_pos_l, ext_l), pos2)
        d = torch.where(regen[:, None], init_d_l, d2)
        P = torch.where(regen[:, None, None], eye4, P2)
        b = torch.where(regen[:, None], b_init_l, b2)
        beta = torch.where(regen, 1.0, beta2)
        S_cur = torch.where(path_end[:, None], 0.0, S_cur)
        depth = torch.where(regen, 0, depth)

        # park done lanes at TOA pointing up: valid geometry that misses the
        # canopy's box
        pos = torch.where(done[:, None], park, pos)
        d = torch.where(done[:, None], up, d)

        if sort_every > 0 and iterations % sort_every == sort_every - 1:
            code = _morton_u32(pos, box_lo, box_hi)
            code = torch.where(done, 0xFFFFFFFF, code)  # done lanes to the end
            order = torch.argsort(code, stable=True)
            (s_local, depth, pos, d, P, b, beta, S_cur, keys, done, S_sum, m2_sum,
             lane_first_l, quota_l, init_pos_l, init_d_l, b_init_l, ext_l, orig) = (
                x[order]
                for x in (s_local, depth, pos, d, P, b, beta, S_cur, keys, done, S_sum,
                          m2_sum, lane_first_l, quota_l, init_pos_l, init_d_l, b_init_l,
                          ext_l, orig)
            )

        iterations += 1
        if iterations % check_every == 0 and bool(done.all()):
            break

    # undo the in-loop permutations
    S_out = torch.zeros_like(S_sum)
    m2_out = torch.zeros_like(m2_sum)
    S_out[orig] = S_sum
    m2_out[orig] = m2_sum
    return S_out, m2_out, iterations


def _render_row_canopy_polarized(
    config, n_pix, spp, medium_row, surface_row, leaf_row, leaves, illum_row, sensor,
    key, lanes_target, sort_every, check_every, tris=None, tri_row=None, sample_offset=0,
    spp_stride=None,
):
    """One spectral row of one chunk, its sample ids placed as
    :func:`.tracer.lane_partition`'s: returns (stokes [N, 4], m2 [N],
    iterations)."""
    lp, pix, _, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target, sensor.directions.device, spp_stride, sample_offset
    )
    init_pos, init_d, ext = lane_rays(
        medium_row, sensor.directions, sensor.target, sensor.ray_offset,
        sensor.target_extent, pix,
    )
    S_sum, m2_sum, iterations = trace_paths_canopy_polarized_regen(
        config, medium_row, surface_row, leaf_row, leaves, illum_row, init_pos, init_d,
        key, lane_first, quota, ext=ext, sort_every=sort_every, check_every=check_every,
        tris=tris, tri_row=tri_row,
    )
    stokes = S_sum.reshape(n_pix, lp, 4).sum(dim=1) / spp
    m2 = m2_sum.reshape(n_pix, lp).sum(dim=1) / spp
    return stokes, m2, iterations


def _check_supported(config):
    """Raise ``NotImplementedError`` naming each feature this slice lacks;
    ``ValueError`` for an unpolarized config or an unknown surface kind.
    ``config.lr_flight`` changes nothing here, as in the reference."""
    if not config.polarized:
        raise ValueError(
            "config.polarized is False: render it with ops.tracer_canopy.render_canopy"
        )
    if config.geometry != "plane_parallel":
        raise NotImplementedError(
            f"geometry {config.geometry!r} for canopy scenes is not ported yet"
        )
    check_kind(config.surface_kind)
    check_phase_kinds(config.phase_kinds, polarized=True)


def row_renderer(scene, leaf_params, leaves, sensor, config, tris=None, tri_params=None, *,
                 device="cuda", lanes_target=None, sort_every=CANOPY_SORT_EVERY,
                 check_every=CHECK_EVERY):
    """:class:`.tracer.RowRenderer` of a polarized canopy scene (arguments
    as :func:`render_canopy_polarized`)."""
    _check_supported(config)
    return canopy_row_renderer(_render_row_canopy_polarized, True, scene, leaf_params, leaves,
                               sensor, config, tris, tri_params, device, lanes_target,
                               sort_every, check_every)


def render_canopy_polarized(
    scene, leaf_params, leaves, sensor, config, spp, seed=0, spp_chunk=None,
    tris=None, tri_params=None, *, device="cuda", lanes_target=None,
    sort_every=CANOPY_SORT_EVERY, check_every=CHECK_EVERY,
):
    """Polarized render of a canopy (+ optional atmosphere) scene; arguments
    as :func:`.tracer_canopy.render_canopy`, with ``config.polarized``.

    Returns a dict with ``stokes`` [S, N, 4] (meridian-aligned),
    ``radiance`` [S, N] (= I), ``m2`` [S, N] (second moment of I), ``spp`` and
    ``iterations`` (bounce iterations, summed over chunks and rows; each
    launches the nearest-hit and the any-hit sweep of the leaves once and,
    with ``tris``, those of the triangles).
    """
    rr = row_renderer(scene, leaf_params, leaves, sensor, config, tris, tri_params,
                      device=device, lanes_target=lanes_target, sort_every=sort_every,
                      check_every=check_every)
    st_sum, m2_sum, traced, iterations = canopy_sums(rr, spp, seed, spp_chunk)
    stokes = st_sum / traced
    return {
        "stokes": stokes,
        "radiance": stokes[..., 0],
        "m2": m2_sum / traced,
        "spp": traced,
        "iterations": iterations,
    }
